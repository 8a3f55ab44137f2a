"""VVC test-stream generator, the port's copy of the JAX package's.

Generates conforming H.266 bitstreams with chosen (usually random) legal
syntax (splits, intra modes, coefficient levels, motion, every coding
tool the decoder reads) plus an "intent" sidecar recording every choice.
Its randomness is `np.random.default_rng(cfg.seed)`, drawn in the JAX
package's order, so one EncoderConfig gives the same bytes and intent in
both packages.  It needs neither torch nor a card: the CABAC engine is
native C++ (native/encode.cc, encoder/native_cabac.py).

    from vvcbench.frozen.encoder import EncoderConfig, encode_stream
    data, intent = encode_stream(EncoderConfig(width=96, height=64))

"""
from .encoder import EncoderConfig, config_from_json, encode_stream
