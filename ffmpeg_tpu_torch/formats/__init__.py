"""Container layer: probing, demuxing, and stream plumbing.

The libavformat analog for the decode path: annex-B probe/demux
(reference libavformat/vvcdec.c), ISO-BMFF (MP4) with the `vvcC`
decoder-configuration record (libavformat/vvc.c, movenc.c), and the
mp4-to-annexb bitstream filter (libavcodec/bsf/vvc_mp4toannexb.c).
Host-only Python: the port keeps its own copy of the JAX package's
container layer, muxers included (annexb_to_mp4, write_mp4_vvc).
"""
from .probe import probe_format, open_input  # noqa: F401
