"""A frozen copy of the port's stream generator and of its plain decode
path, for the benchmark's traffic and its reference.

The files are those of `ffmpeg_tpu_torch` at the commit that added the
benchmark, with their relative imports, so that this package imports
nothing of the port: later changes to the port change neither the
streams a seed gives nor the frames they are judged against.  Left out:
the CUDA sources (`csrc/`), the tools, the container layer and the
parallel paths.  Changed: the docstrings and the logger name that named
the port, and the build directory, which is this package's `_build/`.

- The generator (`encoder/`, `cbs/h266.py`, `bitstream/`,
  `models/vvc/cabac_tables.py`, `native/encode.cc`) makes a stream from
  a configuration's keyword arguments (`encoder.config_from_json`).
- The reference (`vvcbench/reference.py`) drives `models/vvc/host.py`
  (the native CABAC parser, `native/decode.cc`), `inputs.py`,
  `convert.py` and `pipeline.py` with a call hook that runs each of the
  frame program's kernel calls through its plain PyTorch version in
  `ops/`; no hand-written kernel is built or launched, since their
  sources are not here.
"""
