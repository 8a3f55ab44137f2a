"""The 17-frame full-toolset 1080p stream (bench.py FULL_KW as it stands,
17 frames) and its JAX MD5s.

The stream is 7.3 MB, too large to commit, so
ffmpeg_tpu_torch/testdata/full1080_17.json holds its config, its byte
count, its sha256 and the JAX package's frame MD5s; chip_smoke.py makes
the stream with the port's generator and holds its decode to them.
Regenerate the file with the JAX package's generator and decoder on the
CPU, in one subprocess that is rerun if a signal ends it (the JAX
decoder has segfaulted on the CPU after many decodes):

  python tests/torch_full1080_17.py

It takes about half an hour. This module imports neither torch nor JAX at its
top, so that the subprocess loads only the JAX package.
"""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FULL1080_17_JSON = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata",
                                "full1080_17.json")


def config() -> dict:
  from bench import FULL_KW

  return dict(FULL_KW, n_frames=17)


def _jax_md5s(data: bytes) -> list:
  """The JAX package's decode of `data`, one access unit at a time: the
  native parse (a fresh parser handle on the session's collocated-motion
  store), the DMVR refinement and its apply, the input build and the
  frame program, in decode order, then the frames in POC order (the
  stream is one IDR period with every frame output).

  These are the session's own stages (ffmpeg_tpu/models/vvc/decoder.py
  VVCDecoder.decode) without its parse-ahead threads: on this stream
  they wait for collocated motion that a DMVR frame publishes only after
  its refinement, and on the CPU, at about a minute a frame, those waits
  have run into the parser's 600 s limit and dropped access units under
  errors="contain" (four lanes) or stalled (one or two lanes)."""
  from ffmpeg_tpu.models.vvc.decoder import Frame, VVCDecoder
  from ffmpeg_tpu.models.vvc.host import HostDecoder, dmvr_apply
  from ffmpeg_tpu.models.vvc.pipeline import prepare_frame, submit_frame
  from ffmpeg_tpu.ops.dmvr import refine_frame_device

  session = VVCDecoder(host_threads=1)
  dpb = session._dpb
  frames = []
  for nal_type, epoch, au in session._split_aus(data):
    parser = HostDecoder(session._colstore)
    fs = parser.decode_au(au, epoch)
    if fs is None:
      continue
    if fs.cus is not None and "dmvr" in fs.cus and np.any(fs.cus["dmvr"]):
      dmvr_apply(fs, session._colstore, epoch, refine_frame_device(fs, dpb))
    prepared = prepare_frame(fs)
    if nal_type in (7, 8):
      dpb.clear()
    packed, planes = submit_frame(prepared, fs, dpb)
    dpb[fs.poc] = planes
    listed = set(fs.ref_pocs[0]) | set(fs.ref_pocs[1])
    if listed:
      for poc in [p for p in dpb if p != fs.poc and p not in listed]:
        del dpb[poc]
    cl, cr, ct, cb = getattr(fs, "crop", (0, 0, 0, 0))
    frames.append(Frame(poc=fs.poc, buf=packed, width=fs.width - cl - cr,
                        height=fs.height - ct - cb, bit_depth=fs.bit_depth))
    print("decoded poc", fs.poc, file=sys.stderr, flush=True)
    del parser
  return [f.md5() for f in sorted(frames, key=lambda f: f.poc)]


def _one() -> dict:
  """Generate and decode the stream with the JAX package, in this
  process."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream

  # the stages driven so equal the session on a committed DMVR+TMVP case
  with open(os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata",
                         "tools_cases.md5.json")) as f:
    case = json.load(f)["dmvr-bdof-tmvp"]
  if _jax_md5s(encode_stream(EncoderConfig(**case["config"]))[0]) \
      != case["md5"]:
    raise SystemExit("the JAX stages, driven one access unit at a time, "
                     "differ from the session on dmvr-bdof-tmvp")
  kw = config()
  data = encode_stream(EncoderConfig(**kw))[0]
  return {"config": kw, "bytes": len(data),
          "sha256": hashlib.sha256(data).hexdigest(), "md5": _jax_md5s(data)}


def main(tries: int = 3):
  for attempt in range(tries):
    proc = subprocess.run([sys.executable, __file__, "--one"],
                          stdout=subprocess.PIPE, text=True,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if proc.returncode == 0:
      out = json.loads(proc.stdout.strip().splitlines()[-1])
      with open(FULL1080_17_JSON, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
      print(f"{len(out['md5'])} frames, {out['bytes']} bytes", flush=True)
      return
    if proc.returncode > 0:
      raise SystemExit(f"regenerator failed with exit code {proc.returncode}")
    print(f"attempt {attempt + 1} ended by signal {-proc.returncode}",
          flush=True)
  raise SystemExit(f"regenerator ended by a signal {tries} times")


if __name__ == "__main__":
  if sys.argv[1:] == ["--one"]:
    print(json.dumps(_one()), flush=True)
  else:
    main()
