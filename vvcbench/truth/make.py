"""The committed truth of a configuration's streams: for each generator
seed of its pool, the stream's byte count and sha256 and the MD5 of
every output frame, as the JAX package (`ffmpeg_tpu`) generates and
decodes it on the CPU.

    python vvcbench/truth/make.py <config> <seed> [<seed> ...]

writes `vvcbench/truth/<config>/<seed>.json` for each seed.  Each seed
runs in its own subprocess, rerun if a signal ends it (the JAX decoder
has segfaulted on the CPU after many decodes).  A 1080p random-access
stream of 17 frames takes about an hour, a 720p all-intra stream of 16
about forty minutes, three at a time on 8 cores.

This is the one file under `vvcbench/` that loads the JAX package, and
the benchmark never imports or runs it: a run reads only the JSON it
wrote (`truth.py`).
"""
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)


def generator_kwargs(config: str, seed: int) -> dict:
  with open(os.path.join(BENCH, "configs", config + ".json")) as f:
    return dict(json.load(f)["generator"], seed=int(seed))


MAX_MAPS = 30000


def _maps() -> int:
  """The number of this process's memory maps."""
  with open("/proc/self/maps") as f:
    return sum(1 for _ in f)


def jax_md5s(data: bytes) -> list:
  """The JAX package's decode of `data`, one access unit at a time: the
  native parse (a fresh parser on the session's collocated-motion
  store), the DMVR refinement and its apply, the input build and the
  frame program, in decode order; the frames' MD5s in output order
  (the generator's streams output every frame, in POC order within an
  IDR period).

  Each compiled program of XLA's CPU backend keeps memory maps of its
  own, and a 1080p random-access stream at CTU 128 compiles enough of
  them to reach the kernel's limit on a process's maps (vm.max_map_count,
  65530) before its last frames; so once a frame leaves the process
  above MAX_MAPS maps, the compiled programs are dropped
  (`jax.clear_caches`) and compiled again as they are needed.

  These are the stages of the JAX session (`VVCDecoder.decode`) without
  its parse-ahead threads, which on the CPU, at about a minute a 1080p
  frame, have run into the parser's 600 s wait for collocated motion."""
  import gc

  import jax
  import numpy as np
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
    frames.append(((epoch, fs.poc),
                   Frame(poc=fs.poc, buf=packed, width=fs.width - cl - cr,
                         height=fs.height - ct - cb,
                         bit_depth=fs.bit_depth)))
    del parser
    maps = _maps()
    if maps > MAX_MAPS:
      jax.clear_caches()
      gc.collect()
    print("decoded epoch", epoch, "poc", fs.poc, "maps", maps, _maps(),
          file=sys.stderr, flush=True)
  return [f.md5() for _, f in sorted(frames, key=lambda e: e[0])]


def one(kw: dict) -> dict:
  """Generate and decode the stream of `kw` with the JAX package, in
  this process."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream

  # the stages driven so equal the JAX session on a committed case with
  # DMVR and TMVP
  with open(os.path.join(REPO, "ffmpeg_tpu_torch", "testdata",
                         "tools_cases.md5.json")) as f:
    case = json.load(f)["dmvr-bdof-tmvp"]
  if jax_md5s(encode_stream(EncoderConfig(**case["config"]))[0]) \
      != case["md5"]:
    raise SystemExit("the JAX stages, driven one access unit at a time, "
                     "differ from the session on dmvr-bdof-tmvp")
  data = encode_stream(EncoderConfig(**kw))[0]
  return {"generator": kw, "bytes": len(data),
          "sha256": hashlib.sha256(data).hexdigest(), "md5": jax_md5s(data)}


def make(config: str, seed: int, tries: int = 3) -> str:
  kw = generator_kwargs(config, seed)
  for attempt in range(tries):
    proc = subprocess.run([sys.executable, __file__, "--one", json.dumps(kw)],
                          stdout=subprocess.PIPE, text=True,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if proc.returncode == 0:
      out = json.loads(proc.stdout.strip().splitlines()[-1])
      path = os.path.join(HERE, config, f"{seed}.json")
      os.makedirs(os.path.dirname(path), exist_ok=True)
      with open(path, "w") as f:
        json.dump(dict(out, config=config, seed=seed), f, indent=1)
        f.write("\n")
      return path
    if proc.returncode > 0:
      raise SystemExit(f"{config} seed {seed}: exit code {proc.returncode}")
    print(f"{config} seed {seed}: attempt {attempt + 1} ended by signal "
          f"{-proc.returncode}", flush=True)
  raise SystemExit(f"{config} seed {seed}: ended by a signal {tries} times")


if __name__ == "__main__":
  sys.path.insert(0, REPO)
  if sys.argv[1] == "--one":
    print(json.dumps(one(json.loads(sys.argv[2]))), flush=True)
  else:
    for s in sys.argv[2:]:
      print(make(sys.argv[1], int(s)), flush=True)
