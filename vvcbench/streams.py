"""The pool's streams, each made once by the frozen generator
(`frozen/encoder`) and kept under `vvcbench/.cache/streams/`
(git-ignored), keyed by configuration and generator seed.  Streams the
cache lacks are generated side by side, one process each.  A file is
written whole under a temporary name and renamed, so that a run cut
short leaves no half file."""
from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

from .cells import ROOT

CACHE = os.path.join(ROOT, ".cache")


def generator_kwargs(config: dict, gen_seed: int) -> dict:
  """The configuration's generator arguments with `gen_seed` in place of
  theirs."""
  return dict(config["generator"], seed=int(gen_seed))


def _path(cache: str, config_name: str, gen_seed: int) -> str:
  return os.path.join(cache, "streams", f"{config_name}-{gen_seed}.vvc")


def _generate(path: str, kw: dict) -> None:
  from .frozen.encoder import config_from_json, encode_stream

  data = encode_stream(config_from_json(kw))[0]
  os.makedirs(os.path.dirname(path), exist_ok=True)
  tmp = f"{path}.tmp.{os.getpid()}"
  with open(tmp, "wb") as f:
    f.write(data)
  os.replace(tmp, path)


def pool_streams(config_name: str, config: dict, gen_seeds,
                 cache: str = CACHE):
  """([each seed's stream], seconds spent generating those the cache
  lacked)."""
  paths = [_path(cache, config_name, s) for s in gen_seeds]
  missing = [(p, generator_kwargs(config, s))
             for p, s in zip(paths, gen_seeds) if not os.path.exists(p)]
  t0 = time.perf_counter()
  if len(missing) == 1:
    _generate(*missing[0])
  elif missing:
    from .frozen.encoder import native_cabac

    native_cabac.get_lib()  # built once, before the workers load it
    with ProcessPoolExecutor(
        len(missing), mp_context=multiprocessing.get_context("spawn")) as ex:
      for f in [ex.submit(_generate, p, kw) for p, kw in missing]:
        f.result()
  seconds = time.perf_counter() - t0 if missing else 0.0
  out = []
  for p in paths:
    with open(p, "rb") as f:
      out.append(f.read())
  return out, seconds
