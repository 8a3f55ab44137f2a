#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (H100).

  python3 chip_smoke.py

Drives ffmpeg_tpu_torch's main paths through the user entry point
(VVCDecoder(device="cuda")) on the committed fixtures:
  - full1080, the main path: 5 frames of 1920x1080 8-bit random access
    with the full toolset (bench.py FULL_KW: B slices with TMVP,
    affine/PROF, BDOF, DMVR, CIIP, GPM, MMVD, BCW, AMVR, MIP, CCLM, LMCS
    with chroma residual scaling, deblock, SAO, ALF and CC-ALF) through
    the eight kernels (dmvr, the DMVR search of POC 2, 1 and 3; residual,
    whose chroma call derives the LMCS chroma scales in its scaled TUs;
    inter_pred, recon, lmcs_inv, deblock, sao, alf);
  - ra1080: the same without DMVR, LMCS, ALF and CC-ALF;
  - ai720: 4 frames of 1280x720 8-bit all intra, the intra path;
  - ai256x128_10b: 2 frames of 10-bit all intra;
  - ctu128_1080: 5 frames of 1920x1080 with CTU-128, 64-sample transform
    blocks, ISP, explicit scaling lists and LFNST (full1080's toolset
    without CIIP and GPM): the 64-edge luma units (the recon kernel's
    64-edge wavefront) and ISP's 1-high sub-partitions (readiness cell
    1);
  - ciip64: 3 frames of 128x128 with CTU 64 whose B frames hold 64x64
    CIIP units (their MC prediction in four 32x32 MC rows);
  - gop720: 9 frames of 1280x720 with full1080's toolset but DMVR, a
    GOP-4 pyramid whose dependency waves hold up to 3 frames: the wave
    path (parallel/gop.py), with ra1080.
Phases, one JSON line each:

  1. device   card name, count, nvidia-smi name + power limit
  2. build    host parser (make) and every CUDA kernel library (nvcc:
              residual, recon, inter_pred, deblock, alf, sao, lmcs, dmvr),
              in parallel, from the sources in this checkout; each kernel
              function's registers, shared memory and spills (ptxas; the
              dmvr, residual and lmcs kernels' on lines of their own);
              the sao and lmcs
              kernels' shared, constant and global loads from their SASS
              (tools/sass_loads.py), in all and in their outermost loop
  3. kernels  each kernel call of the frame program (recorded through
              its call hook, pipeline.walk_frames) against its plain
              torch version on the card, torch.equal, tolerance 0
              (all-integer arithmetic): every kernel (the residual
              kernel's two calls, luma, then Cb and Cr; the deblock
              kernel's two calls, both passes in one launch, and each
              call's passes alone in its one-pass mode; the alf kernel's
              two calls, luma, then Cb and Cr with CC-ALF; the sao
              kernel's two calls, luma, then Cb and Cr; the LMCS inverse
              map; the DMVR search) on the first B frame
              of full1080 that holds pure inter, CIIP, GPM, BDOF, PROF
              and DMVR units under LMCS with ALF-on CTBs (the inter calls
              carry DMVR windows and the luma forward map; its real,
              LMCS-mapped DPB references) and on such a frame of ra1080
              without the new tools, and recon and deblock on frame 0 of
              the intra fixtures (luma, then chroma with CCLM); the B
              frames' unit counts, small and large MC units, and the
              largest frame's MC tile bytes (models/vvc/mc_tiles.py);
              both kernels on ctu128_1080's I frame and first B frame and
              on ciip64's first frame with a 64x64 CIIP unit, with their
              64-edge, 1-high and CIIP-64 unit counts and readiness cell;
              every DMVR search call of the walked fixtures' frames
              (full1080's and ctu128_1080's POC 2, 1 and 3) against the
              plain version, with its subblocks; every chroma residual
              call with LMCS chroma scaling of full1080's and gop720's
              walks (the kernel deriving each scaled TU's scale from the
              mapped luma) against the plain pair, the scales
              (lmcs_vpdu_scales_plain) then the plain chroma residual
  4. decode   each fixture decoded on the card; frame MD5s must equal
              the committed ones (from the JAX package's decode); per
              fixture, counts zeroed just before its decode: every kernel
              of the path launched, the plain versions never ran, the
              deblock kernel launched twice a frame (luma; Cb and Cr),
              the residual wrapper called twice a frame, each call
              launching one to three work groups (counted apart),
              the alf kernel twice on each frame with ALF on (the traced
              alf spans count those frames), the sao kernel twice on
              each frame with SAO on, its Cb and Cr launch overlapping its
              luma launch (sao_overlapped, one per such frame),
              lmcs_inv once on each frame with
              LMCS on, the dmvr kernel once on each DMVR frame (the sao,
              lmcs and dmvr spans; 3 on full1080 and on ctu128_1080), no
              LMCS chroma scales launch (the counts' lmcs_scales, 0)
  4b. generate  the port's stream generator on the card's host (3 worker
              processes started before the build, overlapping it): each
              of the 7 fixtures regenerated from its committed config
              equals its .vvc (a mismatch names the config and the first
              differing byte); 160 committed JAX-MD5 cases (every case of
              GEN_CASE_FILES, and ROBUST_PLAIN's whole-stream decodes;
              GEN_LEFT_OUT names the rest and why) generated and decoded
              on the card, a fresh session each, to their MD5s, as one
              path ("generated": counts zeroed before the first decode,
              read after the last; every kernel launched, no plain
              version); full1080_17, bench.py FULL_KW at its 17 frames
              (too large to commit), equal to full1080_17.json's size
              and sha256, decoded with fetch=False (its own path) and
              then with the fetch to its JAX MD5s, fps of each
  5. timing   full1080, ai720 and ctu128_1080 fps with frames left on
              the card and
              with the fetch, full1080 fps at host_threads 1, 4 and 8,
              twice each in the order 1, 4, 8, 8, 4, 1 (the session's
              parse pool; os.cpu_count() beside it),
              full1080 per-stage ms (the DMVR round trip
              per DMVR frame among them, and its halves: dmvr_search, the
              search with its fetch, and dmvr_apply, the host's apply),
              the device ms of the DMVR search per call and per frame
              (CUDA events around each call, queued behind a held card;
              the kernel, one launch a call), kernel vs
              plain ms (CUDA events, the launches queued behind a short
              sleep of the card so that the host's Python between them is
              not timed) on the full1080 B frame; the inter kernel's time
              split into its small
              and large launches, and its wrapper's host ms per call (with
              the card held, and synced); the recon kernel's time split
              into its placement and wavefront launches, its critical path
              (dependency levels) and us per level on that frame and on
              ai720's frame 0, and on ctu128_1080's I and B frames (its
              recon levels and us per level, its inter kernel); the
              deblock and alf kernels' ms per launch (luma, then Cb and
              Cr; the launch is the whole call; the dmvr kernel's on the
              POC 2 call with its bound and subblocks; for alf each call's
              launch: grid, resident blocks per SM, tiles and tiles per
              block, shared bytes and ptxas's registers, and the frame's
              pair, the Cb and Cr launch overlapping the luma launch,
              which is the alf row's ms in the kernel table) and the
              residual
              kernel's ms per call (its plane fill and each work group's
              launch apart, with each group's TUs, blocks, shared bytes
              and resident blocks per SM; the wrapper's host ms per
              call beside it), the sao and lmcs_inv
              kernels' ms per call, and the sao pair (the Cb and Cr
              launch overlapping the luma launch, which is the sao row's
              ms in the kernel table) with each call's launch (grid,
              resident blocks per SM, tiles), on the full1080 B frame and
              the coding-tool frames; every
              timed launch of the kernels held
              against the plain version (for recon, the race check); and
              the SM clocks before and after
  6. profile  torch.profiler over a full1080 decode: device busy share,
              device time by kernel and by stage (the trace spans as
              profiler ranges)
  7. parallel the wave path (decode_gop_mesh) on ra1080 and gop720 at 1,
              2 and 4 CUDA streams: its dependency waves, the committed
              MD5s at each width, counts zeroed just before each run
              (both kernels launched, no plain version), every kernel
              call of a width-4 run against its plain version (recon 3
              times: the race check with other streams in flight), fps
              per width, the card's busy ms and stream concurrency of
              the waves (profiler); full1080 (DMVR) refused; the
              band-split deblock, SAO and ALF luma (parallel/spatial.py;
              the kernels on each band) at 1920x1088 in 4 bands equal
              to the whole-plane ops, with card ms; tools/decode.py on an MP4 of
              ra1080 made by the
              port's muxer, to the annex-B MD5s

then the kernel table line and, last, the result line.  Exits non-zero
with no result line when CUDA is unavailable or any phase fails
(nothing falls back: a failed build, launch or check fails the run).
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
TESTDATA = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata")
MAIN = "full1080"
CTU128 = "ctu128_1080"
# the coding-tool frames the kernels and timing phases hold apart
TOOL_FRAMES = (CTU128 + "/I", CTU128 + "/B", "ciip64")
FIXTURES = (MAIN, "ra1080", "ai720", "ai256x128_10b", CTU128, "ciip64",
            "gop720")
KERNELS = ("residual", "inter_pred", "recon", "deblock", "alf", "sao",
           "lmcs_inv", "dmvr")
# the one-launch filter kernels: SAO and the LMCS inverse map
FILTERS = ("sao", "lmcs_inv")
# the CUDA libraries (utils/build.py names): one per kernel
LIBS = KERNELS[:6] + ("lmcs", "dmvr")
# the kernels each fixture's path must launch: every fixture has
# residuals and deblock on; all but ciip64 SAO; full1080 and gop720 LMCS
# with chroma residual scaling (in the chroma residual call);
# ctu128_1080 LMCS without it; full1080, ctu128_1080 and gop720 ALF;
# full1080 and ctu128_1080 DMVR (POC 2, 1 and 3 of each)
NO_ALF = KERNELS[:4]
INTRA = ("residual", "recon", "deblock", "sao")
PATH_KERNELS = {MAIN: KERNELS, "ra1080": NO_ALF + ("sao",), "ai720": INTRA,
                "ai256x128_10b": INTRA, CTU128: KERNELS,
                "ciip64": NO_ALF, "gop720": KERNELS[:7]}
# the fixtures whose frames scale chroma residuals by LMCS, and their
# frames (one scaled chroma residual call each)
CRS_FIXTURES = {MAIN: 5, "gop720": 9}
# the DMVR search's launches on each path: one per DMVR frame
DMVR_LAUNCHES = {MAIN: 3, CTU128: 3}
# the traced span that counts a path's frames with a filter on (ALF, SAO,
# LMCS) or with DMVR units, and the kernel's launches per such 4:2:0
# frame (luma, then Cb and Cr; or one call)
FRAME_SPANS = {"alf": ("alf", 2), "sao": ("sao", 2), "lmcs_inv": ("lmcs", 1),
               "dmvr": ("dmvr", 1)}
# the wave path (parallel/gop.py): its fixtures and stream widths
GOP_FIXTURES = ("ra1080", "gop720")
GOP_WIDTHS = (1, 2, 4)
# the generate phase: the committed JAX-MD5 files whose every case is a
# generator config that its test decodes with a plain session decode
GEN_CASE_FILES = ("conformance_cases", "intra_cases", "inter_cases",
                  "tools_cases", "coding_cases", "deblock_cases",
                  "alf_mono_case", "parallel_cases")
# tests/test_torch_robustness.py's scenarios that decode whole generated
# streams on a fresh session (its P3 configs): back-to-back twice on one
# session, truncated-* the whole stream before its cut one
ROBUST_P3 = dict(width=64, height=64, qp=30, inter=True, n_frames=3)
ROBUST_PLAIN = {
    "back-to-back": (dict(ROBUST_P3, seed=47, b_slices=True, tmvp=True), 2),
    **{f"truncated-{f}": (dict(ROBUST_P3, seed=59), 1)
       for f in ("0.25", "0.5", "0.85", "0.97")}}
# the committed cases the generate phase leaves out, and why
GEN_LEFT_OUT = {
    "inter_cases/missing-ref": "inter-p with an access unit dropped, "
                               "decoded under errors='contain'",
    "robustness_cases/flush-seek-restart": "a flush between two streams "
                                           "on one session",
    "robustness_cases/missing-idr-contain": "the stream without its IDR",
    "robustness_cases/missing-idr-raise": "the stream without its IDR, "
                                          "which must raise",
    "robustness_cases/truncated-*": "the cut stream's decode; the whole "
                                    "stream's decode is in",
    "robustness_cases/garbage-*": "no generated stream: random bytes, an "
                                  "empty input, a random slice payload",
    "robustness_cases/seek-cra": "the stream cut at a CRA",
    "robustness_cases/seek-gdr": "the stream cut at a GDR",
}
# BASELINE's 17-frame main path (bench.py FULL_KW), made on the card's
# host: its config, size, sha256 and JAX MD5s
FULL17 = "full1080_17"
# generator worker processes, started before the build
GEN_WORKERS = 3

# NVIDIA H100 SXM data sheet (dense): the HBM rate, and the int32 rate
# outside the tensor cores, used for the kernels' least-time bounds (all
# eight kernels compute in integers): 64 INT32 lanes per SM (half the 128
# FP32 lanes behind the 67e12 float32 rate), a multiply-add counted as two
# operations: 132 SMs x 64 x 2 x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.4e12


def emit(obj) -> None:
  print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
  print(f"chip_smoke: {phase} failed: {msg}", file=sys.stderr, flush=True)
  sys.exit(1)


def _read(name):
  with open(os.path.join(TESTDATA, f"{name}.vvc"), "rb") as f:
    return f.read()


def _counts():
  """The launch and plain-run counters of every kernel wrapper."""
  from ffmpeg_tpu_torch.ops import (alf, deblock, dmvr, inter, lmcs, recon,
                                    sao, transform)

  return {"residual": transform, "inter_pred": inter, "recon": recon,
          "deblock": deblock, "alf": alf, "sao": sao, "lmcs_inv": lmcs,
          "dmvr": dmvr}


def _lmcs_scales_launches():
  """Launches of an LMCS kernel other than the inverse map: the chroma
  scales have no launch of their own (the chroma residual call derives
  them), so any such count is a standalone scales launch."""
  from ffmpeg_tpu_torch.ops import lmcs

  return sum(v for k, v in lmcs.LAUNCHES.items() if k != "lmcs_inv")


def _zero_counts():
  for name, mod in _counts().items():
    mod.LAUNCHES[name] = 0
    mod.PLAIN_RUNS[name] = 0
  _counts()["alf"].OVERLAPS["alf"] = 0
  _counts()["sao"].OVERLAPS["sao"] = 0
  for d in (_counts()["inter_pred"].CLASS_LAUNCHES,
            _counts()["recon"].EDGE_LAUNCHES,
            _counts()["residual"].GROUP_LAUNCHES,
            _counts()["residual"].CALLS):
    for k in d:
      d[k] = 0


def _path_counts():
  """(launches, plain runs) of every kernel since the counts were last
  zeroed."""
  counts = _counts()
  return ({k: m.LAUNCHES[k] for k, m in counts.items()},
          {k: m.PLAIN_RUNS[k] for k, m in counts.items()})


def phase_device(torch):
  if not torch.cuda.is_available():
    fail("device", "torch.cuda.is_available() is false")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
  card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
  info = {"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda}
  emit(info)
  print(card, flush=True)  # the card's name and power limit, as is
  return card


def phase_build():
  from ffmpeg_tpu_torch.models.vvc import host
  from ffmpeg_tpu_torch.ops import (alf, deblock, dmvr, inter, lmcs, recon,
                                    sao, transform)
  from ffmpeg_tpu_torch.utils.build import BUILD_LOG

  errors = []
  times = {}

  def run(name, fn):
    t0 = time.perf_counter()
    try:
      fn()
    except Exception as e:  # reported below; the phase fails
      errors.append(f"{name}: {e}")
    times[name] = time.perf_counter() - t0

  # one thread per library: each runs its own make / nvcc process
  threads = [threading.Thread(target=run, args=a) for a in (
      ("vvc_host", host._get_lib), ("recon", recon._get_kernel),
      ("inter_pred", inter._get_kernel), ("deblock", deblock._get_kernel),
      ("alf", alf._get_kernel), ("residual", transform._get_kernel),
      ("sao", sao._get_kernel), ("lmcs", lmcs._get_kernel),
      ("dmvr", dmvr._get_kernel))]
  t0 = time.perf_counter()
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  if errors:
    fail("build", "; ".join(errors))
  ptxas = {k: _ptxas(BUILD_LOG.get(k, {}).get("ptxas", [])) for k in LIBS}
  sass = _sass_loads()
  emit({"phase": "build", "seconds": time.perf_counter() - t0,
        "seconds_each": times, "ptxas": ptxas, "sass": sass})
  for k in ("dmvr", "residual", "lmcs"):
    print(f"chip_smoke: build {k}: " + "; ".join(
        f"{fn}: {', '.join(lines)}" for fn, lines in ptxas[k].items()),
        flush=True)
  for fn, c in sass.items():
    print(f"chip_smoke: build sass {fn}: {c}", flush=True)


def _sass_loads():
  """The sao and lmcs kernels' memory instructions from their built
  libraries' SASS (tools/sass_loads.py): {function: counts}."""
  from ffmpeg_tpu_torch.ops import lmcs, sao
  from ffmpeg_tpu_torch.tools import sass_loads
  from ffmpeg_tpu_torch.utils.build import build_cuda

  out = {}
  for mod, name in ((sao, "sao"), (lmcs, "lmcs")):
    out.update({fn: sass_loads.counts(ins) for fn, ins in sass_loads.parse(
        sass_loads.sass(build_cuda(name, [mod._SRC]))).items()})
  return out


def _ptxas(lines):
  """nvcc -Xptxas -v lines -> {kernel function: its registers, shared
  memory and spill lines}."""
  out, cur = {}, None
  for ln in lines:
    m = re.search(r"Compiling entry function '([^']+)'", ln)
    if m:
      cur = out.setdefault(m.group(1), [])
    elif cur is not None:
      cur.append(ln.split(":", 1)[-1].strip())
  return out


def _walk_calls(name, pick=None, gathered=None):
  """Walk a fixture's frames through the frame program on the card
  (pipeline.walk_frames), each kernel call running its wrapper.
  pick(fs, host inputs) -> bool marks the frame to keep: returns (fs,
  that frame's kernel calls [(kernel, plane kind, kwargs)], per-frame
  unit records) for the first picked frame (frame 0, and no further
  walk, without pick).  gathered, a list, gathers (kernel, plane kind,
  kwargs) of every DMVR search call and every chroma residual call with
  LMCS chroma scaling (a scales' source) of the walk."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  frame_calls, records, kept = [], [], None

  def record(kernel, label, kw):
    frame_calls.append((kernel, label, kw))
    if gathered is not None and (kernel == "dmvr"
                                 or kw.get("scale_src") is not None):
      gathered.append((kernel, label, kw))
    return KERNELS[kernel][0](**kw)

  aus = VVCDecoder(device="cuda")._split_aus(_read(name))
  for fs, h in walk_frames(aus, "cuda", record):
    records.append({**_unit_counts(fs, h), **_schedule(frame_calls)})
    if kept is None and (pick is None or pick(fs, h)):
      kept = (fs, list(frame_calls))
      if pick is None:
        break
    frame_calls.clear()
  if kept is None:
    fail("kernels", f"{name}: no frame holds every unit kind")
  return (*kept, records)


def _unit_counts(fs, h):
  """The frame's luma units by path, its LMCS and ALF state (the CTBs
  with luma ALF on), and the bytes of its MC tiles (mc_tiles, both plane
  kinds)."""
  from ffmpeg_tpu_torch.models.vvc.mc_tiles import nbytes

  y = h["ctrl"]["y"]
  inter = y["inter"]
  n_pure = int(y["n_inter"])
  tiles = nbytes(inter["toff"], 1)
  if fs.chroma_format_idc:
    tiles += nbytes(h["ctrl"]["c"]["inter"]["toff"], 2)
  rows = y["intra"]
  n_iu = int(rows["iend"][-1]) if int(y["n_chunks"]) else 0
  w, hh = rows["w"][:n_iu], rows["h"][:n_iu]
  return {"poc": fs.poc, "slice_type": fs.slice_type, "pure_inter": n_pure,
          "edge64": int(((w == 64) | (hh == 64)).sum()),
          "high1": int((hh == 1).sum()), "high2": int((hh == 2).sum()),
          "ciip64": int(((w == 64) & (hh == 64)
                         & (rows["ciipw"][:n_iu] > 0)).sum()),
          "has_isp": int(fs.has_isp), "has_tb64": int(fs.has_tb64),
          "ciip": int((rows["ciipw"][:n_iu] > 0).sum()),
          "gpm": int((inter["gpm_part"][:n_pure] > 0).sum()),
          "bdof": int((inter["bdof"][:n_pure] > 0).sum()),
          "prof": int((inter["prof"][:n_pure] != 0).sum()),
          "dmvr": int((inter["dmvr"][:n_pure] > 0).sum()),
          "intra": n_iu - int((rows["ciipw"][:n_iu] > 0).sum()),
          "lmcs": "lmcs" in h, "lmcs_crs": "chroma_scale" in h.get("lmcs", {}),
          "alf_luma_ctbs": int((h["alf"]["ctb"][..., 0] > 0).sum())
          if "alf" in h else 0,
          "tile_bytes": tiles}


def _every_path(fs, h):
  c = _unit_counts(fs, h)
  return fs.slice_type == 0 and all(
      c[k] > 0 for k in ("pure_inter", "ciip", "gpm", "bdof", "prof"))


def _every_tool(fs, h):
  """_every_path, and DMVR units, LMCS with chroma scaling and ALF-on
  CTBs: the main path's B frame."""
  c = _unit_counts(fs, h)
  return _every_path(fs, h) and c["dmvr"] > 0 and c["lmcs_crs"] and \
      c["alf_luma_ctbs"] > 0


def _is_b(fs, h):
  return fs.slice_type == 0


def _has_ciip64(fs, h):
  return _unit_counts(fs, h)["ciip64"] > 0


def _kernel(name, kw):
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS

  return KERNELS[name][0](**kw)


def _plain(name, kw):
  """The plain torch version on the same card tensors."""
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS

  return KERNELS[name][1](**kw)


def _bytes_moved(name, kw):
  """Each input read once, the output written once (bytes).  For the
  reference planes, the samples the units read (_ref_samples); the MC
  tiles, which inter_pred writes and recon reads, hold each unit's w x h
  samples (mc_tiles)."""
  from ffmpeg_tpu_torch.models.vvc.mc_tiles import nbytes

  if name == "sao":
    # each plane in and out; per plane its component's CTB grids (type,
    # band position, EO class and 5 offsets: 8 words a CTB)
    cbh, cbw = kw["sao"]["type"].shape[:2]
    return sum(p.numel() * 4 * 2 for p in kw["planes"]) + \
        len(kw["planes"]) * cbh * cbw * 8 * 4
  if name == "lmcs_inv":  # the plane in and out (the tables are a few words)
    return kw["x"].numel() * 4 * 2
  if name == "dmvr":
    # the distinct samples of the subblocks' two windows in, the rows in
    # and out
    n = kw["ctrl"].shape[1]
    return (_dmvr_samples(kw) + 10 * n + 3 * n) * 4
  if name == "deblock":   # each plane in and out, each pass's grids in
    return sum(p.numel() * 4 * 2 for p in kw["planes"]) + sum(
        t.numel() * 4 for g in kw["grids_v"] + kw["grids_h"] for t in g)
  if name == "residual":
    # each live TU's rows and coded levels in, the planes written once,
    # the scaling lists the call reads, and for LMCS chroma scaling the
    # distinct luma samples of the scaled TUs' VPDUs (_scale_reads)
    b = sum(kw["Hp"] * kw["Wp"] * 4 for _ in kw["buckets"])
    for comp in kw["buckets"]:
      for wh in kw["sizes"]:
        n, lv = int(comp[wh]["n"]), comp[wh]["lv"]
        b += n * (comp[wh]["mat"].shape[0] + lv.shape[1] * lv.shape[2]) * 4
    b += sum(t.numel() * 4 for t in (kw["sl"] or {}).values())
    return b + _scale_reads(kw)[1] * 4
  if name == "alf":
    # each padded plane in and out (the padding is copied), for chroma
    # the picture's pre-ALF luma in, the CTB grid and the tables the call
    # reads
    a = kw["alf"]
    b = sum(p.numel() * 4 * 2 for p in kw["planes"]) + a["ctb"].numel()
    tabs = ("chroma_coeff", "chroma_clipv", "cc_coeff") if kw["chroma"] \
        else ("banks_coeff", "banks_clipv")
    b += sum(a[k].numel() * 2 for k in tabs)
    return b + (kw["H"] * kw["W"] * 4 if kw["chroma"] else 0)
  inter = kw["inter"]
  toff = inter["toff_host"]
  if name == "inter_pred":
    nch = len(kw["refs"])
    b = _ref_samples(kw) * 4
    b += (inter["mat_host"].nbytes + inter["gslot"].numel() * 4
          + inter["gwt"].numel() * 4 + toff.nbytes
          + inter["small_host"].nbytes + inter["large_host"].nbytes)
    return b + nbytes(toff, nch)                  # the units' samples out
  intra = kw["intra"]
  nch = kw["res"].shape[0]
  b = kw["res"].numel() * 4 * 2                   # residual in, plane out
  b += intra["mat"].numel() * 4 + intra["ipos"].numel() * 4
  b += inter["mat_host"][:4].nbytes
  if kw["tiles"] is not None:                     # placed and CIIP samples
    b += nbytes(toff, nch) + toff.nbytes
  if kw.get("cclm") is not None:
    b += kw["cclm"][1].numel() * 4 + 4 * 4 * intra["mat"].shape[1]
  return b


def _scale_reads(kw):
  """A chroma residual call's LMCS chroma scale work, counted from its
  rows: the distinct VPDUs its scaled TUs (2-D, more than 4 samples)
  name, and the distinct luma samples of those VPDUs' available left
  columns and top rows (ops/lmcs.py lmcs_vpdu_scales_plain), as (VPDUs,
  samples); (0, 0) without a scales' source."""
  import numpy as np

  from ffmpeg_tpu_torch.ops.transform import BUCKET_ROWS

  src = kw.get("scale_src")
  if src is None:
    return 0, 0
  H, W = src["luma"].shape
  vsz, (bx, by) = src["vsz"], src["tile_bds"]
  k = BUCKET_ROWS.index("vpdu")
  v = np.unique(np.concatenate([np.zeros(0, np.int64)] + [
      comp[(w, h)]["mat"][k, :int(comp[(w, h)]["n"])].cpu().numpy()
      for comp in kw["buckets"] for w, h in kw["sizes"]
      if w > 1 and h > 1 and w * h > 4]).astype(np.int64))
  nvx = -(-W // vsz)
  vy, vx = v // nvx * vsz, v % nvx * vsz
  al = (vx > 0) & ~np.isin(vx, bx)
  at = (vy > 0) & ~np.isin(vy, by)
  samples = al * np.minimum(H - vy, vsz) + at * np.minimum(W - vx, vsz)
  return len(v), int(samples.sum())


def _pivot_scan_ops(lm):
  """The pivot scan's operations per value: 2 per pivot scanned (the
  compare and the add), max_bin - min_bin + 1 pivots."""
  tab = lm["inv_host"]
  return 2 * (min(int(tab[34]), 15) - max(int(tab[33]), 0) + 1)


def _ref_samples(kw):
  """Reference samples an inter_pred call must read, each once: the union
  of the units' reads (per hypothesis the unit uses, its (w + taps - 1) x
  (h + taps - 1) filter window, and luma PROF's 6x6 ring), rows clamped
  to the picture (or a DMVR unit's window) and columns clamped or wrapped
  as the kernel reads them, marked in one mask per distinct plane and
  channel.  Planes are told apart by their storage, so that list entries
  naming one picture count once."""
  import numpy as np

  from ffmpeg_tpu_torch.models.vvc.inputs import INTER_KEYS

  inter = kw["inter"]
  r = {k: inter["mat_host"][i].astype(np.int64)
       for i, k in enumerate(INTER_KEYS)}
  H, W, wrap = kw["H"], kw["W"], kw["wrap"]
  taps, before, fb = (4, 1, 5) if kw["is_chroma"] else (8, 3, 4)
  n = len(r["w"])
  ciip = np.arange(n) >= inter["n_inter"]
  gpm = r["gpm_part"] > 0
  need = (gpm | (r["pf"] == 1) | (r["pf"] == 3), gpm | (r["pf"] != 1))
  six = np.full(n, 6)
  dmvr = (r["dmvr"] > 0) & ~ciip

  def window(lx, a, size, lim):
    """The clamp bounds of each unit's reads along one axis (ops/inter.py
    _dmvr_windows): the picture, or a DMVR unit's original-MV region."""
    o = r[f"{a}0"] + (r[f"om{lx}{a}"] >> fb)
    lo = np.clip(o - before, 0, lim - 1)
    hi = lo + np.maximum(np.minimum(lim, o + size + taps - before - 1) - lo,
                         1) - 1
    return np.where(dmvr, lo, 0), np.where(dmvr, hi, lim - 1)

  total = 0
  for ch in kw["refs"]:
    ids: dict = {}
    plane_of = np.array([ids.setdefault(t.data_ptr(), len(ids)) for t in ch])
    mask = np.zeros((len(ids), H, W), bool)
    for lx in (0, 1):
      mvx, mvy = r[f"m{lx}x"], r[f"m{lx}y"]
      plane = plane_of[np.clip(r[f"r{lx}slot"], 0, len(ch) - 1)]
      pic = (np.zeros(n, np.int64), np.full(n, W - 1),
             np.zeros(n, np.int64), np.full(n, H - 1))
      reads = [(need[lx], r["y0"] + (mvy >> fb) - before,
                r["x0"] + (mvx >> fb) - before, r["w"] + taps - 1,
                r["h"] + taps - 1, ciip,
                (*window(lx, "x", r["w"], W), *window(lx, "y", r["h"], H)))]
      if not kw["is_chroma"]:
        reads.append((need[lx] & (((r["prof"] >> lx) & 1) > 0),
                      r["y0"] + (mvy >> 4) + ((mvy >> 3) & 1) - 1,
                      r["x0"] + (mvx >> 4) + ((mvx >> 3) & 1) - 1, six, six,
                      np.ones(n, bool), pic))
      for sel, iy, ix, gw, gh, wraps, (x0, x1, y0, y1) in reads:
        for cw, chh in set(zip(gw[sel].tolist(), gh[sel].tolist())):
          idx = np.flatnonzero(sel & (gw == cw) & (gh == chh))
          for lo in range(0, len(idx), 1024):
            u = idx[lo:lo + 1024]
            ys = np.clip(iy[u, None] + np.arange(chh), y0[u, None],
                         y1[u, None])
            xs = ix[u, None] + np.arange(cw)
            if wrap:
              on = wraps[u, None]
              xs = np.where(on & (xs < 0), xs + wrap, xs)
              xs = np.where(on & (xs > W - 1), xs - wrap, xs)
            xs = np.clip(np.clip(xs, 0, W - 1), x0[u, None], x1[u, None])
            mask[plane[u, None, None], ys[:, :, None], xs[:, None, :]] = True
    total += int(mask.sum())
  return total


def _dmvr_samples(kw):
  """Reference samples a dmvr call must read, each once: the union of
  its subblocks' two 21 x 21 windows, clamped to the picture as the
  kernel reads them, marked in one mask per distinct plane (planes told
  apart by their storage, so that list entries naming one picture count
  once)."""
  import numpy as np

  from ffmpeg_tpu_torch.ops.dmvr import _WIN, CTRL_KEYS

  c = dict(zip(CTRL_KEYS, kw["ctrl"].cpu().numpy().astype(np.int64)))
  H, W = kw["H"], kw["W"]
  ids: dict = {}
  plane_of = np.array([ids.setdefault(t.data_ptr(), len(ids))
                       for t in kw["planes"]])
  mask = np.zeros((len(ids), H, W), bool)
  idx = np.arange(_WIN)
  for lx in (0, 1):
    ys = np.clip((c["y"] + (c[f"my{lx}"] >> 4) - 2)[:, None] + idx, 0, H - 1)
    xs = np.clip((c["x"] + (c[f"mx{lx}"] >> 4) - 2)[:, None] + idx, 0, W - 1)
    mask[plane_of[c[f"s{lx}"]][:, None, None], ys[:, :, None],
         xs[:, None, :]] = True
  return int(mask.sum())


def _dmvr_ops(kw):
  """_ops for a dmvr call, counted from its rows: per subblock and list
  the 20 x 20 prediction by its branch (a whole MV 1 a sample, the
  shift; horizontal or vertical 5, two multiplies, two adds and the
  shift; diagonal 5 for each of the 21 x 20 horizontal taps and 5 for
  each vertical one), per offset of the 25 three a SAD sample (the
  difference, its absolute value and the add) over the h / 2 x w
  samples, and about 100 (the reductions' share, the centre's bias, the
  argmin and the parametric steps)."""
  import numpy as np

  from ffmpeg_tpu_torch.ops.dmvr import CTRL_KEYS

  c = dict(zip(CTRL_KEYS, kw["ctrl"].cpu().numpy().astype(np.int64)))
  total = 0
  for lx in (0, 1):
    fx, fy = c[f"mx{lx}"] & 15, c[f"my{lx}"] & 15
    total += int(np.where((fx == 0) & (fy == 0), 400,
                          np.where((fx > 0) & (fy > 0), 5 * (420 + 400),
                                   5 * 400)).sum())
  return total + int((25 * 3 * (c["h"] // 2) * c["w"] + 100).sum())


def _wh_hyp(rows):
  """Per MC unit: width, height and hypothesis count (int64 numpy)."""
  from ffmpeg_tpu_torch.models.vvc.inputs import INTER_KEYS

  r = {k: rows[INTER_KEYS.index(k)].astype("int64")
       for k in ("w", "h", "pf", "gpm_part")}
  hyp = 1 + ((r["pf"] == 3) | (r["gpm_part"] > 0))
  return r["w"], r["h"], hyp


def _ops(name, kw):
  """32-bit operations the kernel needs for these inputs.
  inter_pred: per hypothesis the separable filter (a multiply and an add
  per tap, horizontal over h + taps - 1 rows, then vertical), per sample
  about 8 for rounding, weighting and the clip; BDOF about 6000 per unit
  (gradients and the 6x6 sums of 16 4x4 blocks) and PROF about 400.
  recon: per written intra sample the prediction (at most a 4-tap filter
  plus PDPC: about 32 operations) and the residual add and clip, per
  unit the edge build and filtering (about 8 operations per edge lane),
  and 3 per placed inter sample.
  deblock: per segment with bs > 0 of each pass its decision (about 150
  operations for luma, 60 for chroma) and per line its filter (at most
  about 120: the large filter's 7 taps a side; chroma 40); per segment
  with bs 0, 4 (the load and the test).
  alf: per luma sample of the picture its share of the classification
  (about 14: a quarter of a gradient position's 30, the 4x4 window sums
  and the class), per luma sample of a CTB with luma ALF on the 7x7
  diamond (12 tap pairs of 2 differences, 2 clips, an add, a multiply
  and the sum: about 113 with the rounding and clip); per chroma sample
  with its flag on the 5x5 diamond (about 60), with a CC-ALF index
  above 0 the 7 taps (about 27); 1 per sample of each padded plane
  (the select or copy).
  residual: counted from the call's rows (_residual_ops).
  sao: per picture sample of a band CTB about 8 (the band index, its
  test, the offset's load, the add and the clip), of an edge CTB about
  24 (8 in-picture compares, the two neighbours' clamped addresses, two
  wrapped differences and signs, the slot, the add and the clip), of an
  SAO-off CTB 2 (the clip); 1 per padding sample (the copy).
  lmcs_inv: per sample 2 per pivot scanned (max_bin - min_bin + 1: the
  compare and the add) and about 12 (the bin's test, the multiply, the
  rounding, the shifts, the add and the clip).
  dmvr: counted from the call's rows (_dmvr_ops)."""
  from ffmpeg_tpu_torch.models.vvc.inputs import INTER_KEYS, INTRA_KEYS

  if name == "residual":
    return _residual_ops(kw)
  if name == "sao":
    return _sao_ops(kw)
  if name == "dmvr":
    return _dmvr_ops(kw)
  if name == "lmcs_inv":
    return kw["x"].numel() * (_pivot_scan_ops(kw["lm"]) + 12)
  if name == "alf":
    return _alf_ops(kw)
  if name == "deblock":
    lines, decide, per_line = (2, 60, 40) if kw["chroma"] else (4, 150, 120)
    total = 0
    for g in kw["grids_v"] + kw["grids_h"]:
      act = int((g[0] > 0).sum().item())
      total += 4 * (g[0].numel() - act) + act * (decide + lines * per_line)
    return total
  inter = kw["inter"]
  if name == "inter_pred":
    rows = inter["mat_host"]
    taps = 4 if kw["is_chroma"] else 8
    w, h, hyp = _wh_hyp(rows)
    per = 2 * taps * ((h + taps - 1) * w + h * w) * hyp + 8 * w * h
    extra = 0
    if not kw["is_chroma"]:
      extra = (6000 * int((rows[INTER_KEYS.index("bdof")] > 0).sum())
               + 400 * int((rows[INTER_KEYS.index("prof")] != 0).sum()))
    return len(kw["refs"]) * (int(per.sum()) + extra)
  rows = kw["intra"]["mat_host"]
  n = int(kw["intra"]["iend_host"][-1]) if kw["n_chunks"] else 0
  w = rows[INTRA_KEYS.index("w"), :n].astype("int64")
  h = rows[INTRA_KEYS.index("h"), :n].astype("int64")
  nch = kw["res"].shape[0]
  L = 5 * kw["maxs"] + 16
  n_in = inter["n_inter"]
  placed = int((inter["mat_host"][2, :n_in].astype("int64")
                * inter["mat_host"][3, :n_in]).sum())
  return nch * (int((w * h).sum()) * 36 + n * L * 8 + 3 * placed)


def _residual_ops(kw):
  """_ops for a residual call, from its rows: per coded level the dequant
  (about 6: the multiply, the rounding add, the shift, the clamp and the
  zero test); per TU outside transform skip its passes' multiply-adds
  (2-D: h x zw x zh for the columns and h x w x zw for the rows; 1-D: n x
  zn), per LFNST TU 16 x N, 2 operations each; per written sample about
  4 (rounding, shift, store), 8 more on chroma (joint CbCr, LMCS); for
  LMCS chroma scaling, per distinct VPDU of the scaled TUs 1 per luma
  sample read (the add), about 30 (the sums' reduction, the
  availability, the mean) and the pivot scan (_scale_reads)."""
  from ffmpeg_tpu_torch.ops.transform import BUCKET_ROWS

  k = BUCKET_ROWS.index
  per_sample = 12 if kw["chroma"] else 4
  total = 0
  for comp in kw["buckets"]:
    for w, h in kw["sizes"]:
      n = int(comp[(w, h)]["n"])
      if not n:
        continue
      m = comp[(w, h)]["mat"][:, :n].cpu().numpy()
      zw, zh = min(w, 32), min(h, 32)
      ts = (m[k("ts")] > 0) & ((zw, zh) == (w, h))
      if w == 1 or h == 1:
        macs = max(w, h) * (zw if h == 1 else zh)
      else:
        macs = h * zw * zh + h * w * zw
      macs *= int((~ts).sum())
      if not kw["chroma"] and w >= 4 and h >= 4:
        macs += 16 * (48 if w >= 8 and h >= 8 else 16) * int(
            (m[k("lf_sel")] >= 0).sum())
      total += 6 * n * zh * zw + 2 * macs + per_sample * n * w * h
  vpdus, samples = _scale_reads(kw)
  if vpdus:
    total += samples + vpdus * (30 + _pivot_scan_ops(kw["scale_src"]["lm"]))
  return total


def _sao_ops(kw):
  """_ops for a sao call, counted from its tree: the picture samples of
  each CTB by its type, per plane."""
  import numpy as np

  cs = kw["comps"]
  typ = kw["sao"]["type"].cpu().numpy()
  ctb, H, W = kw["ctb"], kw["pic_h"], kw["pic_w"]
  hs = np.clip(H - np.arange(typ.shape[0]) * ctb, 0, ctb)
  ws = np.clip(W - np.arange(typ.shape[1]) * ctb, 0, ctb)
  area = hs[:, None] * ws[None, :]
  total = 0
  for pl, c in zip(kw["planes"], cs):
    t = typ[..., c]
    total += pl.numel() - int(area.sum())
    total += 8 * int(area[t == 1].sum()) + 24 * int(area[t == 2].sum()) \
        + 2 * int(area[(t != 1) & (t != 2)].sum())
  return total


def _alf_ops(kw):
  """_ops for an alf call, counted from its tree: the picture samples of
  each CTB whose flag (or CC-ALF index) turns a filter on."""
  import numpy as np

  g = kw["alf"]["ctb"].cpu().numpy().astype(np.int64)
  H, W, lg = kw["H"], kw["W"], kw["ctb_log2"]
  ss = 1 if kw["chroma"] else 0
  ctb = 1 << (lg - ss)
  hs = np.clip((H >> ss) - np.arange(g.shape[0]) * ctb, 0, ctb)
  ws = np.clip((W >> ss) - np.arange(g.shape[1]) * ctb, 0, ctb)
  area = hs[:, None] * ws[None, :]          # samples of each CTB
  total = sum(p.numel() for p in kw["planes"])
  if not ss:
    return total + 14 * H * W + 113 * int(area[g[..., 0] > 0].sum())
  for c in (1, 2):
    total += 60 * int(area[g[..., 2 * c] > 0].sum())
    total += 27 * int(area[g[..., 5 + c] > 0].sum())
  return total


def _levels(calls):
  """The recon calls' critical paths: the largest dependency level of
  each plane kind (ops/recon.py dependency_levels)."""
  from ffmpeg_tpu_torch.ops.recon import dependency_levels

  out = {}
  for name, label, kw in calls:
    if name == "recon":
      n = int(kw["intra"]["iend_host"][-1]) if kw["n_chunks"] else 0
      out[label] = int(dependency_levels(kw["intra"], n,
                                         is_chroma=kw["is_chroma"]).max()
                       ) if n else 0
  return out


def _schedule(calls):
  """A frame's recon schedule per plane kind: the host's chunks (CHUNK_CAP
  units at most) and the wavefront's dependency levels."""
  return {"chunks": {label: kw["n_chunks"] for name, label, kw in calls
                     if name == "recon"},
          "levels": _levels(calls)}


def _check_calls(fixture, calls, out, torch):
  for name, label, kw in calls:
    got = _kernel(name, kw)
    torch.cuda.synchronize()
    want = _plain(name, kw)
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item()) if got.numel() else 0
    out["cases"].append({"fixture": fixture, "kernel": name, "plane": label,
                         "equal": bool(torch.equal(got, want)),
                         "max_abs_err": err})
    if not torch.equal(got, want):
      emit(out)
      fail("kernels", f"{fixture} {name} {label}: kernel != plain "
           f"(max err {err})")
    if name == "residual" and int(kw["err"].item()):
      emit(out)
      fail("kernels", f"{fixture} residual {label}: error word "
           f"{int(kw['err'].item())}")
    if name == "deblock":
      _check_deblock_passes(fixture, label, kw, out, torch)


def _check_deblock_passes(fixture, label, kw, out, torch):
  """The deblock kernel's one-pass mode (deblock_pass) on a frame
  program call's inputs: the vertical pass, then the horizontal pass on
  its result, each against the plain version, tolerance 0."""
  from ffmpeg_tpu_torch.ops.deblock import deblock_pass, deblock_pass_plain

  base = {k: v for k, v in kw.items() if k not in ("grids_v", "grids_h")}
  for o in ("v", "h"):
    a = dict(base, grids=kw[f"grids_{o}"], horizontal=o == "h")
    got = deblock_pass(**a)
    torch.cuda.synchronize()
    want = deblock_pass_plain(**a)
    err = int((got - want).abs().max().item())
    out["cases"].append({"fixture": fixture, "kernel": "deblock",
                         "plane": f"{label}/{o}", "mode": "one pass",
                         "equal": bool(torch.equal(got, want)),
                         "max_abs_err": err})
    if not torch.equal(got, want):
      emit(out)
      fail("kernels", f"{fixture} deblock {label}/{o} (one pass): kernel "
           f"!= plain (max err {err})")
    base["planes"] = list(got)


def phase_kernels(torch):
  """Every kernel against its plain version on the B frames of full1080
  (with DMVR, LMCS and ALF) and ra1080 with their real references, and
  on the coding-tool frames; recon and deblock on frame 0 of the intra
  fixtures; every DMVR search call and every chroma residual call with
  LMCS chroma scaling of the walks (gop720's walked for the latter).
  Returns the worst error per kernel and each fixture's checked calls."""
  out = {"phase": "kernels", "tolerance": 0, "cases": [], "frames": {}}
  calls, records, walked = {}, {}, {}
  for name, pick in ((MAIN, _every_tool), ("ra1080", _every_path)):
    fs, calls[name], records[name] = _walk_calls(
        name, pick, walked.setdefault(name, []))
    units = next(r for r in records[name] if r["poc"] == fs.poc)
    out["frames"][name] = {
        **units, "mc_units": {label: {k: len(kw["inter"][k + "_host"])
                                      for k in ("small", "large")}
                              for n, label, kw in calls[name]
                              if n == "inter_pred"}}
    # the main path's inter calls carry DMVR windows and the luma map
    lm = [kw.get("lmcs") is not None for n, label, kw in calls[name]
          if n == "inter_pred" and label == "luma"]
    out["frames"][name]["inter_luma_lmcs"] = lm == [True]
    if name == MAIN and not (lm == [True] and units["dmvr"] > 0):
      fail("kernels", f"{MAIN} POC {fs.poc}: the inter calls carry no DMVR "
           f"units or no LMCS map: {units}")
  print(f"chip_smoke: kernels on {MAIN} POC {out['frames'][MAIN]['poc']}: "
        f"{out['frames'][MAIN]['dmvr']} DMVR units, LMCS with chroma "
        f"scaling, {out['frames'][MAIN]['alf_luma_ctbs']} CTBs with luma "
        "ALF", flush=True)
  for name in FIXTURES[2:4]:
    calls[name] = _walk_calls(name)[1]
  # the coding-tool paths: ctu128_1080's I frame (ISP at readiness cell 1,
  # 64-edge luma units) and first B frame, ciip64's first frame with a
  # 64x64 CIIP unit
  from ffmpeg_tpu_torch.ops.recon import readiness_cell

  for key, name, pick in ((CTU128 + "/I", CTU128, None),
                          (CTU128 + "/B", CTU128, _is_b),
                          ("ciip64", "ciip64", _has_ciip64)):
    fs, calls[key], rr = _walk_calls(name, pick,
                                     walked.setdefault(name, []))
    units = next(r for r in rr if r["poc"] == fs.poc)
    units["cell"] = {label: readiness_cell(
        kw["intra"]["mat_host"][:, :int(kw["intra"]["iend_host"][-1])
                                if kw["n_chunks"] else 0])
        for n, label, kw in calls[key] if n == "recon"}
    units["maxs"] = {label: kw["maxs"] for n, label, kw in calls[key]
                     if n == "recon"}
    out["frames"][key] = units
    records[key] = rr
    print(f"chip_smoke: kernels on {name} POC {fs.poc}: {units['edge64']} "
          f"64-edge and {units['high1']} 1-high / {units['high2']} 2-high "
          f"luma units, {units['ciip64']} 64x64 CIIP units, readiness cell "
          f"{units['cell']}, maxs {units['maxs']}", flush=True)
  if not (out["frames"][CTU128 + "/I"]["edge64"]
          and out["frames"][CTU128 + "/I"]["cell"]["luma"] == 1
          and out["frames"]["ciip64"]["ciip64"]):
    fail("kernels", "the coding-tool frames hold no 64-edge unit, no cell-1 "
         "call or no 64x64 CIIP unit")
  # the SAO and LMCS kernels' calls on the frames that make them
  filt = {MAIN: ("sao", "sao", "lmcs_inv"),
          "ra1080": ("sao", "sao"), "ai720": ("sao", "sao"),
          "ai256x128_10b": ("sao", "sao"),
          CTU128 + "/I": ("sao", "sao", "lmcs_inv"),
          CTU128 + "/B": ("sao", "sao", "lmcs_inv"), "ciip64": ()}
  for key, want in filt.items():
    got = tuple(sorted(n for n, _, _ in calls[key] if n in FILTERS))
    if got != tuple(sorted(want)):
      fail("kernels", f"{key}: SAO and LMCS calls {got}, expected {want}")
  for name in calls:
    _check_calls(name, calls[name], out, torch)
  # every DMVR search call of the walks (full1080's and ctu128_1080's walk
  # every frame), against the plain version
  searches = {name: [c for c in cc if c[0] == "dmvr"]
              for name, cc in walked.items()}
  subblocks = {name: [kw["ctrl"].shape[1] for _, _, kw in cc]
               for name, cc in searches.items() if cc}
  for name in subblocks:
    _check_calls(name + "/searches", searches[name], out, torch)
  if sorted(subblocks) != sorted((MAIN, CTU128)):
    fail("kernels", f"DMVR searches recorded on {sorted(subblocks)}, not "
         f"on {MAIN} and {CTU128}")
  out["dmvr_searches"] = subblocks
  print(f"chip_smoke: kernels dmvr: "
        f"{sum(len(v) for v in subblocks.values())} search calls held "
        f"against the plain version, subblocks {subblocks}", flush=True)
  # every chroma residual call with LMCS chroma scaling of full1080's and
  # gop720's walks (every frame), against the plain pair
  _walk_calls("gop720", _is_b, walked.setdefault("gop720", []))
  scaled = {name: [c for c in walked.get(name, []) if c[0] == "residual"]
            for name in CRS_FIXTURES}
  for name, cc in scaled.items():
    _check_calls(name + "/scaled", cc, out, torch)
  out["scaled_chroma_calls"] = {
      name: [{"vsz": kw["scale_src"]["vsz"],
              "tus": sum(int(c[wh]["n"]) for c in kw["buckets"]
                         for wh in kw["sizes"])} for _, _, kw in cc]
      for name, cc in scaled.items()}
  if {k: len(v) for k, v in scaled.items()} != CRS_FIXTURES or any(
      label != "chroma" for cc in scaled.values() for _, label, _ in cc):
    fail("kernels", "chroma residual calls with LMCS chroma scaling: "
         f"{ {k: [c[1] for c in v] for k, v in scaled.items()} }, expected "
         f"one chroma call a frame: {CRS_FIXTURES}")
  print("chip_smoke: kernels residual chroma with LMCS chroma scaling: "
        + ", ".join(f"{name} {len(cc)} calls (vsz "
                    f"{cc[0][2]['scale_src']['vsz']})"
                    for name, cc in scaled.items())
        + " held against the plain pair", flush=True)
  worst = {k: max(c["max_abs_err"] for c in out["cases"] if c["kernel"] == k)
           for k in KERNELS}
  out["max_abs_err"] = max(worst.values())
  out["levels"] = {name: out["frames"][name]["levels"]
                   for name in (MAIN, "ra1080", CTU128 + "/I",
                                CTU128 + "/B", "ciip64")}
  out["levels"]["ai720"] = _levels(calls["ai720"])
  out["tile_bytes_peak_frame"] = {
      name: max(r["tile_bytes"] for r in rr) for name, rr in records.items()}
  out["records"] = records
  emit(out)
  return worst, calls, out["levels"]


def _decode_md5s(name, torch):
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  return [fr.md5() for fr in VVCDecoder(device="cuda").decode(_read(name))]


def phase_decode(torch):
  """Each fixture is its own path: the counts are zeroed just before its
  decode and read just after; the decode is traced, so that its alf,
  sao, lmcs and dmvr spans count the frames with each filter on or with
  DMVR units (FRAME_SPANS); the dmvr kernel's launches are
  DMVR_LAUNCHES', and no standalone LMCS chroma scales launch runs.
  Returns the launches of each path."""
  from ffmpeg_tpu_torch.utils import trace

  res = {"phase": "decode", "fixtures": {}}
  launches = {}
  for name in FIXTURES:
    with open(os.path.join(TESTDATA, f"{name}.md5.json")) as f:
      want = json.load(f)["md5"]
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    trace.enable(True)
    _zero_counts()
    try:
      got = _decode_md5s(name, torch)
    finally:
      trace.enable(False)
    spans = trace.summary()
    frames = {k: spans.get(span, {}).get("n", 0)
              for k, (span, _) in FRAME_SPANS.items()}
    alf_frames = frames["alf"]
    counts = _counts()
    launches[name], plain = _path_counts()
    launches[name]["inter_pred_by_class"] = dict(
        counts["inter_pred"].CLASS_LAUNCHES)
    launches[name]["recon_by_edge"] = dict(counts["recon"].EDGE_LAUNCHES)
    launches[name]["residual_by_group"] = dict(
        counts["residual"].GROUP_LAUNCHES)
    launches[name]["residual_calls"] = counts["residual"].CALLS["residual"]
    launches[name]["alf_overlapped"] = counts["alf"].OVERLAPS["alf"]
    launches[name]["sao_overlapped"] = counts["sao"].OVERLAPS["sao"]
    launches[name]["lmcs_scales"] = _lmcs_scales_launches()
    res["fixtures"][name] = {
        "frames": len(got), "md5_equal": got == want,
        "launches": launches[name], "plain_runs": plain,
        "deblock_launches_per_frame": launches[name]["deblock"] / len(got),
        "residual_calls_per_frame":
            launches[name]["residual_calls"] / len(got),
        "residual_launches_per_frame":
            launches[name]["residual"] / len(got),
        "alf_frames": alf_frames, "filter_frames": frames,
        "alf_launches_per_alf_frame":
            launches[name]["alf"] / max(alf_frames, 1),
        "peak_device_bytes": torch.cuda.max_memory_allocated()}
    if got != want:
      emit(res)
      fail("decode", f"{name}: frame MD5s {got} != {want}")
    for k in PATH_KERNELS[name]:
      if launches[name][k] <= 0:
        emit(res)
        fail("decode", f"{name}: the {k} kernel was never launched")
    if any(plain.values()):
      emit(res)
      fail("decode", f"{name}: a plain version ran: {plain}")
    if res["fixtures"][name]["deblock_launches_per_frame"] != 2:
      emit(res)
      fail("decode", f"{name}: the deblock kernel was not launched twice a "
           "frame (luma; Cb and Cr)")
    calls = launches[name]["residual_calls"]
    if calls != 2 * len(got) or not calls <= launches[name]["residual"] \
        <= 3 * calls or sum(launches[name]["residual_by_group"].values()) \
        != launches[name]["residual"]:
      emit(res)
      fail("decode", f"{name}: the residual wrapper was not called twice a "
           "frame (luma; Cb and Cr), each call launching 1 to 3 work "
           f"groups: {calls} calls, {launches[name]['residual_by_group']}")
    if launches[name]["alf_overlapped"] != alf_frames:
      emit(res)
      fail("decode", f"{name}: {launches[name]['alf_overlapped']} alf "
           f"chroma launches overlapped the luma launch for {alf_frames} "
           "frames with ALF on, not one each")
    if launches[name]["sao_overlapped"] != frames["sao"]:
      emit(res)
      fail("decode", f"{name}: {launches[name]['sao_overlapped']} sao "
           f"chroma launches overlapped the luma launch for {frames['sao']} "
           "frames with SAO on, not one each")
    for k, (span, per) in FRAME_SPANS.items():
      if launches[name][k] != per * frames[k] or \
          bool(frames[k]) != (k in PATH_KERNELS[name]):
        emit(res)
        fail("decode", f"{name}: the {k} kernel was launched "
             f"{launches[name][k]} times for {frames[k]} {span} frames, not "
             f"{per} each")
    if launches[name]["dmvr"] != DMVR_LAUNCHES.get(name, 0) or \
        launches[name]["lmcs_scales"]:
      emit(res)
      fail("decode", f"{name}: {launches[name]['dmvr']} dmvr launches (want "
           f"{DMVR_LAUNCHES.get(name, 0)}), {launches[name]['lmcs_scales']} "
           "standalone LMCS chroma scales launches (want 0)")
  emit(res)
  return launches


def _load(name):
  with open(os.path.join(TESTDATA, name)) as f:
    return json.load(f)


def _gen_cases():
  """{"<file>/<case>": (config, committed MD5s, decodes on one session)}
  for every committed case the generate phase decodes: each case of
  GEN_CASE_FILES but GEN_LEFT_OUT's, and ROBUST_PLAIN's whole-stream
  decodes."""
  out = {}
  for stem in GEN_CASE_FILES:
    for case, entry in _load(f"{stem}.md5.json").items():
      if f"{stem}/{case}" not in GEN_LEFT_OUT:
        out[f"{stem}/{case}"] = (entry["config"], [entry["md5"]], 1)
  robust = _load("robustness_cases.md5.json")
  for case, (kw, n) in ROBUST_PLAIN.items():
    out[f"robustness_cases/{case}"] = (kw, robust[case]["md5"][:n], n)
  return out


def _generate(kw):
  """One stream from the port's generator, in a worker process: (its
  bytes, the seconds it took)."""
  from ffmpeg_tpu_torch.encoder import config_from_json, encode_stream

  t0 = time.perf_counter()
  data = encode_stream(config_from_json(kw))[0]
  return data, time.perf_counter() - t0


class Generation:
  """The generate phase's streams, made by the port's generator in
  GEN_WORKERS spawned worker processes from the start of the run, so
  that they overlap the build and the earlier phases: FULL17 first (the
  longest), then the fixtures, largest first, then the cases.  The
  streams come back as bytes and are never written to disk."""

  def __init__(self):
    self.full17 = _load(f"{FULL17}.json")
    self.pool = multiprocessing.get_context("spawn").Pool(GEN_WORKERS)
    configs = {FULL17: self.full17["config"]}
    fixtures = {name: _load(f"{name}.md5.json")["config"]
                for name in FIXTURES}
    for name in sorted(fixtures, key=lambda n: -fixtures[n]["width"]
                       * fixtures[n]["height"] * fixtures[n]["n_frames"]):
      configs[name] = fixtures[name]
    configs.update({k: kw for k, (kw, _, _) in _gen_cases().items()})
    self.jobs = {k: self.pool.apply_async(_generate, (kw,))
                 for k, kw in configs.items()}

  def get(self, key):
    """(bytes, seconds) of one stream, waiting for it; a worker's
    exception is raised here."""
    return self.jobs[key].get(timeout=900)

  def close(self):
    self.pool.terminate()
    self.pool.join()


def _first_difference(a: bytes, b: bytes) -> int:
  return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
              min(len(a), len(b)))


def phase_generate(torch, card, gen):
  """The port's generator on the card's host, its streams through the
  kernels: (1) each committed fixture regenerated from its config equals
  the committed .vvc; (2) every committed case of _gen_cases, generated
  and decoded on the card (a fresh session each, counts zeroed just
  before the first and read just after the last: the "generated" path),
  equals its committed JAX MD5s, every kernel launched on the path and no
  plain version run; (3) FULL17, 17 frames of bench.py FULL_KW, equals
  full1080_17.json's size and sha256 and decodes with fetch=False (its
  own path) and then with the fetch to its committed JAX MD5s, fps of
  each.  Returns the launches of both paths."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  t_phase = time.perf_counter()
  out = {"phase": "generate", "card": card, "workers": GEN_WORKERS,
         "fixtures": {}, "left_out": GEN_LEFT_OUT}
  for name in FIXTURES:
    data, secs = gen.get(name)
    want = _read(name)
    out["fixtures"][name] = {"bytes": len(data), "generate_s": secs,
                             "equal": data == want}
    if data != want:
      emit(out)
      fail("generate", f"{name}: the config "
           f"{_load(f'{name}.md5.json')['config']} gives {len(data)} bytes "
           f"unlike the committed {len(want)}; first differing byte at "
           f"offset {_first_difference(data, want)}")

  cases = _gen_cases()
  bad, frames, gen_s = [], 0, 0.0
  _zero_counts()
  t0 = time.perf_counter()
  for key, (_, want, n) in cases.items():
    data, secs = gen.get(key)
    gen_s += secs
    dec = VVCDecoder(device="cuda")
    got = [[fr.md5() for fr in dec.decode(data)] for _ in range(n)]
    frames += sum(map(len, got))
    if got != want:
      bad.append(key)
  torch.cuda.synchronize()
  decode_s = time.perf_counter() - t0
  launches, plain = {}, {}
  launches["generated"], plain["generated"] = _path_counts()
  out["cases"] = {"n": len(cases), "frames": frames, "generate_s": gen_s,
                  "decode_s": decode_s, "mismatched": bad,
                  "launches": launches["generated"],
                  "plain_runs": plain["generated"]}
  print(f"chip_smoke: generate: {len(cases)} committed cases, {frames} "
        f"frames, generated in {gen_s:.1f} s (worker seconds) and decoded "
        f"on the card in {decode_s:.1f} s; launches on the generated path "
        f"{launches['generated']}; left out: " + "; ".join(
            f"{k} ({why})" for k, why in GEN_LEFT_OUT.items()), flush=True)
  if bad:
    emit(out)
    fail("generate", f"frame MD5s differ from the committed ones: {bad}")

  ref = gen.full17
  data, secs = gen.get(FULL17)
  sha = hashlib.sha256(data).hexdigest()
  out[FULL17] = {"bytes": len(data), "sha256": sha, "generate_s": secs}
  if (len(data), sha) != (ref["bytes"], ref["sha256"]):
    emit(out)
    fail("generate", f"{FULL17}: the config {ref['config']} gives "
         f"{len(data)} bytes, sha256 {sha}, not the committed "
         f"{ref['bytes']}, {ref['sha256']}")
  dec = VVCDecoder(device="cuda")
  _zero_counts()
  t0 = time.perf_counter()
  on_card = list(dec.decode(data, fetch=False))
  torch.cuda.synchronize()
  t_card = time.perf_counter() - t0
  launches[FULL17], plain[FULL17] = _path_counts()
  md5_card = [fr.md5() for fr in on_card]
  del on_card
  t0 = time.perf_counter()
  fetched = list(dec.decode(data))
  t_fetch = time.perf_counter() - t0
  md5_fetch = [fr.md5() for fr in fetched]
  out[FULL17].update({
      "frames": len(md5_card), "fps_on_device": len(md5_card) / t_card,
      "fps_with_fetch": len(fetched) / t_fetch,
      "md5_equal_on_device": md5_card == ref["md5"],
      "md5_equal_with_fetch": md5_fetch == ref["md5"],
      "launches": launches[FULL17], "plain_runs": plain[FULL17]})
  out["seconds"] = time.perf_counter() - t_phase
  emit(out)
  print(f"chip_smoke: generate {FULL17}: {len(md5_card)} frames, "
        f"{out[FULL17]['fps_on_device']:.3f} fps left on the card, "
        f"{out[FULL17]['fps_with_fetch']:.3f} fps with the fetch; generated "
        f"in {secs:.1f} s; on {card}", flush=True)
  for path in ("generated", FULL17):
    if any(plain[path].values()):
      fail("generate", f"{path}: a plain version ran: {plain[path]}")
    never = [k for k in KERNELS if launches[path][k] <= 0]
    if never:
      fail("generate", f"{path}: never launched: {never}")
  if md5_card != ref["md5"] or md5_fetch != ref["md5"]:
    fail("generate", f"{FULL17}: frame MD5s differ from the committed "
         f"ones: on the card {md5_card}, fetched {md5_fetch}")
  return launches


def _hold_card(torch):
  """Keep the card busy for about 50 ms, so that the launches queued
  behind it run back to back and their events time the card, not the
  host's Python (or allocations) between launches."""
  torch.cuda.synchronize()
  torch.cuda._sleep(100_000_000)  # cycles, about 50 ms at 1980 MHz


def _events_ms(fn, torch, reps):
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  _hold_card(torch)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _fps(name, torch, traced=False, host_threads=None):
  """fps with frames left on the card and with the fetch, after a
  warm-up decode, on a session of `host_threads` parse lanes (default
  DecoderConfig's); with traced, also the DMVR round trip and its halves
  per DMVR frame (their trace spans, which hold the search's fetch)."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.utils import trace

  data = _read(name)
  dec = VVCDecoder(device="cuda", host_threads=host_threads)
  list(dec.decode(data))            # warm-up (allocator, caches)
  n_frames = 0
  t0 = time.perf_counter()
  for _ in dec.decode(data, fetch=False):
    n_frames += 1
  torch.cuda.synchronize()
  t_dev = time.perf_counter() - t0
  t0 = time.perf_counter()
  n_fetch = len(list(dec.decode(data)))
  t_fetch = time.perf_counter() - t0
  out = {"frames": n_frames, "fps_on_device": n_frames / t_dev,
         "fps_with_fetch": n_fetch / t_fetch}
  if traced:
    trace.reset()
    trace.enable(True)
    list(dec.decode(data))
    trace.enable(False)
    summary = trace.summary()
    if "dmvr" in summary:
      # the search, its fetch and the host's dmvr_apply, per DMVR frame,
      # and its halves: the search with its fetch, and the apply
      out["dmvr_round_trip_ms_per_dmvr_frame"] = summary["dmvr"]["mean_ms"]
      out["dmvr_frames"] = summary["dmvr"]["n"]
      for k in ("dmvr_search", "dmvr_apply"):
        out[f"{k}_ms_per_dmvr_frame"] = summary[k]["mean_ms"]
  return out


def _op_device_ms(name, torch):
  """Device ms of the DMVR search over a decode of a fixture: each call
  of ops/dmvr.refine_subblocks (the kernel, one launch) is queued behind
  a held card and bracketed by CUDA events, so the events time the
  card's work, not the host's launches.  Returns its calls, ms per call
  and ms per frame."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.ops import dmvr

  times: dict = {}

  def timed(key, fn):
    def run(*a, **kw):
      e0 = torch.cuda.Event(enable_timing=True)
      e1 = torch.cuda.Event(enable_timing=True)
      _hold_card(torch)
      e0.record()
      out = fn(*a, **kw)
      e1.record()
      torch.cuda.synchronize()
      times.setdefault(key, []).append(e0.elapsed_time(e1))
      return out
    return run

  patches = [(dmvr, "refine_subblocks", "dmvr_search")]
  saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
  for mod, attr, key in patches:
    setattr(mod, attr, timed(key, getattr(mod, attr)))
  try:
    n = sum(1 for _ in VVCDecoder(device="cuda").decode(_read(name),
                                                        fetch=False))
    torch.cuda.synchronize()
  finally:
    for mod, attr, fn in saved:
      setattr(mod, attr, fn)
  return {k: {"calls": len(v), "ms_per_call": sum(v) / len(v),
              "ms_per_frame": sum(v) / n} for k, v in times.items()}


def _sm_clocks():
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
  return smi.stdout.strip()


def _recon_runs(kw, want, torch, reps):
  """reps launches of the recon kernel on one call's inputs, queued
  behind _hold_card and timed with CUDA events: per launch the whole
  wrapper's card time (plane fill, map zeroing, both launches), and
  apart its placement and
  wavefront launches (the wrapper's mark hook records an event before
  each).  Every output is then held against `want`, the plain version's:
  the wavefront's order differs from launch to launch, so a missing wait
  shows as a mismatch.  Returns (ms per launch, placement ms, wavefront
  ms, launches that differ)."""
  from ffmpeg_tpu_torch.ops.recon import _recon_cuda

  ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for _ in range(reps)]
  outs = []
  _hold_card(torch)
  for e in ev:
    e[0].record()
    outs.append(_recon_cuda(**kw, mark=lambda st, e=e: e[1 + st].record()))
    e[3].record()
  torch.cuda.synchronize()
  total = ev[0][0].elapsed_time(ev[-1][3]) / reps
  place = sum(e[1].elapsed_time(e[2]) for e in ev) / reps
  wave = sum(e[2].elapsed_time(e[3]) for e in ev) / reps
  return total, place, wave, sum(not torch.equal(o, want) for o in outs)


def _inter_runs(kw, want, torch, reps):
  """reps calls of the inter kernel on one call's inputs, queued behind
  _hold_card and timed with CUDA events: per call the whole wrapper's
  card time, and apart its small and large launches (the wrapper's mark
  hook records an event before each).  Every output is held against
  `want`, the plain version's.  Returns (ms per call, small ms, large ms,
  calls that differ)."""
  from ffmpeg_tpu_torch.ops.inter import _inter_cuda

  ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for _ in range(reps)]
  outs = []
  _hold_card(torch)
  for e in ev:
    e[0].record()
    outs.append(_inter_cuda(**kw, mark=lambda cls, e=e: e[1 + cls].record()))
    e[3].record()
  torch.cuda.synchronize()
  total = ev[0][0].elapsed_time(ev[-1][3]) / reps
  small = sum(e[1].elapsed_time(e[2]) for e in ev) / reps
  large = sum(e[2].elapsed_time(e[3]) for e in ev) / reps
  return total, small, large, sum(not torch.equal(o, want) for o in outs)


def _host_ms(fn, torch, reps, held):
  """Host ms per call of fn: with held, the calls queue behind
  _hold_card, so they time the host work of enqueueing alone; without,
  each call is followed by a synchronize, which adds the card's time."""
  if held:
    _hold_card(torch)
  else:
    torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
    if not held:
      torch.cuda.synchronize()
  t = time.perf_counter() - t0
  torch.cuda.synchronize()
  return t * 1e3 / reps


def _time_inter(kw, torch, reps, rounds):
  """One inter call: ms per call (mean of `rounds` rounds of `reps`
  calls), its small and large launches apart, the units of each class,
  the wrapper's host ms per call (card held, and synced), and the calls
  that differ from the plain version."""
  from ffmpeg_tpu_torch.ops.inter import inter_pred

  want = _plain("inter_pred", kw)
  runs = [_inter_runs(kw, want, torch, reps) for _ in range(rounds)]
  return {"ms": sum(r[0] for r in runs) / rounds,
          "small_ms": sum(r[1] for r in runs) / rounds,
          "large_ms": sum(r[2] for r in runs) / rounds,
          "small_units": len(kw["inter"]["small_host"]),
          "large_units": len(kw["inter"]["large_host"]),
          "host_ms_per_call_card_held": _host_ms(
              lambda: inter_pred(**kw), torch, reps, True),
          "wall_ms_per_call_synced": _host_ms(
              lambda: inter_pred(**kw), torch, reps, False),
          "calls_checked": reps * rounds,
          "calls_unequal": sum(r[3] for r in runs)}


def _whole_call_runs(name, kw, want, torch, reps):
  """reps calls of a one-launch wrapper (deblock, alf, sao, lmcs_inv,
  dmvr) on one call's inputs, queued
  behind _hold_card and timed with CUDA events: the launch is the whole
  call (the output is a fresh tensor, no copy).  Every output is held
  against `want`, the plain version's (deblock's shared-memory atomics'
  order differs between launches).  Returns (ms per call, calls that
  differ)."""
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  outs = []
  _hold_card(torch)
  start.record()
  for _ in range(reps):
    outs.append(_kernel(name, kw))
  end.record()
  torch.cuda.synchronize()
  return (start.elapsed_time(end) / reps,
          sum(not torch.equal(o, want) for o in outs))


def _time_whole_call(name, kw, torch, reps, rounds):
  """One call of a one-launch wrapper: ms per call (mean of `rounds` rounds of
  `reps` calls), and the calls that differ from the plain version."""
  want = _plain(name, kw)
  runs = [_whole_call_runs(name, kw, want, torch, reps)
          for _ in range(rounds)]
  return {"ms": sum(r[0] for r in runs) / rounds,
          "calls_checked": reps * rounds,
          "calls_unequal": sum(r[1] for r in runs)}


def _residual_runs(kw, want, torch, reps):
  """reps calls of the residual kernel on one call's inputs, queued
  behind _hold_card and timed with CUDA events, twice: as the wrapper
  runs them (the fill of the fresh planes, then the work groups'
  launches, each free to start while the one before runs), per call;
  then with the wrapper's mark hook recording an event before each group,
  which runs each group alone, after the one before: the fill, each
  group, and their sum.  Every output is held against `want`, the plain
  version's, and the error word, read after the last call, must stay 0.
  Returns (ms per call, fill ms, ms per group, their sum, calls that
  differ or set the error word)."""
  from ffmpeg_tpu_torch.ops.transform import (GROUPS, _classes,
                                              _residual_launch, error_word)

  dev, classes = _classes(**kw)
  args = {k: kw[k] for k in ("Hp", "Wp", "bit_depth", "chroma",
                             "scale_src", "sl")}
  err = error_word(dev)
  n = len(GROUPS)

  def run(marked):
    # the unmarked run's calls go back to back between its first and its
    # last event, as the frame program queues them
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(n + 2)]
          for _ in range(reps)]
    _hold_card(torch)
    outs = []
    for i, e in enumerate(ev):
      if marked or i == 0:
        e[0].record()
      outs.append(_residual_launch(
          dev, classes, nch=len(kw["buckets"]), err=err,
          mark=(lambda g, e=e: e[1 + g].record()) if marked else None,
          **args))
      if marked or i == reps - 1:
        e[n + 1].record()
    torch.cuda.synchronize()
    return ev, outs

  ev, outs = run(False)
  total = ev[0][0].elapsed_time(ev[-1][n + 1]) / reps
  ev, marked = run(True)
  fill = sum(e[0].elapsed_time(e[1]) for e in ev) / reps
  groups = {g: sum(e[1 + i].elapsed_time(e[2 + i]) for e in ev) / reps
            for i, g in enumerate(GROUPS)}
  serial = ev[0][0].elapsed_time(ev[-1][n + 1]) / reps
  bad = sum(not torch.equal(p, want) for p in outs + marked)
  return total, fill, groups, serial, bad + (reps if int(err.item()) else 0)


def _time_residual(kw, torch, reps, rounds):
  """One residual call: ms per call (mean of `rounds` rounds of `reps`
  calls), the fill and each work group's launch apart (each run alone:
  serial_ms their sum with the fill), each group's
  classes, TUs, blocks (items: a packed group's blocks of TUs, or the
  large group's bands), dynamic shared bytes and resident blocks per SM,
  the calls that differ from the plain version, and the wrapper's host
  ms per call: queued behind a held card (the checks, the work split and
  the launches: the wrapper reads nothing back), and synced after each
  call (with the card's time)."""
  from ffmpeg_tpu_torch.ops.transform import (GROUPS, _classes, error_word,
                                              launch_plan, residual_planes)

  want = _plain("residual", kw)
  runs = [_residual_runs(kw, want, torch, reps) for _ in range(rounds)]
  dev, classes = _classes(**kw)
  plan = launch_plan(classes, kw["scale_src"] is not None)
  call = dict(kw, err=error_word(dev))
  return {"ms": sum(r[0] for r in runs) / rounds,
          "fill_ms": sum(r[1] for r in runs) / rounds,
          "group_ms": {g: sum(r[2][g] for r in runs) / rounds
                       for g in GROUPS},
          "serial_ms": sum(r[3] for r in runs) / rounds,
          "groups": {g: {k: grp.get(k) for k in (
              "items", "tus", "smem", "blocks_per_sm")} | {
              "classes": len(grp["classes"])}
              for g, grp in zip(GROUPS, plan)},
          "tus": sum(int(c[wh]["n"]) for c in kw["buckets"]
                     for wh in kw["sizes"]),
          "host_ms_per_call_card_held": _host_ms(
              lambda: residual_planes(**call), torch, reps, True),
          "wall_ms_per_call_synced": _host_ms(
              lambda: residual_planes(**call), torch, reps, False),
          "calls_checked": 2 * reps * rounds,
          "calls_unequal": sum(r[4] for r in runs)}


def _print_residual(tag, label, r, plain_ms=None):
  """One residual call's timing line: ms per call, the fill and each
  work group apart with its TUs, blocks, shared bytes and blocks per SM,
  and the wrapper's host ms per call."""
  groups = ", ".join(
      f"{g} {r['group_ms'][g]} ms ({d['tus']} TUs, {d['items']} blocks, "
      f"{d['smem']} B shared, {d['blocks_per_sm']} blocks/SM)"
      for g, d in r["groups"].items() if d["items"])
  print(f"chip_smoke: timing {tag} residual {label}: {r['ms']} ms per call"
        + ("" if plain_ms is None else f" (plain {plain_ms})")
        + f"; each group alone: fill {r['fill_ms']} ms, {groups}, in all "
        f"{r['serial_ms']} ms; wrapper host ms per call "
        f"{r['host_ms_per_call_card_held']} card held, "
        f"{r['wall_ms_per_call_synced']} synced", flush=True)


def _time_call(name, label, kw, levels, torch, reps, rounds):
  """One kernel call timed by its kernel's own helper."""
  if name == "recon":
    return _time_recon(kw, levels[label], torch, reps, rounds)
  if name == "residual":
    return _time_residual(kw, torch, reps, rounds)
  if name == "alf":
    return _time_alf(kw, torch, reps, rounds)
  if name == "sao":
    return _time_sao(kw, torch, reps, rounds)
  if name == "inter_pred":
    return _time_inter(kw, torch, reps, rounds)
  return _time_whole_call(name, kw, torch, reps, rounds)


def _alf_registers():
  """The alf kernels' registers per thread, as ptxas printed them when
  phase_build built them (None when the library was not built in this
  run)."""
  from ffmpeg_tpu_torch.utils.build import BUILD_LOG

  out = {"luma": None, "chroma": None}
  for fn, lines in _ptxas(BUILD_LOG.get("alf", {}).get("ptxas", [])).items():
    for ln in lines:
      m = re.search(r"Used (\d+) registers", ln)
      if m:
        out["chroma" if "chroma" in fn else "luma"] = int(m.group(1))
  return out


def _time_alf(kw, torch, reps, rounds):
  """One alf call alone (_time_whole_call) and its launch: the persistent
  grid's blocks, resident blocks per SM, tiles and tiles per block, shared
  bytes, threads and registers."""
  from ffmpeg_tpu_torch.ops.alf import launch_plan

  r = _time_whole_call("alf", kw, torch, reps, rounds)
  r["launch"] = launch_plan(chroma=kw["chroma"], W=kw["W"], H=kw["H"])
  r["launch"]["registers"] = _alf_registers()[
      "chroma" if kw["chroma"] else "luma"]
  return r


def _time_sao(kw, torch, reps, rounds):
  """One sao call alone (_time_whole_call) and its launch: the persistent
  grid's blocks, resident blocks per SM, tiles and tiles per block,
  shared bytes and threads."""
  from ffmpeg_tpu_torch.ops.sao import launch_plan

  r = _time_whole_call("sao", kw, torch, reps, rounds)
  r["launch"] = launch_plan(len(kw["planes"]), *kw["planes"][0].shape)
  return r


def _time_pair(kernel, calls, torch, reps, rounds):
  """A frame's two calls of `kernel` (alf or sao) as the frame program
  queues them: luma, then Cb and Cr, whose launch may start while the
  luma launch runs (the overlap).  ms per pair (mean of `rounds` rounds
  of `reps` pairs queued behind a held card, CUDA events), each output
  held against the plain version.  None on a frame without the filter."""
  kws = [kw for name, _, kw in calls if name == kernel]
  if len(kws) != 2:
    return None
  want = [_plain(kernel, kw) for kw in kws]
  kws[1] = dict(kws[1], overlap=True)
  ms, bad = 0.0, 0
  for _ in range(rounds):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    outs = []
    _hold_card(torch)
    start.record()
    for _ in range(reps):
      outs += [_kernel(kernel, kw) for kw in kws]
    end.record()
    torch.cuda.synchronize()
    ms += start.elapsed_time(end) / reps / rounds
    bad += sum(not torch.equal(o, want[i % 2]) for i, o in enumerate(outs))
  return {"ms": ms, "calls_checked": 2 * reps * rounds, "calls_unequal": bad}


def _print_sao(tag, sao, pair, plain_ms):
  """The sao calls' timing lines: ms per call alone with its launch, and
  the overlapped pair's ms per frame."""
  for label, r in sao.items():
    g = r["launch"]
    print(f"chip_smoke: timing {tag} sao {label}: {r['ms']} ms per call "
          f"(plain {plain_ms.get(f'sao/{label}')}); grid {g['blocks']} "
          f"blocks of {g['threads']} threads ({g['blocks_per_sm']} resident "
          f"per SM x {g['sms']} SMs), {g['tiles']} tiles of "
          f"{g['tile'][0]}x{g['tile'][1]} ({g['tiles_per_block']} per "
          f"block), {g['smem']} B shared", flush=True)
  if pair is not None:
    print(f"chip_smoke: timing {tag} sao pair (luma, then Cb and Cr "
          f"overlapping it): {pair['ms']} ms per frame, against "
          f"{sum(r['ms'] for r in sao.values())} for the calls alone",
          flush=True)


def _print_alf(tag, alf, pair, plain_ms):
  """The alf calls' timing lines: ms per call alone with its launch, and
  the overlapped pair's ms per frame."""
  for label, r in alf.items():
    g = r["launch"]
    print(f"chip_smoke: timing {tag} alf {label}: {r['ms']} ms per call "
          f"(plain {plain_ms.get(f'alf/{label}')}); grid {g['blocks']} "
          f"blocks of {g['threads']} threads ({g['blocks_per_sm']} resident "
          f"per SM x {g['sms']} SMs), {g['tiles']} tiles of "
          f"{g['tile'][0]}x{g['tile'][1]} ({g['tiles_per_block']} per "
          f"block), {g['smem']} B shared, {g['registers']} registers",
          flush=True)
  if pair is not None:
    print(f"chip_smoke: timing {tag} alf pair (luma, then Cb and Cr "
          f"overlapping it): {pair['ms']} ms per frame, against "
          f"{sum(r['ms'] for r in alf.values())} for the calls alone",
          flush=True)


def _time_recon(kw, levels, torch, reps, rounds):
  """One recon call: ms per launch (mean of `rounds` rounds of `reps`
  launches), placement and wavefront ms, us per dependency level of the
  wavefront, and the launches that differ from the plain version."""
  want = _plain("recon", kw)
  runs = [_recon_runs(kw, want, torch, reps) for _ in range(rounds)]
  wave = sum(r[2] for r in runs) / rounds
  return {"ms": sum(r[0] for r in runs) / rounds,
          "placement_ms": sum(r[1] for r in runs) / rounds,
          "wavefront_ms": wave, "levels": levels,
          "us_per_level": wave * 1e3 / max(levels, 1),
          "launches_checked": reps * rounds,
          "launches_unequal": sum(r[3] for r in runs)}


def phase_timing(torch, card, calls, levels):
  """fps of full1080 (with traced stages) and ai720, and the device ms of
  the DMVR search on full1080; then each kernel against its
  plain version on the full1080 B frame's calls, in turns
  (plain, kernel, kernel, plain; recon's kernel launches each checked
  against the plain version), and the recon kernel alone on ai720's
  frame 0, checked the same way.  The SM clocks are read before and
  after."""
  out = {"phase": "timing", "card": card, "sm_clocks_before": _sm_clocks(),
         MAIN: _fps(MAIN, torch, traced=True),
         "ai720": _fps("ai720", torch), CTU128: _fps(CTU128, torch)}
  # the session option host_threads (the parse pool's width), each width
  # twice, in the order 1, 4, 8, 8, 4, 1
  sweep: dict = {}
  for ht in (1, 4, 8, 8, 4, 1):
    sweep.setdefault(ht, []).append(_fps(MAIN, torch, host_threads=ht))
  out["host_threads"] = {"cpu_count": os.cpu_count(), "fixture": MAIN,
                         **sweep}
  print(f"chip_smoke: timing {MAIN} fps on the card at host_threads "
        + ", ".join(f"{ht}: {[r['fps_on_device'] for r in rr]}"
                    for ht, rr in sweep.items())
        + f" ({os.cpu_count()} CPUs)", flush=True)
  m = out[MAIN]
  print(f"chip_smoke: timing {MAIN} dmvr round trip per DMVR frame "
        f"(traced, {m['dmvr_frames']} frames): "
        f"{m['dmvr_round_trip_ms_per_dmvr_frame']} ms, dmvr_search "
        f"{m['dmvr_search_ms_per_dmvr_frame']} ms, dmvr_apply "
        f"{m['dmvr_apply_ms_per_dmvr_frame']} ms", flush=True)
  out["op_device_ms"] = _op_device_ms(MAIN, torch)
  kern, plain, recon, inter = {}, {}, {MAIN: {}, "ai720": {}}, {}
  deblock, alf, residual, dmvr = {}, {}, {}, {}
  filt = {k: {} for k in FILTERS}
  per = {"recon": recon[MAIN], "deblock": deblock, "alf": alf,
         "residual": residual, "inter_pred": inter, "dmvr": dmvr, **filt}
  for name, label, kw in calls[MAIN]:
    p1 = _events_ms(lambda: _plain(name, kw), torch, 1)
    r = _time_call(name, label, kw, levels[MAIN], torch, 20, 2)
    per[name][label] = r
    kern[f"{name}/{label}"] = r["ms"]
    p2 = _events_ms(lambda: _plain(name, kw), torch, 1)
    plain[f"{name}/{label}"] = (p1 + p2) / 2
  print(f"chip_smoke: timing {MAIN} deblock ms per launch: " + ", ".join(
      f"{label} {r['ms']} (plain {plain[f'deblock/{label}']})"
      for label, r in deblock.items()), flush=True)
  print(f"chip_smoke: timing {MAIN} ms per call: " + ", ".join(
      f"{name} {label} {r['ms']} (plain {plain[f'{name}/{label}']})"
      for name, rr in filt.items() for label, r in rr.items()), flush=True)
  bound = _bound("dmvr", calls[MAIN])
  for label, r in dmvr.items():
    kw = next(kw for n, _, kw in calls[MAIN] if n == "dmvr")
    print(f"chip_smoke: timing {MAIN} dmvr {label}: {r['ms']} ms per call "
          f"(plain {plain[f'dmvr/{label}']}), bound {bound['bound_ms']} ms "
          f"({bound['bound_by']}), {kw['ctrl'].shape[1]} subblocks",
          flush=True)
  alf_pair = {MAIN: _time_pair("alf", calls[MAIN], torch, 20, 2)}
  _print_alf(MAIN, alf, alf_pair[MAIN], plain)
  sao_pair = {MAIN: _time_pair("sao", calls[MAIN], torch, 20, 2)}
  _print_sao(MAIN, filt["sao"], sao_pair[MAIN], plain)
  for label, r in residual.items():
    _print_residual(MAIN, label, r, plain[f"residual/{label}"])
  for name, label, kw in calls["ai720"]:
    if name == "recon":
      recon["ai720"][label] = _time_recon(kw, levels["ai720"][label], torch,
                                          20, 1)
  # the coding-tool frames: the recon kernel's 64-edge wavefront at cell 1
  # (ctu128_1080's I frame), its B frame, the CIIP-64 frame; both kernels,
  # each call also through its plain version once
  tools = {}
  for key in TOOL_FRAMES:
    t = tools[key] = {**{k: {} for k in KERNELS}, "plain_ms": {}}
    for name, label, kw in calls[key]:
      t[name][label] = _time_call(name, label, kw, levels[key], torch, 20, 1)
      t["plain_ms"][f"{name}/{label}"] = _events_ms(
          lambda: _plain(name, kw), torch, 1)
    print(f"chip_smoke: timing {key}: " + ", ".join(
        f"recon {label} {r['ms']} ms ({r['levels']} levels, "
        f"{r['us_per_level']} us per level)"
        for label, r in t["recon"].items()) + "".join(
        f", {name} {label} {r['ms']} ms"
        for name in KERNELS if name != "recon"
        for label, r in t[name].items()), flush=True)
    alf_pair[key] = t["alf_pair"] = _time_pair("alf", calls[key], torch, 20,
                                               1)
    if t["alf"]:
      _print_alf(key, t["alf"], alf_pair[key], t["plain_ms"])
    sao_pair[key] = t["sao_pair"] = _time_pair("sao", calls[key], torch, 20,
                                               1)
    if t["sao"]:
      _print_sao(key, t["sao"], sao_pair[key], t["plain_ms"])
    for label, r in t["residual"].items():
      _print_residual(key, label, r, t["plain_ms"][f"residual/{label}"])
  out["coding_tools"] = tools
  out["kernel_ms"], out["plain_ms"] = kern, plain
  out["inter"], out["recon"], out["deblock"] = inter, recon, deblock
  out["alf"], out["alf_pair"], out["residual"] = alf, alf_pair, residual
  out["sao_pair"] = sao_pair
  out["sao_lmcs"], out["dmvr"] = filt, dmvr
  out["ai720_frame0_kernel_ms"] = {f"recon/{label}": r["ms"]
                                   for label, r in recon["ai720"].items()}
  out["sm_clocks_after"] = _sm_clocks()
  emit(out)
  bad = {f"recon {f} {label}": r["launches_unequal"]
         for f, rr in recon.items() for label, r in rr.items()
         if r["launches_unequal"]}
  for name, rr in (("inter_pred", inter), ("deblock", deblock),
                   ("alf", alf), ("residual", residual), ("dmvr", dmvr),
                   *filt.items()):
    bad.update({f"{name} {label}": r["calls_unequal"]
                for label, r in rr.items() if r["calls_unequal"]})
  for key, t in tools.items():
    bad.update({f"recon {key} {label}": r["launches_unequal"]
                for label, r in t["recon"].items() if r["launches_unequal"]})
    for name in KERNELS:
      if name == "recon":
        continue
      bad.update({f"{name} {key} {label}": r["calls_unequal"]
                  for label, r in t[name].items() if r["calls_unequal"]})
  for name, pairs in (("alf", alf_pair), ("sao", sao_pair)):
    bad.update({f"{name} pair {key}": r["calls_unequal"]
                for key, r in pairs.items() if r and r["calls_unequal"]})
  if bad:
    fail("timing", f"launches unequal to the plain version: {bad}")
  return (kern, plain, recon, inter, deblock, alf, alf_pair, residual, filt,
          sao_pair, dmvr, tools)


def _union_us(work):
  """The length of the union of sorted (start, end, ...) intervals."""
  busy, end = 0.0, float("-inf")
  for s0, s1, *_ in work:
    if s1 > end:
      busy += s1 - max(s0, end)
      end = s1
  return busy


def phase_profile(torch, card):
  """torch.profiler over a warm full1080 decode (frames left on the card).
  Device busy share = union of the kernels' and copies' device time over
  the profiled window; device time by kernel name, and by stage: the
  trace spans run as profiler ranges, which the profiler also marks on
  the device timeline, and a stage's device time is that of the device
  events inside its marks (one stream, so the stages' marks do not
  overlap; this counts the CUDA kernels launched through ctypes too)."""
  import bisect

  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.utils import trace

  data = _read(MAIN)
  dec = VVCDecoder(device="cuda")
  list(dec.decode(data, fetch=False))
  torch.cuda.synchronize()
  trace.PROFILE_RANGES = True
  try:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      n = sum(1 for _ in dec.decode(data, fetch=False))
      torch.cuda.synchronize()
  finally:
    trace.PROFILE_RANGES = False
  events = list(prof.events())
  on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
  marks = [e for e in on_dev if e.name.startswith("stage/")]
  work = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in on_dev if not e.name.startswith("stage/"))
  starts = [w[0] for w in work]
  by_stage: dict = {}
  for m in marks:
    i = bisect.bisect_left(starts, m.time_range.start)
    t = 0.0
    while i < len(work) and work[i][0] < m.time_range.end:
      t += max(0.0, min(work[i][1], m.time_range.end) - work[i][0])
      i += 1
    by_stage[m.name[6:]] = by_stage.get(m.name[6:], 0.0) + t
  lo = min(e.time_range.start for e in events)
  hi = max(e.time_range.end for e in events)
  busy = _union_us(work)
  by_name: dict = {}
  for s0, s1, name in work:
    by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
  # the chroma scales run inside the chroma residual launches: no device
  # event of a standalone scales kernel
  scales = [k for k in by_name if "lmcs_scales" in k]
  if scales:
    fail("profile", f"standalone LMCS chroma scales kernels ran: {scales}")
  emit({"phase": "profile", "card": card, "fixture": MAIN, "frames": n,
        "window_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / max(hi - lo, 1e-9),
        "device_events": len(work), "stage_marks": len(marks),
        "device_ms_per_frame_by_stage": {k: v / 1e3 / n
                                         for k, v in sorted(by_stage.items())},
        "device_ms_per_frame_by_kernel": {k[:80]: v / 1e3 / n
                                          for k, v in top}})


def _wave_check(out, fixture, torch):
  """A call hook for the wave path that holds each kernel call against
  its plain version on the same card tensors, on the frame's own stream
  while other streams' frames are in flight; recon launched 3 times
  (the race check).  Records each call in out["cases"]."""
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS

  def check(name, label, kw):
    kernel, plain = KERNELS[name]
    want = plain(**kw)
    for _ in range(3 if name == "recon" else 1):
      got = kernel(**kw)
      equal = torch.equal(got, want)
      err = int((got - want).abs().max().item()) if got.numel() else 0
      out["cases"].append({"fixture": fixture, "kernel": name,
                           "plane": label, "equal": equal,
                           "max_abs_err": err})
      if not equal:
        emit(out)
        fail("parallel", f"{fixture} wave path {name} {label}: kernel != "
             f"plain (max err {err})")
    return got
  return check


def _device_window(fn, torch):
  """torch.profiler over fn(): the card's busy ms (the union of its
  kernels' and copies' intervals), the sum of their ms (above the busy
  ms where streams ran at once), their ratio, the idle share of the
  window, the caching allocator's new device segments (cudaMalloc
  calls) during fn, and the device events of a standalone LMCS chroma
  scales kernel (none is left)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  segments = torch.cuda.memory_stats()["segment.all.allocated"]
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  segments = torch.cuda.memory_stats()["segment.all.allocated"] - segments
  events = list(prof.events())
  work = sorted((e.time_range.start, e.time_range.end) for e in events
                if e.device_type == DeviceType.CUDA
                and not e.name.startswith("stage/"))
  lo = min(e.time_range.start for e in events)
  hi = max(e.time_range.end for e in events)
  busy = _union_us(work)
  total = sum(w[1] - w[0] for w in work)
  return {"window_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
          "device_ms_sum": total / 1e3, "allocator_segments_new": segments,
          "concurrency": total / max(busy, 1e-9),
          "device_idle_share": 1 - busy / max(hi - lo, 1e-9),
          "lmcs_scales_events": sum(
              e.device_type == DeviceType.CUDA and "lmcs_scales" in e.name
              for e in events)}


def _tiled_filters(torch):
  """The band-split filter ops (parallel/spatial.py) at 1920x1088 in
  T = 4 row bands on cuda:0, each equal to the whole-plane op on the same
  seeded inputs (tolerance 0): deblock's luma vertical pass (the deblock
  kernel on the whole plane, and once on each band), SAO and ALF luma
  (the sao and alf kernels on the whole plane, there equal to their
  plain versions, and once on each band); the card ms of each, whole and
  split (CUDA events, mean of 5 calls queued behind a held card)."""
  import numpy as np

  from ffmpeg_tpu_torch.ops import alf as A
  from ffmpeg_tpu_torch.ops import deblock
  from ffmpeg_tpu_torch.ops import sao as TS
  from ffmpeg_tpu_torch.parallel import spatial
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh

  mesh = make_mesh(devices=["cuda:0"] * 4, frame_axis=1)
  rng = np.random.default_rng(77)

  def t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to("cuda:0")

  Hp, Wp, H, ctb, bd = 1088, 1920, 1080, 64, 8
  plane = t(rng.integers(0, 256, (Hp, Wp), dtype=np.int32))
  S, E = Hp // 4, Wp // 4
  bs = rng.integers(0, 3, (S, E), dtype=np.int32)
  bs[:, 0] = 0
  db = [t(a) for a in (bs, rng.integers(18, 45, (S, E), dtype=np.int32),
                       rng.choice([1, 3, 7], (S, E)).astype(np.int32),
                       rng.choice([1, 3, 7], (S, E)).astype(np.int32),
                       np.zeros((S, E), np.int32))]
  dkw = dict(bit_depth=bd, beta_off=2, tc_off=-2)
  cbh, cbw = -(-Hp // ctb), Wp // ctb
  sao = [t(rng.integers(0, 3, (cbh, cbw), dtype=np.int32)),
         t(rng.integers(0, 28, (cbh, cbw), dtype=np.int32)),
         t(rng.integers(-12, 13, (cbh, cbw, 5), dtype=np.int32)),
         t(rng.integers(0, 4, (cbh, cbw), dtype=np.int32))]
  ly0 = plane[:H].contiguous()
  nby = -(-H // ctb)
  bank = t(rng.integers(0, 16, (nby, cbw), dtype=np.int32))
  flag = t(rng.integers(0, 2, (nby, cbw), dtype=np.int32))
  bco = t(rng.integers(-32, 33, (16, 25, 12), dtype=np.int32))
  bcl = t(rng.choice([256, 32, 8, 2], (16, 25, 12)).astype(np.int32))
  tree = {"ctb": torch.stack([flag, bank] + [torch.zeros_like(flag)] * 6,
                             -1).to(torch.int8).contiguous(),
          "banks_coeff": bco.to(torch.int16),
          "banks_clipv": bcl.to(torch.int16)}

  def alf_whole():
    return A.alf_planes([ly0], tree, chroma=False, W=Wp, H=H, ctb_log2=6,
                        bit_depth=bd)[0]

  def alf_plain():
    return A.alf_planes_plain([ly0], tree, chroma=False, W=Wp, H=H,
                              ctb_log2=6, bit_depth=bd)[0]

  ops = {
      "deblock_luma_vertical": (
          lambda: deblock.deblock_pass(
              [plane], [tuple(db)], chroma=False, horizontal=False,
              bit_depth=bd, beta_off=(2,), tc_off=(-2,))[0],
          lambda: spatial.deblock_vertical_tiled(plane, *db, mesh=mesh,
                                                 **dkw)),
      "sao": (
          lambda: TS.sao_plane(plane, *sao, Wp, H, ctb=ctb, bit_depth=bd),
          lambda: spatial.sao_plane_tiled(plane, *sao, Wp, H, ctb=ctb,
                                          bit_depth=bd, mesh=mesh)),
      "alf_luma": (
          alf_whole,
          lambda: spatial.alf_luma_tiled(ly0, bank, flag, bco, bcl, ctb=ctb,
                                         bit_depth=bd, mesh=mesh)),
  }
  res = {}
  for name, (whole, tiled) in ops.items():
    want = whole()
    kernel = {"deblock_luma_vertical": (deblock, "deblock"),
              "sao": (TS, "sao"), "alf_luma": (A, "alf")}[name]
    n = kernel[0].LAUNCHES[kernel[1]]
    equal = torch.equal(want, tiled())
    n = kernel[0].LAUNCHES[kernel[1]] - n
    res[name] = {"equal": equal, "whole_ms": _events_ms(whole, torch, 5),
                 "tiled_ms": _events_ms(tiled, torch, 5)}
    if not equal:
      fail("parallel", f"tiled {name} != the whole-plane op")
    if name in ("alf_luma", "sao"):
      res[name]["whole_equals_plain"] = torch.equal(
          want, alf_plain() if name == "alf_luma" else TS.sao_rows_plain(
              plane, *sao, Wp, H, ctb=ctb, bit_depth=bd))
      if not res[name]["whole_equals_plain"]:
        fail("parallel", f"the {kernel[1]} kernel on the whole 1080p plane "
             "!= its plain version")
    res[name]["band_launches"] = n
    if n != 4:
      fail("parallel", f"the band-split {kernel[1]} launched the kernel "
           f"{n} times, not once per band")
  return {"shape": [Hp, Wp], "bands": 4, "ctb": ctb, "tolerance": 0,
          "ops": res}


def _mp4_cli():
  """tools/decode.py, the user's CLI on its default device (cuda), on an
  MP4 that the port's own muxer made from ra1080.vvc: the annex-B
  fixture's MD5s."""
  import contextlib
  import io

  from ffmpeg_tpu_torch.formats.isobmff import annexb_to_mp4
  from ffmpeg_tpu_torch.tools.decode import main
  from ffmpeg_tpu_torch.utils.build import BUILD_DIR

  path = os.path.join(BUILD_DIR, "ra1080.mp4")
  with open(path, "wb") as f:
    f.write(annexb_to_mp4(_read("ra1080")))
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    rc = main([path, "--strict"])
  got = [ln.split(", ")[-1] for ln in buf.getvalue().splitlines()]
  with open(os.path.join(TESTDATA, "ra1080.md5.json")) as f:
    want = json.load(f)["md5"]
  if rc != 0 or got != want:
    fail("parallel", f"MP4 CLI decode of ra1080: rc {rc}, MD5s {got} != "
         f"{want}")
  return {"fixture": "ra1080", "mp4_bytes": os.path.getsize(path),
          "frames": len(got), "md5_equal": True}


def phase_parallel(torch, card):
  """The wave path (parallel/gop.py decode_gop_mesh) on ra1080 and gop720
  at stream widths 1, 2 and 4, one card: each width's MD5s equal the
  committed JAX MD5s, counts zeroed just before each run and read just
  after (every kernel of the path launched, no plain version run); every
  kernel call of a width-4 run against its plain version; fps per width
  (measure_scaling, widths 1, 2, 4 and then 4, 2, 1), the card's busy
  ms, stream concurrency and new allocator segments of the
  waves at widths 1 and 4 (profiler); full1080 (DMVR) refused; the
  band-split filters; the MP4 CLI.  Returns each wave path's launches."""
  from ffmpeg_tpu_torch.parallel import gop
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh

  mesh = make_mesh(1, frame_axis=1)
  out = {"phase": "parallel", "card": card, "fixtures": {}, "cases": []}
  launches = {}
  for name in GOP_FIXTURES:
    data = _read(name)
    with open(os.path.join(TESTDATA, f"{name}.md5.json")) as f:
      want = json.load(f)["md5"]
    frames, inputs = gop._prepare(data, mesh)
    waves = [[frames[i].poc for i in w] for w in gop.plan_waves(frames)]
    print(f"chip_smoke: parallel {name}: waves (POC) {waves}", flush=True)
    rec = out["fixtures"][name] = {"waves": waves, "widths": {}}
    for width in GOP_WIDTHS:
      _zero_counts()
      got = [m for _, m, _ in gop.decode_gop_mesh(data, mesh, streams=width)]
      counts = _counts()
      key = f"gop:{name}:w{width}"
      launches[key] = {k: m.LAUNCHES[k] for k, m in counts.items()}
      launches[key]["alf_overlapped"] = counts["alf"].OVERLAPS["alf"]
      launches[key]["sao_overlapped"] = counts["sao"].OVERLAPS["sao"]
      launches[key]["lmcs_scales"] = _lmcs_scales_launches()
      plain = {k: m.PLAIN_RUNS[k] for k, m in counts.items()}
      rec["widths"][width] = {"md5_equal": got == want,
                              "launches": launches[key],
                              "plain_runs": plain}
      if got != want or any(plain.values()) or launches[key][
          "lmcs_scales"] or not all(
          launches[key][k] > 0 for k in PATH_KERNELS[name]) or \
          2 * launches[key]["alf_overlapped"] != launches[key]["alf"] or \
          2 * launches[key]["sao_overlapped"] != launches[key]["sao"]:
        emit(out)
        fail("parallel", f"{key}: MD5s equal {got == want}, launches "
             f"{launches[key]}, plain runs {plain}")
    got = gop.decode_gop_mesh(data, mesh, streams=max(GOP_WIDTHS),
                              call=_wave_check(out, name, torch))
    if [m for _, m, _ in got] != want:
      emit(out)
      fail("parallel", f"{name}: the checked wave run's MD5s differ")
    rec["residual_calls_checked"] = sum(
        c["fixture"] == name and c["kernel"] == "residual"
        for c in out["cases"])
    if rec["residual_calls_checked"] != 2 * len(got):
      emit(out)
      fail("parallel", f"{name}: {rec['residual_calls_checked']} residual "
           f"calls held for {len(got)} frames, not 2 a frame")
    # fps per width, in the order 1, 2, 4, then 4, 2, 1
    rec["scaling"] = [gop.measure_scaling(data, order, reps=2, mesh=mesh)
                      for order in (GOP_WIDTHS, GOP_WIDTHS[::-1])]
    if not all(sc["md5_equal"] for sc in rec["scaling"]):
      emit(out)
      fail("parallel", f"{name}: MD5s differ across stream widths")
    rec["device"] = {w: _device_window(
        lambda w=w: gop._run_waves(frames, inputs, mesh, streams=w), torch)
        for w in (1, max(GOP_WIDTHS))}
    if any(d["lmcs_scales_events"] for d in rec["device"].values()):
      emit(out)
      fail("parallel", f"{name}: standalone LMCS chroma scales kernels ran "
           "on the wave path")
    print(f"chip_smoke: parallel {name}: fps " + ", ".join(
        f"w{w} {[sc[w]['fps'] for sc in rec['scaling']]} (waves "
        f"{[sc[w]['wave_fps'] for sc in rec['scaling']]})"
        for w in GOP_WIDTHS) + "; concurrency " + ", ".join(
        f"w{w} {d['concurrency']}" for w, d in rec["device"].items()),
        flush=True)
  out["calls_checked"] = len(out["cases"])
  try:
    gop.decode_gop_mesh(_read(MAIN), mesh)
  except RuntimeError as e:
    if "DMVR" not in str(e):
      fail("parallel", f"{MAIN} refused for another reason: {e}")
    out["refused"] = {MAIN: str(e)}
  else:
    fail("parallel", f"the wave path decoded {MAIN}, which has DMVR units")
  out["tiled"] = _tiled_filters(torch)
  out["mp4_cli"] = _mp4_cli()
  emit(out)
  return launches


def _bound(name, calls):
  """The least time of a kernel's calls of one frame: the larger of its
  bytes over the HBM rate and its operations over the int32 rate."""
  mine = [kw for n, _, kw in calls if n == name]
  bound_bytes = sum(_bytes_moved(name, kw) for kw in mine) \
      / HBM_BYTES_PER_S * 1e3
  bound_ops = sum(_ops(name, kw) for kw in mine) \
      / INT32_OPS_PER_S * 1e3
  return {"bound_ms": max(bound_bytes, bound_ops),
          "bound_by": "bytes" if bound_bytes >= bound_ops else "operations"}


def _tool_row(name, calls, timed):
  """One kernel's numbers on a coding-tool frame: ms per call summed over
  the plane kinds (for alf and sao, the overlapped pair's ms per frame,
  with the calls alone beside it), the plain version's, and the bound, as
  for the main path's row; None where the frame makes no call of it."""
  if not timed[name]:
    return None
  row = {"ms": sum(r["ms"] for r in timed[name].values()),
         "plain_ms": sum(v for k, v in timed["plain_ms"].items()
                         if k.startswith(name + "/")),
         **_bound(name, calls),
         "per_plane_kind": {label: {k: v for k, v in r.items() if k in (
             "ms", "placement_ms", "wavefront_ms", "levels", "us_per_level",
             "small_ms", "large_ms", "small_units", "large_units", "tus",
             "host_ms_per_call_card_held", "fill_ms", "group_ms",
             "serial_ms", "groups", "launch")}
             for label, r in timed[name].items()}}
  if name in ("alf", "sao"):
    _pair_ms(row, timed[name + "_pair"])
  return row


def _pair_ms(row, pair):
  """An alf or sao row's ms becomes the frame's overlapped pair's (pair,
  from _time_pair; none on a frame without the filter), the calls alone
  beside it as ms_calls_alone."""
  if pair is not None:
    row["ms_calls_alone"], row["ms"] = row["ms"], pair["ms"]


KERNEL_INFO = {
    "residual": ("ffmpeg_tpu_torch/csrc/residual.cu",
                 "ffmpeg_tpu/models/vvc/pipeline.py:569,443,332 "
                 "(_residual_from_buckets over _bucket_residuals and "
                 "_apply_lfnst), and in the chroma call 393 "
                 "(_lmcs_vpdu_scales, called at 1297, folded in: "
                 "csrc/lmcs_scale.cuh); XLA, not Pallas"),
    "inter_pred": ("ffmpeg_tpu_torch/csrc/inter_pred.cu",
                   "ffmpeg_tpu/models/vvc/pipeline.py:1129 (_pred_blocks "
                   "over _inter_pred_unit; XLA, not Pallas)"),
    "recon": ("ffmpeg_tpu_torch/csrc/recon.cu",
              "ffmpeg_tpu/ops/recon_pallas.py:734"),
    "alf": ("ffmpeg_tpu_torch/csrc/alf.cu",
            "ffmpeg_tpu/ops/alf.py:91,169,202,241 (alf_classify, "
            "alf_filter_luma, alf_filter_chroma, alf_filter_cc, composed "
            "by _alf_pass at ffmpeg_tpu/models/vvc/pipeline.py:1211; XLA, "
            "not Pallas)"),
    "deblock": ("ffmpeg_tpu_torch/csrc/deblock.cu",
                "ffmpeg_tpu/ops/deblock.py:67,300 (deblock_vertical_luma, "
                "deblock_vertical_chroma, run by loopfilters at "
                "ffmpeg_tpu/models/vvc/pipeline.py:1315; XLA, not Pallas)"),
    "sao": ("ffmpeg_tpu_torch/csrc/sao.cu",
            "ffmpeg_tpu/ops/sao.py:93,34 (sao_plane over sao_rows, called "
            "per component at ffmpeg_tpu/models/vvc/pipeline.py:1347; band "
            "form ffmpeg_tpu/parallel/spatial.py:139; XLA, not Pallas)"),
    "lmcs_inv": ("ffmpeg_tpu_torch/csrc/lmcs.cu",
                 "ffmpeg_tpu/models/vvc/pipeline.py:373 (_lmcs_inv, called "
                 "at 1308; XLA, not Pallas)"),
    "dmvr": ("ffmpeg_tpu_torch/csrc/dmvr.cu",
             "ffmpeg_tpu/ops/dmvr.py:48,29 (_unit over _bilin, vmapped by "
             "_refine_jit at 137; XLA, not Pallas)"),
}


def main() -> int:
  try:
    import torch
  except ImportError as e:
    fail("device", f"torch missing: {e}")
  card = phase_device(torch)
  if not os.path.isdir(os.path.join(ROOT, "ffmpeg_tpu_torch")):
    fail("build", f"no ffmpeg_tpu_torch package beside {__file__}: run "
         "from a checkout of the repository")
  gen = Generation()
  try:
    return _run(torch, card, gen)
  finally:
    gen.close()


def _run(torch, card, gen) -> int:
  phase_build()
  worst, calls, levels = phase_kernels(torch)
  launches = phase_decode(torch)
  launches.update(phase_generate(torch, card, gen))
  gen.close()
  (kern, plain, recon, inter, deblock, alf, alf_pair, residual, filt,
   sao_pair, dmvr, tools) = phase_timing(torch, card, calls, levels)
  phase_profile(torch, card)
  launches.update(phase_parallel(torch, card))
  paths = FIXTURES + ("generated", FULL17) + tuple(
      k for k in launches if k.startswith("gop:"))
  rows = []
  for name in KERNELS:
    src, replaces = KERNEL_INFO[name]
    rows.append({
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[MAIN][name],
        "launches_by_path": {f: launches[f][name] for f in paths},
        "max_abs_err": worst[name],
        "ms": sum(v for k, v in kern.items() if k.startswith(name + "/")),
        "plain_ms": sum(v for k, v in plain.items()
                        if k.startswith(name + "/")),
        **_bound(name, calls[MAIN]),
        "library_ms": None,
        "coding_tools": {key: _tool_row(name, calls[key], tools[key])
                         for key in TOOL_FRAMES}})
    if name == "recon":
      rows[-1]["split_ms"] = {
          label: {k: r[k] for k in ("placement_ms", "wavefront_ms")}
          for label, r in recon[MAIN].items()}
      rows[-1]["launches_by_edge"] = {
          f: launches[f]["recon_by_edge"] for f in FIXTURES}
    elif name in ("deblock", *filt):
      rows[-1]["split_ms"] = {
          label: {k: r[k] for k in ("ms", "launch") if k in r}
          for label, r in (deblock if name == "deblock" else
                           filt[name]).items()}
      if name == "sao":
        _pair_ms(rows[-1], sao_pair[MAIN])
    elif name == "dmvr":
      rows[-1]["split_ms"] = {label: {"ms": r["ms"]}
                              for label, r in dmvr.items()}
      rows[-1]["subblocks"] = next(kw["ctrl"].shape[1]
                                   for n, _, kw in calls[MAIN] if n == "dmvr")
    elif name == "alf":
      _pair_ms(rows[-1], alf_pair[MAIN])
      rows[-1]["split_ms"] = {label: {"ms": r["ms"], "launch": r["launch"]}
                              for label, r in alf.items()}
    elif name == "residual":
      rows[-1]["split_ms"] = {
          label: {k: r[k] for k in ("ms", "fill_ms", "group_ms", "serial_ms",
                                    "groups", "tus",
                                    "host_ms_per_call_card_held",
                                    "wall_ms_per_call_synced")}
          for label, r in residual.items()}
      rows[-1]["launches_by_group"] = {
          f: launches[f]["residual_by_group"] for f in FIXTURES}
    else:
      rows[-1]["launches_by_class"] = {
          f: launches[f]["inter_pred_by_class"] for f in FIXTURES}
      rows[-1]["split_ms"] = {
          label: {k: r[k] for k in ("small_ms", "large_ms", "small_units",
                                    "large_units")}
          for label, r in inter.items()}
  emit({"kernels": rows})
  emit({"ok": True, "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}})
  return 0


if __name__ == "__main__":
  sys.exit(main())
