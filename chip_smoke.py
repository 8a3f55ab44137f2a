#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card (H100).

  python3 chip_smoke.py

Drives ffmpeg_tpu_torch's main paths through the user entry point
(VVCDecoder(device="cuda")) on the committed fixtures:
  - ra1080: 5 frames of 1920x1080 8-bit random access (B slices with
    TMVP, affine/PROF, BDOF, CIIP, GPM, MMVD, BCW, AMVR, MIP, CCLM,
    deblock and SAO), the P/B slice's path through both kernels;
  - ai720: 4 frames of 1280x720 8-bit all intra, the intra path;
  - ai256x128_10b: 2 frames of 10-bit all intra.
Phases, one JSON line each:

  1. device   card name, count, nvidia-smi name + power limit
  2. build    host parser (make) and every CUDA kernel (nvcc), in
              parallel, from the sources in this checkout
  3. kernels  each kernel call of the frame program (recorded through
              its call hook, pipeline.walk_frames) against its plain
              torch version on the card, torch.equal, tolerance 0
              (all-integer arithmetic): both kernels on a B frame of
              ra1080 with its real DPB references (it holds pure inter,
              CIIP, GPM, BDOF and PROF units), and the recon kernel on
              frame 0 of the intra fixtures (luma, then chroma with
              CCLM)
  4. decode   each fixture decoded on the card; frame MD5s must equal
              the committed ones (from the JAX package's decode); per
              fixture, counts zeroed just before its decode: every kernel
              of the path launched, the plain versions never ran
  5. timing   ra1080 and ai720 fps with frames left on the card and with
              the fetch, ra1080 per-stage ms, kernel vs plain ms (CUDA
              events) on the ra1080 B frame
  6. profile  torch.profiler over a ra1080 decode: device busy share and
              device time by kernel

then the kernel table line and, last, the result line.  Exits non-zero
with no result line when CUDA is unavailable or any phase fails.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
TESTDATA = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata")
MAIN = "ra1080"
FIXTURES = (MAIN, "ai720", "ai256x128_10b")
KERNELS = ("inter_pred", "recon")
# the kernels each fixture's path must launch
PATH_KERNELS = {MAIN: KERNELS, "ai720": ("recon",),
                "ai256x128_10b": ("recon",)}

# NVIDIA H100 SXM data sheet (dense): HBM rate and the non-tensor
# 32-bit rate, used for the kernels' least-time bounds
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_32BIT_OPS_PER_S = 67e12
S = 32  # MC tile edge


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
  from ffmpeg_tpu_torch.ops import inter, recon

  return {"inter_pred": inter, "recon": recon}


def _zero_counts():
  for name, mod in _counts().items():
    mod.LAUNCHES[name] = 0
    mod.PLAIN_RUNS[name] = 0


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
  from ffmpeg_tpu_torch.ops import inter, recon
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
      ("inter_pred", inter._get_kernel))]
  t0 = time.perf_counter()
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  if errors:
    fail("build", "; ".join(errors))
  emit({"phase": "build", "seconds": time.perf_counter() - t0,
        "seconds_each": times,
        "ptxas": {k: BUILD_LOG.get(k, {}).get("ptxas", []) for k in KERNELS}})


def _walk_calls(name, pick=None):
  """Walk a fixture's frames through the frame program on the card
  (pipeline.walk_frames), each kernel call running its wrapper.
  pick(fs, host inputs) -> bool marks the frame to keep: returns (fs,
  that frame's kernel calls [(kernel, plane kind, kwargs)], per-frame
  unit records) for the first picked frame (frame 0, and no further
  walk, without pick)."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  frame_calls, records, kept = [], [], None

  def record(kernel, label, kw):
    frame_calls.append((kernel, label, kw))
    return KERNELS[kernel][0](**kw)

  aus = VVCDecoder(device="cuda")._split_aus(_read(name))
  for fs, h in walk_frames(aus, "cuda", record):
    records.append(_unit_counts(fs, h))
    if kept is None and (pick is None or pick(fs, h)):
      kept = (fs, list(frame_calls))
      if pick is None:
        break
    frame_calls.clear()
  if kept is None:
    fail("kernels", f"{name}: no frame holds every unit kind")
  return (*kept, records)


def _unit_counts(fs, h):
  """The frame's luma units by path, and the bytes of its MC tiles
  (units x channels x S x S int32, both plane kinds)."""
  y = h["ctrl"]["y"]
  inter = y["inter"]
  n_pure = int(y["n_inter"])
  tiles = len(inter["x0"]) * S * S * 4
  if fs.chroma_format_idc:
    tiles += len(h["ctrl"]["c"]["inter"]["x0"]) * 2 * S * S * 4
  rows = y["intra"]
  n_iu = int(rows["iend"][-1]) if int(y["n_chunks"]) else 0
  return {"poc": fs.poc, "slice_type": fs.slice_type, "pure_inter": n_pure,
          "ciip": int((rows["ciipw"][:n_iu] > 0).sum()),
          "gpm": int((inter["gpm_part"][:n_pure] > 0).sum()),
          "bdof": int((inter["bdof"][:n_pure] > 0).sum()),
          "prof": int((inter["prof"][:n_pure] != 0).sum()),
          "intra": n_iu - int((rows["ciipw"][:n_iu] > 0).sum()),
          "tile_bytes": tiles}


def _every_path(fs, h):
  c = _unit_counts(fs, h)
  return fs.slice_type == 0 and all(
      c[k] > 0 for k in ("pure_inter", "ciip", "gpm", "bdof", "prof"))


def _kernel(name, kw):
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS

  return KERNELS[name][0](**kw)


def _plain(name, kw):
  """The plain torch version on the same card tensors."""
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS

  return KERNELS[name][1](**kw)


def _bytes_moved(name, kw):
  """Each input read once, the output written once (bytes).  For the
  reference planes, the samples the units' filter windows cover (at most
  the planes themselves); for the MC tiles, only each unit's w x h
  samples, the part that inter_pred defines and recon reads."""
  inter = kw["inter"]
  w, h, hyp = _wh_hyp(inter["mat_host"])
  if name == "inter_pred":
    nch = len(kw["refs"])
    taps = 4 if kw["is_chroma"] else 8
    win = int((((w + taps - 1) * (h + taps - 1)) * hyp).sum())
    planes = len(kw["refs"][0]) * kw["H"] * kw["W"]
    b = nch * min(win, planes) * 4
    b += (inter["mat_host"].nbytes + inter["gslot"].numel() * 4
          + inter["gwt"].numel() * 4)
    return b + nch * int((w * h).sum()) * 4       # the units' samples out
  intra = kw["intra"]
  nch = kw["res"].shape[0]
  b = kw["res"].numel() * 4 * 2                   # residual in, plane out
  b += intra["mat"].numel() * 4 + intra["ioff"].numel() * 8
  b += intra["ipos"].numel() * 4 + inter["mat_host"][:4].nbytes
  if kw["tiles"] is not None:                     # placed and CIIP samples
    b += nch * int((w * h).sum()) * 4
  if kw.get("cclm") is not None:
    b += kw["cclm"][1].numel() * 4 + 4 * 4 * intra["mat"].shape[1]
  return b


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
  and 3 per placed inter sample."""
  from ffmpeg_tpu_torch.models.vvc.inputs import INTER_KEYS, INTRA_KEYS

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


def phase_kernels(torch):
  """Both kernels against their plain versions on a ra1080 B frame with
  its real references; the recon kernel on frame 0 of the intra
  fixtures.  Returns the worst error per kernel and each fixture's
  checked calls."""
  out = {"phase": "kernels", "tolerance": 0, "cases": []}
  fs, main_calls, records = _walk_calls(MAIN, _every_path)
  units = next(r for r in records if r["poc"] == fs.poc)
  out["frame"] = {"fixture": MAIN, **units,
                  "mc_units": {label: kw["inter"]["n_mc"]
                               for n, label, kw in main_calls
                               if n == "inter_pred"},
                  "chunks": {label: kw["n_chunks"]
                             for n, label, kw in main_calls if n == "recon"}}
  calls = {MAIN: main_calls}
  for name in FIXTURES[1:]:
    calls[name] = _walk_calls(name)[1]
  for name in FIXTURES:
    _check_calls(name, calls[name], out, torch)
  worst = {k: max(c["max_abs_err"] for c in out["cases"] if c["kernel"] == k)
           for k in KERNELS}
  out["max_abs_err"] = max(worst.values())
  out["tile_bytes_peak_frame"] = max(r["tile_bytes"] for r in records)
  out["records"] = records
  emit(out)
  return worst, calls


def _decode_md5s(name, torch):
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  return [fr.md5() for fr in VVCDecoder(device="cuda").decode(_read(name))]


def phase_decode(torch):
  """Each fixture is its own path: the counts are zeroed just before its
  decode and read just after.  Returns the launches of each path."""
  res = {"phase": "decode", "fixtures": {}}
  launches = {}
  for name in FIXTURES:
    with open(os.path.join(TESTDATA, f"{name}.md5.json")) as f:
      want = json.load(f)["md5"]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    got = _decode_md5s(name, torch)
    counts = _counts()
    launches[name] = {k: m.LAUNCHES[k] for k, m in counts.items()}
    plain = {k: m.PLAIN_RUNS[k] for k, m in counts.items()}
    res["fixtures"][name] = {
        "frames": len(got), "md5_equal": got == want,
        "launches": launches[name], "plain_runs": plain,
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
  emit(res)
  return launches


def _events_ms(fn, torch, reps):
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _fps(name, torch, traced=False):
  """fps with frames left on the card and with the fetch, after a
  warm-up decode; with traced, also the traced stage ms per frame."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.utils import trace

  data = _read(name)
  dec = VVCDecoder(device="cuda")
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
    out["stage_ms_per_frame_traced"] = {
        k: v["total_ms"] / n_frames for k, v in trace.summary().items()
        if "total_ms" in v}
  return out


def phase_timing(torch, card, calls):
  """fps of ra1080 (with traced stages) and ai720; then each kernel
  against its plain version on the ra1080 B frame's calls, in turns
  (plain, kernel, kernel, plain), and the recon kernel alone on ai720's
  frame 0."""
  out = {"phase": "timing", "card": card,
         MAIN: _fps(MAIN, torch, traced=True),
         "ai720": _fps("ai720", torch)}
  kern, plain = {}, {}
  for name, label, kw in calls[MAIN]:
    p1 = _events_ms(lambda: _plain(name, kw), torch, 1)
    k1 = _events_ms(lambda: _kernel(name, kw), torch, 20)
    k2 = _events_ms(lambda: _kernel(name, kw), torch, 20)
    p2 = _events_ms(lambda: _plain(name, kw), torch, 1)
    kern[f"{name}/{label}"] = (k1 + k2) / 2
    plain[f"{name}/{label}"] = (p1 + p2) / 2
  out["kernel_ms"], out["plain_ms"] = kern, plain
  out["ai720_frame0_kernel_ms"] = {
      f"{name}/{label}": _events_ms(lambda: _kernel(name, kw), torch, 20)
      for name, label, kw in calls["ai720"]}
  emit(out)
  return kern, plain


def phase_profile(torch, card):
  """torch.profiler over a warm ra1080 decode (frames left on the card).
  Device busy share = union of device activity over the profiled
  window; device time by kernel name."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  data = _read(MAIN)
  dec = VVCDecoder(device="cuda")
  list(dec.decode(data, fetch=False))
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    n = sum(1 for _ in dec.decode(data, fetch=False))
    torch.cuda.synchronize()
  events = list(prof.events())
  dev = sorted((e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CUDA)
  lo = min(e.time_range.start for e in events)
  hi = max(e.time_range.end for e in events)
  busy, end = 0.0, lo
  for s0, s1 in dev:
    if s1 > end:
      busy += s1 - max(s0, end)
      end = s1
  by_name: dict = {}
  for e in events:
    if e.device_type == DeviceType.CUDA:
      by_name[e.name] = by_name.get(e.name, 0.0) + (
          e.time_range.end - e.time_range.start)
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
  emit({"phase": "profile", "card": card, "fixture": MAIN, "frames": n,
        "window_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / max(hi - lo, 1e-9),
        "device_events": len(dev),
        "device_ms_per_frame_by_kernel": {k[:80]: v / 1e3 / n
                                          for k, v in top}})


KERNEL_INFO = {
    "inter_pred": ("ffmpeg_tpu_torch/csrc/inter_pred.cu",
                   "ffmpeg_tpu/models/vvc/pipeline.py:1129 (_pred_blocks "
                   "over _inter_pred_unit; XLA, not Pallas)"),
    "recon": ("ffmpeg_tpu_torch/csrc/recon.cu",
              "ffmpeg_tpu/ops/recon_pallas.py:734"),
}


def main() -> int:
  try:
    import torch
  except ImportError as e:
    fail("device", f"torch missing: {e}")
  card = phase_device(torch)
  phase_build()
  worst, calls = phase_kernels(torch)
  launches = phase_decode(torch)
  kern, plain = phase_timing(torch, card, calls)
  phase_profile(torch, card)
  rows = []
  for name in KERNELS:
    mine = [kw for n, _, kw in calls[MAIN] if n == name]
    bound_bytes = sum(_bytes_moved(name, kw) for kw in mine) \
        / HBM_BYTES_PER_S * 1e3
    bound_ops = sum(_ops(name, kw) for kw in mine) \
        / NON_TENSOR_32BIT_OPS_PER_S * 1e3
    src, replaces = KERNEL_INFO[name]
    rows.append({
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[MAIN][name],
        "launches_by_path": {f: launches[f][name] for f in FIXTURES},
        "max_abs_err": worst[name],
        "ms": sum(v for k, v in kern.items() if k.startswith(name + "/")),
        "plain_ms": sum(v for k, v in plain.items()
                        if k.startswith(name + "/")),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None})
  emit({"kernels": rows})
  emit({"ok": True, "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}})
  return 0


if __name__ == "__main__":
  sys.exit(main())
