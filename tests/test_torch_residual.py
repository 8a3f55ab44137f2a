"""The residual stage: the port's entry point residual_planes (its plain
version on the CPU) against the JAX package's `_residual_from_buckets`,
bit for bit (tolerance 0: integer arithmetic, and float64 products that
are exact), on seeded draws of whole calls at 8, 10 and 12 bits (every
luma class: 2-D with MTS, LFNST in both layouts and transform skip,
1-D ISP, TB-64 and ISP-64; the Cb+Cr classes with joint CbCr in every
mode and LMCS chroma scaling; with and without scaling lists; levels at
the 16-bit limits) and on a 4:0:0 frame; the chroma call's scales from
their source (the mapped luma picture) against JAX `_lmcs_vpdu_scales`
then `_residual_from_buckets`, at VPDU sizes 32 and 64, with tile
boundaries on VPDU edges, TBs of 4 samples and 1-D TBs unscaled; the
wrapper's checks; the rows
the plain version refuses; the kernel's work split (each TU and each
output row of a banded TU covered once, every item within its group's
shared memory); the frame's error word, read by the session and the wave
path before a frame is handed out; and (on the card) the CUDA kernel
csrc/residual.cu against the plain version.

JAX is imported inside the tests that need it, so that the card, which
has no JAX, collects the `gpu` tests:

  python -m pytest --noconftest -m gpu tests/test_torch_residual.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_alf import ALF_MONO  # noqa: E402
from test_torch_decode import (CODING_CASES, _read,  # noqa: E402
                               _stream)
from torch_residual_draws import (LUMA_ALL, draw_call,  # noqa: E402
                                  scale_source)

from ffmpeg_tpu_torch.models.vvc.inputs import CHROMA_SIZES  # noqa: E402
from ffmpeg_tpu_torch.ops import transform as TT  # noqa: E402
from ffmpeg_tpu_torch.ops.transform import BUCKET_ROWS  # noqa: E402

torch.set_num_threads(2)

BDS = (8, 10, 12)
# (kind, with_sl, scaled): luma with and without scaling lists; Cb+Cr
# with and without scaling lists and LMCS scales
VARIANTS = [("luma", False, False), ("luma", True, False),
            ("chroma", False, False), ("chroma", True, False),
            ("chroma", False, True), ("chroma", True, True)]
DRAWS = [(bd, *v, False) for bd in BDS for v in VARIANTS] + [
    (12, "luma", True, False, True), (12, "chroma", False, True, True)]


def _draw_id(d):
  bd, kind, with_sl, scaled, clamp = d
  return "-".join([f"{bd}bit", kind] + ["sl"] * with_sl
                  + ["lmcs"] * scaled + ["clamp"] * clamp)


def _call(draw, device="cpu"):
  bd, kind, with_sl, scaled, clamp = draw
  return draw_call(kind, bd, with_sl, scaled, clamp,
                   seed=bd * 10 + VARIANTS.index((kind, with_sl, scaled)),
                   device=device)


def _jax_residual(*, buckets, sizes, Hp, Wp, bit_depth, chroma,
                  scale_src=None, sl=None, err=None):
  """JAX _residual_from_buckets on the same inputs (numpy), for each
  component of the call (a frame program call's error word aside), the
  chroma scales, where the call has their source, from JAX
  _lmcs_vpdu_scales on its luma picture.  Returns (nch, Hp, Wp) numpy."""
  import jax.numpy as jnp

  from ffmpeg_tpu.models.vvc import pipeline as JP

  def j(t):
    return jnp.asarray(t.cpu().numpy())

  cs = None
  if scale_src is not None:
    luma, lm = scale_src["luma"], scale_src["lm"]
    jlm = {k: j(lm[k]) for k in ("pivot", "bins", "chroma_scale")}
    cs = JP._lmcs_vpdu_scales(
        jnp.asarray(np.ascontiguousarray(luma.cpu().numpy())), jlm,
        luma.shape[1], luma.shape[0], scale_src["vsz"], bit_depth,
        scale_src["tile_bds"])
  jsl = None if sl is None else {k: j(v) for k, v in sl.items()}
  out = []
  for comp in buckets:
    jb = {wh: {"mat": j(b["mat"]), "lv": j(b["lv"]),
               "n": jnp.asarray([int(b["n"])], jnp.int32)}
          for wh, b in comp.items()}
    out.append(np.asarray(JP._residual_from_buckets(
        jb, Hp, Wp, bit_depth, tuple(sizes), chroma, cs, jsl)))
  return np.stack(out)


def _kinds_present(kw):
  """What a drawn call exercises: its rows' tools (each must be there)."""
  k = BUCKET_ROWS.index
  rows = [b["mat"].cpu().numpy() for comp in kw["buckets"]
          for b in comp.values()]
  cat = np.concatenate(rows, axis=1)
  return {"ts": bool((cat[k("ts")] > 0).any()),
          "lfnst": bool((cat[k("lf_sel")] >= 0).any()),
          "lfnst_tr": bool(((cat[k("lf_sel")] >= 0)
                            & (cat[k("lf_tr")] > 0)).any()),
          "mts": bool(((cat[k("trh")] > 0) | (cat[k("trv")] > 0)).any()),
          "jop": sorted(set(cat[k("jop")].tolist()))}


# ---- the plain entry against JAX -----------------------------------------

@pytest.mark.parametrize("draw", DRAWS, ids=_draw_id)
def test_residual_planes_plain_matches_jax(draw):
  """residual_planes on CPU tensors (the plain version, run once, no
  launch) against JAX _residual_from_buckets on the same seeded call,
  every class of the plane kind, an empty class among them: the whole
  planes equal."""
  kw = _call(draw)
  plain, launches = TT.PLAIN_RUNS["residual"], TT.LAUNCHES["residual"]
  got = TT.residual_planes(**kw)
  assert TT.PLAIN_RUNS["residual"] == plain + 1
  assert TT.LAUNCHES["residual"] == launches
  assert got.shape == (2 if kw["chroma"] else 1, kw["Hp"], kw["Wp"])
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), _jax_residual(**kw))
  assert np.count_nonzero(got.numpy()) > got.numel() // 8
  seen = _kinds_present(kw)
  assert seen["ts"] and seen["mts"]
  if kw["chroma"]:
    assert seen["jop"] == [0, 1, 2, 3, 4]
  else:
    assert seen["lfnst"] and seen["lfnst_tr"]


def _mono_calls(check):
  """Walk the 4:0:0 ALF stream (test_torch_alf.ALF_MONO) on the CPU
  through the frame program with `check` as its call hook; returns the
  calls per frame."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import walk_frames

  seen, frames = [], []

  def hook(name, label, kw):
    seen.append((name, label))
    return check(name, label, kw)

  aus = VVCDecoder(device="cpu")._split_aus(_stream(ALF_MONO))
  for fs, _ in walk_frames(aus, "cpu", hook):
    assert fs.chroma_format_idc == 0
    frames.append(list(seen))
    seen.clear()
  return frames


def test_residual_plain_matches_jax_on_mono_frame():
  """A 4:0:0 frame makes one residual call (luma) and equals JAX."""
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS

  def check(name, label, kw):
    got = KERNELS[name][0](**kw)
    if name == "residual":
      assert label == "luma" and got.shape[0] == 1
      np.testing.assert_array_equal(got.numpy(), _jax_residual(**kw))
    return got

  frames = _mono_calls(check)
  assert frames and all(
      [c for c in calls if c[0] == "residual"] == [("residual", "luma")]
      for calls in frames)


# ---- the chroma scales from their source -----------------------------------

# (bit depth, VPDU edge, tile boundaries on VPDU edges)
SCALE_CASES = [(bd, vsz, tiles) for bd in (8, 10) for vsz in (32, 64)
               for tiles in (((), ()), ((2 * vsz,), (vsz,)))]
# 1-D classes, which a chroma call does not carry, added so that the
# calls hold their exclusion from the scaling too
ONE_D = ((1, 16), (16, 1))


def _scale_id(case):
  bd, vsz, tiles = case
  return f"{bd}bit-vsz{vsz}-" + ("tiles" if tiles[0] else "one-tile")


def _scale_call(case, device="cpu"):
  bd, vsz, tiles = case
  return draw_call("chroma", bd, scaled=True, seed=100 + bd + vsz
                   + len(tiles[0]), device=device, vsz=vsz, tile_bds=tiles,
                   extra=ONE_D)


def _unscaled_classes_kept(kw, got, unscaled):
  """The classes that take no scaling (4 samples, 1-D) are the unscaled
  call's samples, the others (as a whole) are not."""
  k = BUCKET_ROWS.index
  for wh in kw["sizes"]:
    b = kw["buckets"][0][wh]
    if b["n"] and (wh[0] * wh[1] <= 4 or 1 in wh):
      y0 = int(b["mat"][k("y0"), 0])
      assert torch.equal(got[:, y0:y0 + wh[1]], unscaled[:, y0:y0 + wh[1]])
  assert not torch.equal(got, unscaled)


@pytest.mark.parametrize("case", SCALE_CASES, ids=_scale_id)
def test_chroma_scale_source_matches_jax(case):
  """The chroma call's plain route, given the scales' source (the mapped
  luma picture as a view of its padded plane, 4 x 3 VPDUs cut short at
  the edges, tile boundaries on VPDU edges), against JAX
  _lmcs_vpdu_scales on that picture followed by JAX
  _residual_from_buckets, tolerance 0; the 2x2 and 1-D TBs unscaled."""
  kw = _scale_call(case)
  runs = TT.PLAIN_RUNS["residual"]
  got = TT.residual_planes(**kw)
  assert TT.PLAIN_RUNS["residual"] == runs + 1
  np.testing.assert_array_equal(got.numpy(), _jax_residual(**kw))
  _unscaled_classes_kept(kw, got, TT.residual_planes(**dict(
      kw, scale_src=None)))


# ---- the wrapper's checks and the rows the plain version refuses -------------

BAD = ("one-component-chroma", "two-component-luma", "int16-levels",
       "rows-strided", "levels-wrong-shape", "missing-class", "bit-depth-7",
       "scale-with-luma", "int64-scale", "scale-luma-transposed",
       "scale-vsz-128", "scale-vsz-48", "scale-tile-cap",
       "scale-no-inv-host", "scale-no-chroma-scale", "sl-wrong-shape",
       "meta-device", "err-int64", "err-two-words")


def _meta(t):
  return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("bad", BAD)
def test_residual_planes_refuses(bad):
  """residual_planes checks its inputs on every device and raises
  ValueError on what the kernel does not take, and on a device that is
  neither CUDA nor the CPU (nothing is converted, nothing falls back)."""
  chroma = bad in ("one-component-chroma", "int64-scale") or (
      bad.startswith("scale-") and bad != "scale-with-luma")
  kw = draw_call("chroma" if chroma else "luma", 10, with_sl=True,
                 scaled=chroma, n=2)
  src = kw["scale_src"]
  comp = kw["buckets"][0]
  wh = kw["sizes"][0]
  if bad == "one-component-chroma":
    kw["buckets"] = kw["buckets"][:1]
  elif bad == "two-component-luma":
    kw["buckets"] = kw["buckets"] * 2
  elif bad == "int16-levels":
    comp[wh]["lv"] = comp[wh]["lv"].to(torch.int16)
  elif bad == "rows-strided":
    comp[wh]["mat"] = comp[wh]["mat"].T.contiguous().T
  elif bad == "levels-wrong-shape":
    comp[wh]["lv"] = comp[wh]["lv"][:, :, :1].contiguous()
  elif bad == "missing-class":
    del comp[wh]
  elif bad == "bit-depth-7":
    kw["bit_depth"] = 7
  elif bad == "scale-with-luma":
    kw["scale_src"] = scale_source(10, 32, ((), ()), seed=1)
  elif bad == "int64-scale":
    src["luma"] = src["luma"].long()
  elif bad == "scale-luma-transposed":
    src["luma"] = src["luma"].T
  elif bad in ("scale-vsz-128", "scale-vsz-48"):
    src["vsz"] = {"scale-vsz-128": 128, "scale-vsz-48": 48}[bad]
  elif bad == "scale-tile-cap":
    src["tile_bds"] = (tuple(range(1, 66)), ())
  elif bad == "scale-no-inv-host":
    del src["lm"]["inv_host"]
  elif bad == "scale-no-chroma-scale":
    src["lm"]["inv_host"] = src["lm"]["inv_host"][:35]
  elif bad == "sl-wrong-shape":
    kw["sl"]["rec"] = kw["sl"]["rec"][:27].contiguous()
  elif bad == "err-int64":
    kw["err"] = torch.zeros(1, dtype=torch.int64)
  elif bad == "err-two-words":
    kw["err"] = torch.zeros(2, dtype=torch.int32)
  else:
    kw["buckets"] = [{k: dict(b, mat=_meta(b["mat"]), lv=_meta(b["lv"]))
                      for k, b in c.items()} for c in kw["buckets"]]
    kw["sl"] = {k: _meta(v) for k, v in kw["sl"].items()}
  with pytest.raises(ValueError, match="residual"):
    TT.residual_planes(**kw)


# rows that index out of range: (row, value, kind, scaled, with_sl); the
# kernel writes its error word for each and the wrapper raises
BAD_ROWS = {"kind": ("trv", 3, "luma", False, False),
            "vpdu": ("vpdu", 99, "chroma", True, False),
            "slid": ("slid", 28, "luma", False, True),
            "place": ("y0", 10 ** 6, "luma", False, False)}


def _bad_row_call(which, device="cpu"):
  """A seeded call whose one TU (of the 8x8 class) has a bad row."""
  row, value, kind, scaled, with_sl = BAD_ROWS[which]
  kw = draw_call(kind, 10, with_sl=with_sl, scaled=scaled, n=2,
                 device=device)
  b = kw["buckets"][0][(8, 8)]
  b["mat"][BUCKET_ROWS.index(row), 1] = value
  return kw


@pytest.mark.parametrize("which", sorted(BAD_ROWS))
def test_residual_plain_refuses_bad_rows(which):
  """The plain version raises on the rows the kernel refuses: a
  transform kind, a VPDU or a scaling-list id past its table, a block
  past the plane."""
  with pytest.raises(IndexError):
    TT.residual_planes(**_bad_row_call(which))


def test_residual_empty_call_plain():
  """A call without TUs gives zero planes."""
  kw = draw_call("chroma", 8, n=2)
  for comp in kw["buckets"]:
    for wh, b in comp.items():
      comp[wh] = dict(b, mat=b["mat"][:, :0].contiguous(),
                      lv=b["lv"][:0].contiguous(), n=0)
  got = TT.residual_planes(**kw)
  assert got.shape == (2, kw["Hp"], kw["Wp"]) and not got.any()


# ---- the kernel's work split (host side) ----------------------------------

# (w, h, n) of the non-empty classes of real calls, in call order (Cb's,
# then Cr's): full1080 POC 2, a B frame of the main path, and ctu128_1080
# POC 0, the I frame of CTU-128 with TB-64, ISP and scaling lists
REAL_COUNTS = {
    "full1080-B-luma": [
        (8, 8, 1746), (8, 16, 628), (8, 32, 301), (16, 4, 404),
        (16, 8, 621), (16, 16, 961), (16, 32, 209), (32, 4, 291),
        (32, 8, 339), (32, 16, 208), (32, 32, 602)],
    "full1080-B-chroma": [
        (4, 4, 1651), (4, 8, 589), (4, 16, 283), (8, 2, 378), (8, 4, 565),
        (8, 8, 899), (8, 16, 202), (16, 2, 284), (16, 4, 316), (16, 8, 203),
        (16, 16, 586), (4, 4, 1599), (4, 8, 589), (4, 16, 285), (8, 2, 387),
        (8, 4, 577), (8, 8, 918), (8, 16, 203), (16, 2, 264), (16, 4, 331),
        (16, 8, 199), (16, 16, 584)],
    "ctu128-I-luma": [
        (4, 8, 13), (4, 16, 12), (4, 32, 63), (8, 4, 28), (8, 8, 142),
        (8, 16, 89), (8, 32, 82), (16, 4, 18), (16, 8, 83), (16, 16, 23),
        (16, 32, 53), (32, 4, 87), (32, 8, 104), (32, 16, 63), (32, 32, 49),
        (2, 8, 11), (2, 16, 8), (2, 32, 30), (8, 2, 22), (16, 2, 22),
        (32, 2, 58), (32, 1, 24), (16, 64, 38), (32, 64, 81), (64, 64, 274),
        (64, 16, 61), (64, 32, 91)],
    "ctu128-I-chroma": [
        (4, 4, 28), (4, 8, 16), (4, 16, 53), (8, 4, 34), (8, 8, 29),
        (8, 16, 86), (8, 32, 32), (16, 2, 44), (16, 4, 106), (16, 8, 103),
        (16, 16, 73), (16, 32, 80), (32, 8, 66), (32, 16, 95),
        (32, 32, 249), (4, 4, 30), (4, 8, 19), (4, 16, 51), (8, 4, 35),
        (8, 8, 30), (8, 16, 81), (8, 32, 33), (16, 2, 45), (16, 4, 101),
        (16, 8, 95), (16, 16, 66), (16, 32, 82), (32, 8, 67), (32, 16, 95),
        (32, 32, 244)],
}
ALL_SIZES = sorted(set(LUMA_ALL) | set(CHROMA_SIZES))


def _random_counts(seed):
  """Seeded counts of a call: up to 64 classes of any size, some with a
  single TU, some with a few thousand."""
  rng = np.random.default_rng(seed)
  k = int(rng.integers(1, 65))
  sizes = [ALL_SIZES[i] for i in rng.integers(0, len(ALL_SIZES), k)]
  n = np.where(rng.random(k) < 0.2, 1, rng.integers(1, 4000, k))
  return [(w, h, int(m)) for (w, h), m in zip(sizes, n)]


SPLIT_CASES = {**REAL_COUNTS,
               **{f"random-{s}": _random_counts(s) for s in range(6)}}


def _item_work(split_group, counts, item):
  """What block `item` of a group's launch computes, as csrc/residual.cu
  finds it (the last class whose first item is at most `item`): (index
  into counts, its TUs [i0, i1), their output rows [r0, r1))."""
  first = [c[1] for c in split_group["classes"]]
  j = int(np.searchsorted(first, item, side="right")) - 1
  k, f, per, band = split_group["classes"][j]
  w, h, n = counts[k]
  local = item - f
  if per == 1:
    i, b = divmod(local, h // band)
    return k, (i, i + 1), (b * band, (b + 1) * band)
  return k, (local * per, min(n, (local + 1) * per)), (0, h)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_work_split_covers_each_tu_and_row_once(case):
  """work_split from a call's class counts, each item decoded as the
  kernel decodes it (_item_work): every TU of every class, and every
  output row of a banded TU, is covered by exactly one item of its own
  group; a packed item holds consecutive TUs; each launch's shared memory
  is the largest need of its own classes, within its group's budget."""
  counts = SPLIT_CASES[case]
  split = TT.work_split(counts)
  cover = [np.zeros((n, h), np.int32) for w, h, n in counts]
  assert sorted(k for grp in split for k, *_ in grp["classes"]) == list(
      range(len(counts)))
  for g, grp in enumerate(split):
    assert len(grp["classes"]) <= 64
    needs = [TT.smem_bytes(g, counts[k][0], counts[k][1], band)
             for k, _, _, band in grp["classes"]]
    assert grp["smem"] == max(needs, default=0) <= TT.SMEM_BUDGET[g]
    for k, _, per, band in grp["classes"]:
      w, h, _ = counts[k]
      assert TT.work_group(w, h) == g and per == TT.tus_per_item(g)
      assert band == TT.band_rows(w, h)
    for item in range(grp["items"]):
      k, (i0, i1), (r0, r1) = _item_work(grp, counts, item)
      w, h, n = counts[k]
      assert TT.work_group(w, h) == g and 0 <= i0 < i1 <= n
      assert i1 - i0 == TT.tus_per_item(g) or i1 == n
      assert 0 <= r0 < r1 <= h
      cover[k][i0:i1, r0:r1] += 1
  for c in cover:
    assert (c == 1).all()


@pytest.mark.parametrize("wh", ALL_SIZES, ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_work_group_of_each_class(wh):
  """Each size class's group (by its samples: at most 64, 256, more), its
  band (the whole TU in the packed groups; in the large group a divisor
  of h of at most 512 samples), and its item's shared memory within its
  own group's budget; 1-D classes never reach the large group, whose
  kernel runs 2-D passes only."""
  w, h = wh
  g = TT.work_group(w, h)
  assert g == (0 if w * h <= 64 else 1 if w * h <= 256 else 2)
  band = TT.band_rows(w, h)
  assert h % band == 0
  assert band == h if g < 2 else (band * w <= 512 and band < h or
                                  w * h <= 512)
  assert g < 2 or (w > 2 and h > 2)
  assert TT.smem_bytes(g, w, h, band) <= TT.SMEM_BUDGET[g]


# ---- the frame's error word ------------------------------------------------

def test_raise_on_error_names_the_rows():
  TT.raise_on_error(0)
  with pytest.raises(RuntimeError, match=r"\(POC 3\).*leaves the plane; a "
                     "dequant shift"):
    TT.raise_on_error(8 | 16, " (POC 3)")
  for bit, msg in TT.ERRORS.items():
    with pytest.raises(RuntimeError, match=msg):
      TT.raise_on_error(bit)


def test_residual_planes_cpu_leaves_error_word():
  """The plain version takes the frame's error word and leaves it 0 (it
  raises at once on rows out of range)."""
  kw = _call(DRAWS[0])
  err = TT.error_word("cpu")
  want = TT.residual_planes(**kw)
  assert torch.equal(TT.residual_planes(**kw, err=err), want)
  assert err.tolist() == [0]


def _failing_residual(monkeypatch, device, bad_call=3):
  """Route the frame program's residual calls (pipeline.KERNELS, which
  its default call runs) through a hook that spoils the `bad_call`-th
  call (the third: the luma call of the second frame of a 4:2:0
  stream): on the card a TU whose block leaves the plane, which the
  kernel refuses in the frame's error word; on the CPU, whose plain
  version raises at once on such a row, the word the kernel would set."""
  from ffmpeg_tpu_torch.models.vvc import pipeline

  wrapper, plain = pipeline.KERNELS["residual"]
  calls = []

  def hook(**kw):
    calls.append(kw)
    if len(calls) != bad_call:
      return wrapper(**kw)
    if device.type == "cpu":
      got = wrapper(**kw)
      kw["err"].fill_(8)
      return got
    comp = dict(kw["buckets"][0])
    wh = next(wh for wh in kw["sizes"] if int(comp[wh]["n"]))
    mat = comp[wh]["mat"].clone()
    mat[BUCKET_ROWS.index("y0"), 0] = 10 ** 6
    comp[wh] = dict(comp[wh], mat=mat)
    return wrapper(**dict(kw, buckets=[comp] + kw["buckets"][1:]))

  monkeypatch.setitem(pipeline.KERNELS, "residual", (hook, plain))
  return calls


def _session_refuses(monkeypatch, device, fetch):
  """The session on ciip64 (POC 0, 1, 2 in decode order) with the second
  frame's residual spoiled: decode raises naming its rows before it hands
  out that frame or any frame decoded after it."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder

  _failing_residual(monkeypatch, device)
  got = []
  with pytest.raises(RuntimeError, match=r"POC 1\).*leaves the plane"):
    for fr in VVCDecoder(device=device).decode(_read("ciip64"), fetch=fetch):
      got.append(fr.poc)
  assert set(got) <= {0}
  return got


def _wave_path_refuses(monkeypatch, device, mesh):
  from ffmpeg_tpu_torch.parallel.gop import decode_gop_mesh

  calls = _failing_residual(monkeypatch, device)
  with pytest.raises(RuntimeError, match=r"POC \d\).*leaves the plane"):
    decode_gop_mesh(_read("ciip64"), mesh)
  assert len(calls) == 6


@pytest.mark.parametrize("fetch", [True, False], ids=["fetch", "no-fetch"])
def test_session_raises_on_residual_error_word(monkeypatch, fetch):
  _session_refuses(monkeypatch, torch.device("cpu"), fetch)


def test_wave_path_raises_on_residual_error_word(monkeypatch):
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh

  _wave_path_refuses(monkeypatch, torch.device("cpu"),
                     make_mesh(devices=["cpu"], frame_axis=1))


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (on the card: python -m pytest "
                "--noconftest -m gpu tests/test_torch_residual.py)")
  return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("draw", DRAWS, ids=_draw_id)
def test_residual_kernel_matches_plain_on_card(cuda, draw):
  """The kernel against the plain version on the same card tensors,
  tolerance 0: 3 calls, each launching every work group (a draw holds
  classes of all three), each launch counted once, the error word 0, no
  plain run by the wrapper."""
  kw = _call(draw, cuda)
  want = TT.residual_planes_plain(**kw)
  err = TT.error_word(cuda)
  launches, plain = TT.LAUNCHES["residual"], TT.PLAIN_RUNS["residual"]
  calls, groups = TT.CALLS["residual"], dict(TT.GROUP_LAUNCHES)
  for i in range(3):
    got = TT.residual_planes(**kw, err=err)
    assert torch.equal(got, want), f"call {i}"
  assert err.item() == 0
  assert TT.CALLS["residual"] == calls + 3
  assert TT.LAUNCHES["residual"] == launches + 9
  assert all(TT.GROUP_LAUNCHES[g] == groups[g] + 3 for g in TT.GROUPS)
  assert TT.PLAIN_RUNS["residual"] == plain


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCALE_CASES, ids=_scale_id)
def test_residual_kernel_scale_source_on_card(cuda, case):
  """The chroma call with the scales' source (each scaled TU computing
  its VPDU's scale) against the plain version, tolerance 0, 3 calls;
  the error word 0; no other kernel launched."""
  from ffmpeg_tpu_torch.ops import lmcs as TL

  kw = _scale_call(case, cuda)
  want = TT.residual_planes_plain(**kw)
  err = TT.error_word(cuda)
  lmcs = dict(TL.LAUNCHES)
  for i in range(3):
    assert torch.equal(TT.residual_planes(**kw, err=err), want), f"call {i}"
  assert err.item() == 0 and TL.LAUNCHES == lmcs
  _unscaled_classes_kept(kw, want, TT.residual_planes_plain(**dict(
      kw, scale_src=None)))


@pytest.mark.gpu
@pytest.mark.parametrize("draw", [DRAWS[1], DRAWS[4], DRAWS[-2],
                                  DRAWS[-1]], ids=_draw_id)
def test_residual_kernel_multi_block_classes_on_card(cuda, draw):
  """21 TUs a class: packed blocks full and partial, several bands of
  several TUs, equal to the plain version."""
  bd, kind, with_sl, scaled, clamp = draw
  kw = draw_call(kind, bd, with_sl, scaled, clamp, n=21, seed=5,
                 device=cuda)
  err = TT.error_word(cuda)
  got = TT.residual_planes(**kw, err=err)
  assert torch.equal(got, TT.residual_planes_plain(**kw))
  assert err.item() == 0


@pytest.mark.gpu
def test_residual_planes_does_not_wait_for_the_card(cuda):
  """The wrapper queues its launches and returns: behind a long sleep of
  the card, an event recorded just after the call is still pending; the
  result is then right and the error word 0."""
  import time

  kw = _call(DRAWS[0], cuda)
  err = TT.error_word(cuda)
  want = TT.residual_planes_plain(**kw)
  TT.residual_planes(**kw, err=err)  # the build and the device tables
  torch.cuda.synchronize()
  torch.cuda._sleep(400_000_000)     # cycles: about 0.2 s
  t0 = time.perf_counter()
  got = TT.residual_planes(**kw, err=err)
  after = torch.cuda.Event()
  after.record()
  host_s = time.perf_counter() - t0
  assert not after.query(), f"the call waited ({host_s} s)"
  torch.cuda.synchronize()
  assert torch.equal(got, want) and err.item() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("fetch", [True, False], ids=["fetch", "no-fetch"])
def test_session_raises_on_residual_error_word_on_card(cuda, monkeypatch,
                                                       fetch):
  """A row out of range in the second frame's luma call: the kernel sets
  the frame's error word and the session raises, naming it, before it
  hands that frame (or a later one) out."""
  _session_refuses(monkeypatch, cuda, fetch)


@pytest.mark.gpu
def test_wave_path_raises_on_residual_error_word_on_card(cuda, monkeypatch):
  from ffmpeg_tpu_torch.parallel.mesh import make_mesh

  _wave_path_refuses(monkeypatch, cuda, make_mesh(1, frame_axis=1))


def _residual_calls_on_card(data, device, n_frames=None):
  """Walk a stream on the card holding every residual call against the
  plain version, tolerance 0; returns the calls' plane kinds and the
  frames."""
  from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
  from ffmpeg_tpu_torch.models.vvc.pipeline import KERNELS, walk_frames

  seen = []

  def check(name, label, kw):
    got = KERNELS[name][0](**kw)
    if name == "residual":
      assert torch.equal(got, TT.residual_planes_plain(**kw)), label
      seen.append(label)
    return got

  aus = VVCDecoder(device=device)._split_aus(data)[:n_frames]
  frames = sum(1 for _ in walk_frames(aus, device, check))
  return seen, frames


@pytest.mark.gpu
@pytest.mark.parametrize("name,n_frames", [
    ("full1080", 2), ("ctu128_1080", 2), ("ciip64", None),
    ("ai256x128_10b", None), ("gop720", 3)])
def test_residual_kernel_on_fixture_frames_on_card(cuda, name, n_frames):
  """Every residual call of the fixtures' first frames (the main path;
  CTU-128 with TB-64, ISP, scaling lists and LFNST; CIIP-64; 10 bits)
  equal to the plain version, luma then Cb+Cr on each frame."""
  seen, frames = _residual_calls_on_card(_read(name), cuda, n_frames)
  assert seen == ["luma", "chroma"] * frames


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["isp", "isp-dualtree", "tb64",
                                  "scaling-inter", "ctu128-tools-ra"])
def test_residual_kernel_on_coding_cases_on_card(cuda, case):
  seen, frames = _residual_calls_on_card(_stream(CODING_CASES[case]), cuda)
  assert seen == ["luma", "chroma"] * frames


@pytest.mark.gpu
def test_residual_kernel_on_mono_frame_on_card(cuda):
  """The 4:0:0 stream on the card: one residual call a frame, equal to
  the plain version."""
  calls = TT.CALLS["residual"]
  seen, frames = _residual_calls_on_card(_stream(ALF_MONO), cuda)
  assert frames and seen == ["luma"] * frames
  assert TT.CALLS["residual"] == calls + frames


@pytest.mark.gpu
@pytest.mark.parametrize("which", sorted(BAD_ROWS) + ["shift"])
def test_residual_kernel_bad_row_raises(cuda, which):
  """A row out of range sets the kernel's error word, which names it
  when read (raise_on_error), and its TU writes nothing; a dequant shift
  past 31 (undefined in C) too."""
  kw = _bad_row_call("kind" if which == "shift" else which, cuda)
  if which == "shift":
    b = kw["buckets"][0][(8, 8)]
    b["mat"][BUCKET_ROWS.index("trv"), 1] = 0
    b["mat"][BUCKET_ROWS.index("shift"), 0] = 40
  msg = {"kind": "transform kind", "vpdu": "vpdu", "slid": "scaling-list",
         "place": "leaves the plane", "shift": "dequant shift"}[which]
  err = TT.error_word(cuda)
  got = TT.residual_planes(**kw, err=err)
  with pytest.raises(RuntimeError, match=msg):
    TT.raise_on_error(int(err.item()))
  # the bad TU (index 0 or 1 of the 8x8 class, at its own x0, y0) is 0
  b = kw["buckets"][0][(8, 8)]["mat"]
  bad = 0 if which == "shift" else 1
  x0, y0 = (int(b[BUCKET_ROWS.index(k), bad]) for k in ("x0", "y0"))
  if which != "place":
    assert not got[0, y0:y0 + 8, x0:x0 + 8].any()


@pytest.mark.gpu
def test_residual_kernel_empty_call_on_card(cuda):
  """A call without TUs launches nothing and gives zero planes."""
  kw = draw_call("chroma", 8, n=2, device=cuda)
  for comp in kw["buckets"]:
    for wh, b in comp.items():
      comp[wh] = dict(b, mat=b["mat"][:, :0].contiguous(),
                      lv=b["lv"][:0].contiguous(), n=0)
  launches = TT.LAUNCHES["residual"]
  err = TT.error_word(cuda)
  got = TT.residual_planes(**kw, err=err)
  assert not got.any() and TT.LAUNCHES["residual"] == launches
  assert err.item() == 0


@pytest.mark.gpu
def test_residual_build_failure_raises(cuda, tmp_path, monkeypatch):
  from ffmpeg_tpu_torch.utils import build

  (tmp_path / "residual.cu").write_text("this is not CUDA\n")
  monkeypatch.setattr(TT, "_SRC", str(tmp_path / "residual.cu"))
  monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
  monkeypatch.setattr(TT, "_lib", None)
  with pytest.raises(RuntimeError, match="nvcc failed"):
    TT._get_kernel()
