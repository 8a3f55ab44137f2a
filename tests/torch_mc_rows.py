"""Seeded random MC batches for the inter-prediction tests, without JAX
(the card's test run has none): rows with every mode, laid out as
inputs._layout_ctrl lays out a frame's batch."""
import numpy as np

from ffmpeg_tpu_torch.models.vvc import inputs as TI
from ffmpeg_tpu_torch.models.vvc.mc_tiles import offsets
from ffmpeg_tpu_torch.ops import inter as TIP


def random_rows(rng, n, H, W, n_refs, is_chroma, bd, dmvr=False):
  """n MC units with every mode: MVs far outside the picture, uni/bi,
  default, explicit and BCW weights, GPM, BDOF (bi, <= 16x16) and PROF
  (4x4).  With dmvr, a third of the units are DMVR units (bi, at least
  8x8 and 128 samples, some with BDOF): original MVs om* and refined MVs
  up to 2.5 samples away, mirrored between the lists, so that the
  refined reads cross the original MV's window; some of them sit at the
  picture's edges."""
  r = {k: np.zeros(n, np.int32) for k in TI.INTER_KEYS}
  sizes = np.array([4, 8, 16, 32])
  r["w"] = sizes[rng.integers(0, 4, n)]
  r["h"] = sizes[rng.integers(0, 4, n)]
  r["x0"] = rng.integers(0, W // 4, n) * 4
  r["y0"] = rng.integers(0, H // 4, n) * 4
  r["pf"] = rng.integers(1, 4, n)
  span = 4 * max(H, W) * (32 if is_chroma else 16)
  for k in ("m0x", "m0y", "m1x", "m1y"):
    r[k] = rng.integers(-span, span, n)
  r["r0slot"] = rng.integers(0, n_refs, n)
  r["r1slot"] = rng.integers(0, n_refs, n)
  r["wden"] = np.where(rng.random(n) < 0.4, -1, rng.integers(0, 8, n))
  r["w0"], r["w1"] = rng.integers(-128, 256, n), rng.integers(-128, 256, n)
  r["wo0"], r["wo1"] = rng.integers(-128, 128, n), rng.integers(-128, 128, n)
  for a, b in TIP._CR_WEIGHTS:
    r[b] = rng.integers(-128, 256, n) if a[1] != "o" else rng.integers(
        -128, 128, n)
  r["hpel"] = rng.integers(0, 3, n)
  gpm = rng.random(n) < 0.2
  r["gpm_part"] = np.where(gpm, rng.integers(1, 65, n), 0)
  if not is_chroma:
    bdof = (rng.random(n) < 0.3) & ~gpm
    r["bdof"] = bdof.astype(np.int32)
    r["pf"] = np.where(bdof, 3, r["pf"])
    r["wden"] = np.where(bdof & (rng.random(n) < 0.7), -1, r["wden"])
    r["w"] = np.where(bdof, np.minimum(r["w"], 16), r["w"])
    r["h"] = np.where(bdof, np.minimum(r["h"], 16), r["h"])
    prof = (rng.random(n) < 0.3) & ~bdof
    r["prof"] = np.where(prof, rng.integers(1, 4, n), 0)
    r["w"] = np.where(prof, 4, r["w"])
    r["h"] = np.where(prof, 4, r["h"])
    for k in ("pdhx0", "pdhy0", "pdvx0", "pdvy0", "pdhx1", "pdhy1", "pdvx1",
              "pdvy1"):
      r[k] = rng.integers(-600, 600, n)
  if dmvr:
    _dmvr_rows(rng, r, H, W, is_chroma)
    gpm &= r["dmvr"] == 0
    r["gpm_part"] = np.where(gpm, r["gpm_part"], 0)
  gwt = rng.integers(0, 9, (n, 32, 32))
  gslot = np.where(gpm, np.arange(n), 0)
  return r, gwt, gslot


def _dmvr_rows(rng, r, H, W, is_chroma):
  """Make a third of the rows DMVR units, in place (see random_rows)."""
  n = len(r["w"])
  on = rng.random(n) < 1 / 3
  sizes = np.array([8, 16, 32])
  r["w"] = np.where(on, sizes[rng.integers(0, 3, n)], r["w"])
  r["h"] = np.where(on, sizes[rng.integers(0, 3, n)], r["h"])
  r["h"] = np.where(on & (r["w"] * r["h"] < 128), 16, r["h"])
  # units at the picture's corners and edges, and inside it
  edge = on & (rng.random(n) < 0.4)
  far = rng.random((2, n)) < 0.5
  r["x0"] = np.where(edge, far[0] * np.maximum(W - r["w"], 0), r["x0"])
  r["y0"] = np.where(edge, far[1] * np.maximum(H - r["h"], 0), r["y0"])
  fb = 5 if is_chroma else 4
  for lx in (0, 1):
    # original MVs a few samples around the unit (or across the edge)
    om = {a: rng.integers(-6 << fb, 6 << fb, n) for a in "xy"}
    for a in "xy":
      r[f"om{lx}{a}"] = np.where(on, om[a], 0)
  for a in "xy":
    d = rng.integers(-40, 41, n)  # the refinement, mirrored
    r[f"m0{a}"] = np.where(on, r[f"om0{a}"] + d, r[f"m0{a}"])
    r[f"m1{a}"] = np.where(on, r[f"om1{a}"] - d, r[f"m1{a}"])
  r["dmvr"] = on.astype(np.int32)
  r["pf"] = np.where(on, 3, r["pf"])
  r["wden"] = np.where(on, -1, r["wden"])
  r["prof"] = np.where(on, 0, r["prof"])
  r["hpel"] = np.where(on, 0, r["hpel"])
  if not is_chroma:
    bdof = on & (r["w"] <= 16) & (r["h"] <= 16) & (rng.random(n) < 0.5)
    r["bdof"] = np.where(on, bdof, r["bdof"]).astype(np.int32)


def random_lmcs(rng, bd):
  """LMCS forward tables as the host builds them (inputs._lmcs_inputs):
  16 codewords around the uniform one, their pivots and scales."""
  org = 1 << (bd - 4)
  cw = org + rng.integers(-(org // 4), org // 4 + 1, 16)
  while cw.sum() > (1 << bd) - 1:
    cw[np.argmax(cw)] -= 1
  pivot = np.concatenate([[0], np.cumsum(cw)]).astype(np.int32)
  fwd = ((cw << 11) + (org >> 1)) >> (bd - 4)
  inv = np.where(cw > 0, ((org << 11) + (cw >> 1)) // np.maximum(cw, 1), 0)
  return {"pivot": pivot, "fwd_scale": fwd.astype(np.int32),
          "inv_scale": inv.astype(np.int32),
          "bins": np.array([0, 15], np.int32)}


def batch(rows, gwt, gslot, is_chroma):
  """The host layout of an MC batch (inputs._layout_ctrl's `inter`):
  int32 rows, GPM weights, tile offsets and the kernel's work lists."""
  out = {k: np.asarray(v, np.int32) for k, v in rows.items()}
  out["gwt"], out["gslot"] = np.asarray(gwt, np.int32), np.asarray(gslot,
                                                                   np.int32)
  out["toff"] = offsets(out["w"], out["h"])
  out["small"], out["large"] = TI.mc_size_classes(
      out["w"], out["h"], 0 if is_chroma else out["bdof"])
  return out
