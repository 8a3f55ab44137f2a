"""Seeded draws of the residual stage's inputs, without JAX (the card has
none): a size class's bucket rows and level blocks, explicit scaling
lists, and whole calls of the frame program's residual entry point
(ops/transform.py residual_planes) with their TUs placed in the plane.
"""
import numpy as np
import torch

from ffmpeg_tpu_torch.models.vvc import inputs as TI
from ffmpeg_tpu_torch.ops.transform import BUCKET_ROWS

# every luma class a frame may carry: the 2-D classes, then those of ISP,
# TB-64 and ISP-64 (inputs.luma_sizes with every tool)
LUMA_ALL = (TI.LUMA_SIZES + TI.ISP_EXTRA_SIZES + TI.TB64_EXTRA_SIZES
            + TI.ISP64_EXTRA_SIZES)
# LMCS chroma scales per draw
N_VPDU = 12


def _random_bucket(rng, w, h, bd, is_chroma, n=24, clamp=False):
  """A size class's bucket rows and level blocks, each TU with a random
  qp's dequant scale and shift (transform skip's for a quarter of the
  TUs, where the block is not zeroed out), MTS kinds where the dimension
  has them, LFNST on a third of the luma TUs of at least 4x4, a joint
  CbCr mode on chroma, and a scaling-list matrix id (-1: flat).  clamp:
  levels at the 16-bit limits (-32768, 32767) where they are coded, and
  qp 40..51, so that the dequant products wrap in 32 bits and the
  dequantized values sit at the 16-bit clamp."""
  zw, zh = min(w, 32), min(h, 32)
  r = {k: np.zeros(n, np.int32) for k in BUCKET_ROWS}
  qp = rng.integers(40 if clamp else 0, 52, n) + TI._QP_TAB_OFF
  sc, sh = TI._scale_shift_tables(w.bit_length() - 1, h.bit_length() - 1, bd)
  sc_ts, sh_ts = TI._scale_shift_tables_ts()
  ts = (rng.random(n) < 0.25) & ((zw, zh) == (w, h))
  r["scale"] = np.where(ts, sc_ts[qp], sc[qp])
  r["shift"] = np.where(ts, sh_ts[qp], sh[qp])
  r["ts"] = ts.astype(np.int32)
  one_d = w == 1 or h == 1
  mts_max = 16 if one_d else 32
  for row, d in (("trh", w), ("trv", h)):
    if 4 <= d <= mts_max:
      r[row] = rng.integers(0, 3, n)
  if not is_chroma and w >= 4 and h >= 4:
    r["lf_sel"] = np.where(rng.random(n) < 0.35, rng.integers(0, 8, n), -1)
    r["lf_tr"] = rng.integers(0, 2, n)
  else:
    r["lf_sel"][:] = -1
  if is_chroma:
    r["jop"] = rng.integers(0, 5, n)
  r["slid"] = rng.integers(-1, 28, n)
  if clamp:
    lv = rng.choice([-32768, 32767], (n, zh, zw))
  else:
    lv = rng.integers(-300, 301, (n, zh, zw))
  lv = lv * (rng.random((n, zh, zw)) < 0.3)
  mat = np.stack([r[k] for k in BUCKET_ROWS]).astype(np.int32)
  return mat, lv.astype(np.int32)


def _scaling_lists(rng):
  return {"rec": rng.integers(1, 256, (28, 8, 8)).astype(np.int32),
          "dc": rng.integers(1, 256, 14).astype(np.int32)}


def draw_call(kind, bd, with_sl=False, scaled=False, clamp=False, n=6,
              seed=0, device="cpu"):
  """residual_planes kwargs of one seeded call: "luma" (every class of
  LUMA_ALL, one component) or "chroma" (the 25 chroma classes, Cb and
  Cr), n TUs a class, each class's TUs side by side in a band of its own
  height so that none overlap (the last ends at the plane's right edge);
  a per-VPDU LMCS scale for each of N_VPDU VPDUs (chroma, `scaled`);
  explicit scaling lists (`with_sl`).  An empty class is kept between
  the others."""
  rng = np.random.default_rng(seed)
  chroma = kind == "chroma"
  sizes = list(TI.CHROMA_SIZES if chroma else LUMA_ALL)
  Wp = n * 64
  Hp = sum(h for _, h in sizes)
  k = BUCKET_ROWS.index
  comps = []
  for _ in range(2 if chroma else 1):
    comp, y = {}, 0
    for j, (w, h) in enumerate(sizes):
      mat, lv = _random_bucket(rng, w, h, bd, chroma, n=n, clamp=clamp)
      mat[k("y0")] = y
      mat[k("x0")] = np.arange(n) * w + (Wp - n * w)
      mat[k("vpdu")] = rng.integers(0, N_VPDU, n)
      live = 0 if j == 3 else n
      comp[(w, h)] = {"mat": torch.from_numpy(mat[:, :live].copy()).to(device),
                      "lv": torch.from_numpy(lv[:live].copy()).to(device),
                      "n": live}
      y += h
    comps.append(comp)
  sl = None
  if with_sl:
    sl = {key: torch.from_numpy(v).to(device)
          for key, v in _scaling_lists(rng).items()}
  scale = None
  if scaled:
    scale = torch.from_numpy(
        rng.integers(1, 1 << 13, N_VPDU).astype(np.int32)).to(device)
  return dict(buckets=comps, sizes=sizes, Hp=Hp, Wp=Wp, bit_depth=bd,
              chroma=chroma, chroma_scale=scale, sl=sl)
