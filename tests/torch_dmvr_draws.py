"""Seeded DMVR search calls for the search tests, without JAX (the card's
test run has none): reference planes and the (10, n) subblock rows that
ops/dmvr.py refine_subblocks takes (s1 already offset by the L0 count),
and a numpy reading of the SADs that names the cases a call holds."""
import numpy as np

from ffmpeg_tpu_torch.ops import dmvr as TD

SHAPES = ((16, 16), (8, 16), (16, 8))
# draws: their picture (W, H), padded plane (Wp, Hp), L0 and L1 slots
KINDS = {"branches": ((96, 64), (128, 80), 2, 2),
         "edges": ((80, 48), (128, 80), 2, 1),
         "cases": ((128, 96), (128, 96), 1, 1),
         "parabolas": ((96, 24), (96, 24), 1, 1),
         "slots30": ((64, 48), (64, 48), 15, 15),
         "flat": ((64, 48), (64, 48), 2, 3)}
# the flat draws' levels, one a picture: L0's, then L1's, so that a
# subblock's lists differ by 0, 1, 3, 37, 39 or 40 at every sample
FLAT_LEVELS = (100, 140, 101, 100, 103)
# rows of list 0's and list 1's pictures (one level per column, every row
# alike) under a 16x16 subblock and its window (columns x - 2 .. x + 17):
# their SADs at horizontal offsets -2..2 are 92, 72, 96, 72, 76 (flat
# parabola, denom 0), 76, 72, 96, 88, 76 (the left neighbour equal to the
# biased centre, -8) and 88, 64, 80, 60, 88 (the right, +8), times the 8
# rows; the centre wins each, its 96 or 80 biased to 72 or 60
PARABOLAS = (
    ((12, 0, 8, 0, 8, 12, 12, 4, 0, 12, 8, 4, 8, 0, 12, 0, 0, 4, 4, 8),
     (8, 8, 0, 12, 0, 4, 8, 12, 8, 4, 8, 12, 4, 0, 8, 12, 4, 4, 4, 4)),
    ((4, 8, 12, 12, 0, 8, 12, 4, 4, 12, 8, 8, 8, 8, 12, 12, 0, 0, 8, 12),
     (0, 8, 12, 12, 12, 0, 8, 12, 4, 0, 4, 0, 0, 12, 8, 12, 12, 12, 4, 4)),
    ((0, 12, 4, 12, 0, 4, 12, 4, 0, 8, 8, 4, 12, 0, 8, 8, 12, 12, 12, 12),
     (0, 12, 0, 4, 4, 4, 0, 0, 4, 4, 0, 12, 0, 0, 12, 12, 12, 8, 8, 0)))


def _noise(rng, Hp, Wp, H, W, bd):
  """A picture of smooth and sharp regions over a padded plane whose
  padding holds values no picture sample takes."""
  plane = rng.integers(1 << bd, 1 << 20, (Hp, Wp)).astype(np.int32)
  low = rng.integers(0, 1 << bd, (H // 4 + 2, W // 4 + 2))
  smooth = np.kron(low, np.ones((4, 4)))[:H, :W]
  sharp = rng.integers(0, 1 << bd, (H, W))
  plane[:H, :W] = np.where(rng.random((H, W)) < 0.3, sharp, smooth)
  return plane


def _levels(rng, Hp, Wp, H, W, bd):
  """A picture of few levels (two or three, in blocks and stripes), so
  that SADs tie and parabolas come out flat."""
  plane = np.zeros((Hp, Wp), np.int32)
  lv = rng.choice([0, 1 << (bd - 4), 1 << (bd - 3)], size=3, replace=False)
  kind = rng.integers(0, 3)
  yy, xx = np.mgrid[:H, :W]
  if kind == 0:
    pat = (xx // int(rng.integers(1, 4))) % 2
  elif kind == 1:
    pat = (yy // int(rng.integers(1, 4))) % 2
  else:
    pat = rng.integers(0, 3, (H // 2 + 1, W // 2 + 1)).repeat(2, 0).repeat(
        2, 1)[:H, :W]
  plane[:H, :W] = lv[pat % 3]
  return plane


def draw(kind: str, bit_depth: int, seed: int, n: int = 192):
  """A search call of `kind` (KINDS): {planes: numpy (Hp, Wp) int32
  [L0..., L1...], ctrl: (10, n) int32, n_l0, H, W, bit_depth}.
  branches: noise pictures, each list's MV whole, horizontal, vertical
  or diagonal sub-pel (the four bilinear branches).  edges: units at and
  past each picture edge, windows wholly outside, garbage padding.
  cases: few-level pictures, whole MVs, list 1 a few samples from list 0
  on one picture (the SADs' corner cases, see classify).  parabolas: the
  three PARABOLAS subblocks, each centre's parametric step a special case
  (10 bits; seed and n unused).  slots30: 15 L0 and 15 L1 planes of one
  picture each.  flat: pictures of one level each (FLAT_LEVELS), so that
  all 25 SADs of a subblock tie (the centre's bias then decides, or the
  search stops at it), half the subblocks with whole MVs."""
  rng = np.random.default_rng(seed)
  (W, H), (Wp, Hp), n_l0, n_l1 = KINDS[kind]
  if kind == "parabolas":
    return _parabolas(W, H)
  slots = n_l0 + n_l1
  if kind == "flat":
    pics = [np.full((Hp, Wp), v, np.int32) for v in FLAT_LEVELS]
  else:
    make = _levels if kind == "cases" else _noise
    pics = [make(rng, Hp, Wp, H, W, bit_depth) for _ in range(slots)]
  shape = np.array(SHAPES)[rng.integers(0, 3, n)]
  w, h = shape[:, 0], shape[:, 1]
  x = rng.integers(0, (W - w) // 8 + 1) * 8
  y = rng.integers(0, (H - h) // 8 + 1) * 8
  s0 = rng.integers(0, n_l0, n)
  s1 = n_l0 + rng.integers(0, n_l1, n)
  if kind == "edges":
    # a quarter at each edge, MVs out to 48 samples past it
    side = np.arange(n) % 4
    x = np.where(side == 0, 0, np.where(side == 1, W - w, x))
    y = np.where(side == 2, 0, np.where(side == 3, H - h, y))
    out = rng.integers(-48 * 16, 48 * 16, (4, n))
    push = np.stack([np.where(side == 0, -1, np.where(side == 1, 1, 0)),
                     np.where(side == 2, -1, np.where(side == 3, 1, 0))])
    mv = np.concatenate([out[:2] + push * 40 * 16, out[2:] + push * 24 * 16])
  else:
    mv = rng.integers(-6 * 16, 6 * 16, (4, n))
  if kind == "flat":
    mv[:, ::2] &= ~15
  if kind == "branches":
    # each list: whole, horizontal, vertical or diagonal sub-pel
    for lx in range(2):
      br = rng.integers(0, 4, n)
      fx = np.where(br & 1, rng.integers(1, 16, n), 0)
      fy = np.where(br & 2, rng.integers(1, 16, n), 0)
      mv[2 * lx] = (mv[2 * lx] & ~15) | fx
      mv[2 * lx + 1] = (mv[2 * lx + 1] & ~15) | fy
  if kind == "cases":
    # whole MVs; list 1 on list 0's picture, 0 to 3 samples away
    mv &= ~15
    d = rng.integers(-3, 4, (2, n)) * 16
    mv[2], mv[3] = mv[0] + d[0], mv[1] + d[1]
    pics[1] = pics[0]
  ctrl = np.stack([x, y, w, h, *mv, s0, s1]).astype(np.int32)
  return {"planes": pics, "ctrl": ctrl, "n_l0": n_l0, "H": H, "W": W,
          "bit_depth": bit_depth}


def _parabolas(W, H):
  pics = [np.zeros((H, W), np.int32) for _ in range(2)]
  xs = 8 + 32 * np.arange(len(PARABOLAS))
  for x, rows in zip(xs, PARABOLAS):
    for pic, row in zip(pics, rows):
      pic[:, x - 2:x + 18] = row
  n = len(xs)
  ctrl = np.stack([xs, np.full(n, 4), np.full(n, 16), np.full(n, 16),
                   *np.zeros((4, n), np.int64), np.zeros(n, np.int64),
                   np.ones(n, np.int64)]).astype(np.int32)
  return {"planes": pics, "ctrl": ctrl, "n_l0": 1, "H": H, "W": W,
          "bit_depth": 10}


def classify(call) -> dict:
  """Counts of the SAD cases among a call's subblocks whose MVs are whole
  at 10 bits (the prediction is the window itself), read with numpy:
  no_search (biased centre below w * h), border (best offset on the
  5 x 5 border), interior (the parametric step runs), ties (the minimum
  taken more than once), all_tie and all_tie_search (all 25 SADs equal
  before the centre's bias, and among those the searches that run), and
  among interior ones denom0 (a direction's parabola flat), minus_eq and
  plus_eq (a neighbour equal to the minimum, the -8 and +8 cases)."""
  c = dict(zip(TD.CTRL_KEYS, call["ctrl"].astype(np.int64)))
  H, W = call["H"], call["W"]
  out = dict.fromkeys(("no_search", "border", "interior", "ties", "all_tie",
                       "all_tie_search", "denom0", "minus_eq", "plus_eq"), 0)
  if call["bit_depth"] != 10:
    return out
  idx = np.arange(TD._WIN)
  for i in range(len(c["x"])):
    if any(c[k][i] & 15 for k in ("mx0", "my0", "mx1", "my1")):
      continue
    t = []
    for lx in range(2):
      p = call["planes"][c[f"s{lx}"][i]]
      ys = np.clip(c["y"][i] + (c[f"my{lx}"][i] >> 4) - 2 + idx, 0, H - 1)
      xs = np.clip(c["x"][i] + (c[f"mx{lx}"][i] >> 4) - 2 + idx, 0, W - 1)
      t.append(p[ys[:, None], xs[None, :]].astype(np.int64)[:20, :20])
    w, h = c["w"][i], c["h"][i]
    sad = np.array([np.abs(t[0][dy:dy + 16:2, dx:dx + 16]
                           - t[1][4 - dy:20 - dy:2, 4 - dx:20 - dx])
                    [:h // 2, :w].sum()
                    for dy in range(5) for dx in range(5)])
    tie = bool((sad == sad[0]).all())
    out["all_tie"] += tie
    sad[12] -= sad[12] >> 2
    out["all_tie_search"] += tie and sad[12] >= w * h
    if sad[12] < w * h:
      out["no_search"] += 1
      continue
    best = int(np.argmin(sad * 32 + TD._ORDER))
    out["ties"] += int((sad == sad[best]).sum() > 1)
    by, bx = divmod(best, 5)
    if min(by, bx) == 0 or max(by, bx) == 4:
      out["border"] += 1
      continue
    out["interior"] += 1
    for step in (1, 5):
      sm, sc, sp = sad[best - step], sad[best], sad[best + step]
      if sm + sp == 2 * sc:
        out["denom0"] += 1
      elif sm == sc:
        out["minus_eq"] += 1
      elif sp == sc:
        out["plus_eq"] += 1
  return out
