"""The recon kernel's schedule, checked on the CPU against the JAX
package and the native parser, at tolerance 0 (integer arithmetic).

csrc/recon.cu reconstructs each intra unit as soon as the writers of the
cells it reads are done (ops/recon.py `_wait_rects`), in place of the
host's wavefront chunks.  `dependency_levels` is the Python twin of
that wait stencil.  On intra and P/B streams of test_torch_decode.py
(with an MRL and a CIIP case), luma and chroma:

  (a) the plain per-unit reconstruction (`_intra_units` on one-unit
      windows), run level by level in the order `dependency_levels`
      gives, the units of a level shuffled with a fixed numpy seed,
      equals JAX _recon_plane;
  (b) every cell a unit waits for is written by an inter unit or by an
      intra unit earlier in layout order: the kernel's ticket order
      cannot deadlock;
  (c) the largest level equals the number of chunks the native parser
      gives with no cap on a chunk's size (chunk_cap 0), which ties the
      Python stencil to decode.cc's.

Frames are parsed in decode order; the references of P/B frames are the
planes of the port's own CPU decode of the frames before them.  JAX
runs its default non-Pallas frame program functions on the CPU."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream
from ffmpeg_tpu.models.vvc import host as JH
from ffmpeg_tpu.models.vvc import pipeline as JP
from ffmpeg_tpu_torch.models.vvc import host as TH
from ffmpeg_tpu_torch.models.vvc import inputs as TI
from ffmpeg_tpu_torch.models.vvc import mc_tiles
from ffmpeg_tpu_torch.models.vvc.convert import inputs_from_numpy
from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
from ffmpeg_tpu_torch.models.vvc.pipeline import resolve_refs, submit_frame
from ffmpeg_tpu_torch.models.vvc.recon import CTRL_KEYS
from ffmpeg_tpu_torch.ops import intra as TIn
from ffmpeg_tpu_torch.ops import recon as TR
from ffmpeg_tpu_torch.ops.inter import inter_pred
from ffmpeg_tpu_torch.ops.transform import residual_plane
from test_torch_decode import INTER_CASES, INTRA_CASES

torch.set_num_threads(2)

CASES = {case: INTRA_CASES[case] for case in (
    "dualtree-cclm-mip-mrl", "cclm-mip-ctu64-10bit", "tiles-filters")}
CASES.update({case: INTER_CASES[case] for case in (
    "ciip-deblock", "tiles-inter", "bcw")})
# the luma control row each case must exercise
COVERS = {"dualtree-cclm-mip-mrl": "mrl", "ciip-deblock": "ciipw"}


@contextlib.contextmanager
def _chunk_cap(cap):
  """The port's parser with another chunk cap (0: no cap)."""
  old = TH.CHUNK_CAP
  TH.CHUNK_CAP = cap
  try:
    yield
  finally:
    TH.CHUNK_CAP = old


@functools.lru_cache(maxsize=None)
def _session(case):
  """Every frame of a case in decode order: (port fs, port fs parsed with
  no chunk cap, port host inputs, JAX host inputs, per-component
  reference planes as numpy [L0..., L1...])."""
  data, _ = encode_stream(EncoderConfig(**CASES[case]))
  aus = VVCDecoder(device="cpu")._split_aus(data)
  th, th0 = TH.HostDecoder(TH.ColStore()), TH.HostDecoder(TH.ColStore())
  jh = JH.HostDecoder(JH.ColStore())
  dpb, out = {}, []
  for _, epoch, au in aus:
    tfs, jfs = th.decode_au(au, epoch), jh.decode_au(au, epoch)
    with _chunk_cap(0):
      fs0 = th0.decode_au(au, epoch)
    if tfs is None:
      continue
    t = TI.build_host_inputs(tfs)
    j = JP.build_host_inputs(jfs, jfs.ctb_log2, pallas=False)
    refs = [[r.numpy() for r in comp]
            for comp in resolve_refs(tfs, dpb, "cpu")]
    out.append((tfs, fs0, t, j, refs))
    _, dpb[tfs.poc] = submit_frame(t, tfs, "cpu", dpb)
  return out


def _t(a):
  return torch.from_numpy(np.array(a, np.int32))


def _residuals(fs, j):
  (Hp_y, Wp_y), (Hp_c, Wp_c) = TI._padded_plane_shapes(fs.width, fs.height,
                                                       fs.ctb_log2)
  tj = inputs_from_numpy({"planes": j["planes"], "ctrl": {}}, "cpu")
  return [residual_plane(tj["planes"][c]["buckets"],
                         Hp_y if c == 0 else Hp_c, Wp_y if c == 0 else Wp_c,
                         fs.bit_depth,
                         TI.LUMA_SIZES if c == 0 else TI.CHROMA_SIZES, c > 0,
                         "cpu").numpy() for c in range(len(j["planes"]))]


def _recon_jax(res, inter, n_inter, intra, n_chunks, refs, cclm, *, maxs,
               is_chroma, bit_depth, cr_weights, wrap):
  return JP._recon_plane(res, inter, n_inter, intra, n_chunks, refs,
                         maxs_inter=maxs, maxs_intra=maxs, is_chroma=is_chroma,
                         bit_depth=bit_depth, cr_weights=cr_weights,
                         cclm=cclm, wrap=wrap)


# one compile per shape, shared by the frames and cases that have it
_RECON_JAX = jax.jit(_recon_jax, static_argnames=(
    "maxs", "is_chroma", "bit_depth", "cr_weights", "wrap"))


@functools.lru_cache(maxsize=None)
def _jax_recon(case, i):
  """JAX _recon_plane of frame i: its residual planes and the [Y, Cb, Cr]
  reconstructions, chroma CCLM from the JAX luma."""
  fs, _, _, j, refs = _session(case)[i]
  bd, H, W = fs.bit_depth, fs.height, fs.width
  res = _residuals(fs, j)
  planes = []
  for c_idx in range(len(res)):
    ss = 0 if c_idx == 0 else 1
    jc = j["ctrl"]["y" if c_idx == 0 else "c"]
    maxs = min(32, (1 << fs.ctb_log2) >> ss)
    stack = (np.stack([r[:H >> ss, :W >> ss] for r in refs[c_idx]]) if refs
             else np.zeros((1, H >> ss, W >> ss), np.int32))
    cclm = None
    if c_idx and "cclm_vc" in j:
      luma = jnp.asarray(planes[0])
      cclm = (luma, JP.I.cclm_dsy_plane(luma, j["cclm_vc"]), j["cclm_vc"])
    # int32, as the JAX frame program widens its packed inputs on device
    jin, jia = ({k: jnp.asarray(np.asarray(v, np.int32))
                 for k, v in jc[k].items()} for k in ("inter", "intra"))
    planes.append(np.asarray(_RECON_JAX(
        jnp.asarray(res[c_idx]), jin, jc["n_inter"], jia, jc["n_chunks"],
        jnp.asarray(stack), cclm, maxs=maxs, is_chroma=c_idx > 0,
        bit_depth=bd, cr_weights=c_idx == 2, wrap=fs.wrap_off >> ss)))
  return res, planes


def _n_units(ct):
  return int(ct["intra"]["iend_host"][-1]) if ct["n_chunks"] else 0


def _recon_by_levels(res, ct, tiles, *, maxs, is_chroma, bit_depth, cclm,
                     seed):
  """One channel: the inter placement (recon_plane_plain with no chunk),
  then each intra unit alone through _intra_units, level by level, the
  units of a level in a shuffled order."""
  intra, n = ct["intra"], _n_units(ct)
  levels = TR.dependency_levels(intra, n, is_chroma=is_chroma)
  plane = TR.recon_plane_plain(res, intra, 0, maxs=maxs, is_chroma=is_chroma,
                               bit_depth=bit_depth, cclm=cclm,
                               inter=ct["inter"], tiles=tiles)
  Hp, Wp = plane.shape
  flat = torch.cat([plane.reshape(-1), plane.new_zeros(1)])
  blocks = None if tiles is None else mc_tiles.unpack(
      tiles, ct["inter"]["toff"], ct["inter"]["w"], ct["inter"]["h"])
  rows = intra["mat_host"]
  rng = np.random.default_rng(seed)
  for level in range(1, int(levels.max(initial=0)) + 1):
    units = np.flatnonzero(levels == level)
    rng.shuffle(units)
    for u in units:
      c = {k: intra[k][u:u + 1] for k in (*TI.INTRA_KEYS, "ipos")}
      blk = TR._intra_units(flat[:Hp * Wp].view(Hp, Wp), res, c,
                            TR._present(rows[:, u:u + 1]), maxs=maxs,
                            is_chroma=is_chroma, bit_depth=bit_depth,
                            cclm=cclm, tiles=blocks)
      TR._scatter(flat, Wp, blk, c, c["w"] > 0, maxs)
  return flat[:Hp * Wp].view(Hp, Wp).numpy()


@pytest.mark.parametrize("tag", ["y", "c"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_level_order_matches_jax(case, tag):
  """(a): one unit at a time in dependency-level order, shuffled within
  each level, gives JAX's planes."""
  is_chroma = tag == "c"
  n_units = 0
  for i, (fs, _, t, _, refs) in enumerate(_session(case)):
    res, want = _jax_recon(case, i)
    if is_chroma and len(res) == 1:
      continue
    ss = int(is_chroma)
    bd, H, W = fs.bit_depth, fs.height >> ss, fs.width >> ss
    inp = inputs_from_numpy(t, "cpu")
    ct = inp["ctrl"][tag]
    chans = [1, 2] if is_chroma else [0]
    tiles = None
    if ct["inter"]["n_mc"]:
      tiles = inter_pred([[_t(r) for r in refs[c]] for c in chans],
                         ct["inter"], H=H, W=W, is_chroma=is_chroma,
                         bit_depth=bd, wrap=fs.wrap_off >> ss)
    cclm = None
    if is_chroma and "cclm_vc" in inp:
      luma = _t(want[0])
      cclm = (luma, TIn.cclm_dsy_plane(luma, inp["cclm_vc"]))
    for ch, c_idx in enumerate(chans):
      got = _recon_by_levels(
          _t(res[c_idx]), ct, tiles[ch] if tiles is not None else None,
          maxs=min(32, (1 << fs.ctb_log2) >> ss), is_chroma=is_chroma,
          bit_depth=bd, cclm=cclm, seed=1000 * i + c_idx)
      np.testing.assert_array_equal(got, want[c_idx],
                                    err_msg=f"frame {i} plane {c_idx}")
    n_units += _n_units(ct)
  assert n_units > 0


def _owners(ct, Hp, Wp, C=TR.CELL):
  """Per C x C cell of the plane: the layout index of the intra unit
  that writes it, -1 for a pure inter unit, -2 for none."""
  own = np.full((Hp // C, Wp // C), -2, np.int64)
  mc = ct["inter"]["mat_host"]
  for u in range(ct["inter"]["n_inter"]):
    x0, y0, w, h = (int(v) for v in mc[:4, u])
    own[y0 // C:(y0 + h + C - 1) // C, x0 // C:(x0 + w + C - 1) // C] = -1
  rows = ct["intra"]["mat_host"]
  K = {k: TI.INTRA_KEYS.index(k) for k in ("x0", "y0", "w", "h")}
  for u in range(_n_units(ct)):
    x0, y0, w, h = (int(rows[K[k], u]) for k in ("x0", "y0", "w", "h"))
    assert not (own[y0 // C:(y0 + h) // C, x0 // C:(x0 + w) // C] >= 0).any()
    own[y0 // C:(y0 + h) // C, x0 // C:(x0 + w) // C] = u
  return own


@pytest.mark.parametrize("case", sorted(CASES))
def test_wait_cells_written_earlier(case):
  """(b): the writer of every cell in a unit's wait set is a pure inter
  unit or an intra unit earlier in layout order (so a lower ticket), and
  no two intra units write one cell."""
  waits = 0
  covered = 0
  for fs, _, t, _, _ in _session(case):
    shapes = TI._padded_plane_shapes(fs.width, fs.height, fs.ctb_log2)
    for tag, (Hp, Wp) in zip(("y", "c"), shapes):
      if tag == "c" and fs.chroma_format_idc == 0:
        continue
      ct = inputs_from_numpy(t, "cpu")["ctrl"][tag]
      own = _owners(ct, Hp, Wp)
      rows = ct["intra"]["mat_host"]
      K = {k: TI.INTRA_KEYS.index(k) for k in TI.INTRA_KEYS}
      for u in range(_n_units(ct)):
        r = 0 if tag == "c" else int(rows[K["mrl"], u])
        for a, b, c, d in TR._wait_rects(
            *(int(rows[K[k], u]) for k in ("x0", "y0", "avail_l", "avail_t",
                                           "cand_up_left")), r):
          cells = own[a:b, c:d]
          assert cells.size and ((cells == -1) | ((cells >= 0)
                                                  & (cells < u))).all(), (
              f"poc {fs.poc} {tag} unit {u}: writers {np.unique(cells)}")
          waits += cells.size
      if tag == "y" and case in COVERS:
        covered += int((rows[K[COVERS[case]], :_n_units(ct)] > 0).sum())
  assert waits > 0
  assert covered > 0 or case not in COVERS


@pytest.mark.parametrize("case", sorted(CASES))
def test_levels_equal_uncapped_chunks(case):
  """(c): the critical path of the Python stencil is the native parser's
  chunk count with no cap on a chunk's size."""
  chunk = CTRL_KEYS.index("chunk")
  for fs, fs0, t, _, _ in _session(case):
    inp = inputs_from_numpy(t, "cpu")
    for tag, mat in (("y", fs0.ctrl_y), ("c", fs0.ctrl_c)):
      if tag == "c" and fs.chroma_format_idc == 0:
        continue
      ct = inp["ctrl"][tag]
      n = _n_units(ct)
      levels = TR.dependency_levels(ct["intra"], n, is_chroma=tag == "c")
      want = int(mat[chunk].max()) + 1 if (mat[chunk] >= 0).any() else 0
      assert int(levels.max(initial=0)) == want, f"poc {fs.poc} {tag}"
