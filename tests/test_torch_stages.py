"""Each stage of the PyTorch port against its JAX function, bit for bit
(tolerance 0: every stage is integer arithmetic), on the same inputs:
host inputs, residual planes, intra predictors, the plain
reconstruction of an intra frame, deblock and SAO (the inter stages are
in test_torch_inter.py).  Inputs are parsed from generated
streams (ffmpeg_tpu.encoder) or drawn from a numpy seed; JAX runs on
the CPU, the port on the CPU (its plain versions)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream
from ffmpeg_tpu.models.vvc import pipeline as JP
from ffmpeg_tpu.models.vvc.host import HostDecoder as JHost
from ffmpeg_tpu.ops import deblock as JD
from ffmpeg_tpu.ops import intra as JI
from ffmpeg_tpu.ops import sao as JS
from ffmpeg_tpu_torch.models.vvc import inputs as TI
from ffmpeg_tpu_torch.models.vvc.convert import inputs_from_numpy
from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
from ffmpeg_tpu_torch.models.vvc.host import CHUNK_CAP
from ffmpeg_tpu_torch.models.vvc.host import HostDecoder as THost
from ffmpeg_tpu_torch.ops import deblock as TD
from ffmpeg_tpu_torch.ops import intra as TIn
from ffmpeg_tpu_torch.ops import recon as TR
from ffmpeg_tpu_torch.ops import sao as TS
from ffmpeg_tpu_torch.ops.transform import residual_plane

torch.set_num_threads(2)

# dual-tree intra with every intra tool of the slice + both filters
TOOLS = dict(width=128, height=96, seed=3202, qp=28, dual_tree=True,
             cclm=True, mip=True, mrl=True, deblock=True, sao=True)
# residual coverage: MTS, LFNST, transform skip and joint CbCr at 8/10/12
RESIDUAL = {bd: dict(width=96, height=64, seed=1003 + bd, qp=28, lfnst=True,
                     mts=True, joint_cbcr=True, transform_skip=True,
                     cu_qp_delta=True, bit_depth=bd)
            for bd in (8, 10, 12)}


@functools.lru_cache(maxsize=None)
def _frame(key):
  """Frame 0 of a generated stream, parsed by each package's own host
  parser: (fs, JAX host inputs, port host inputs)."""
  kw = TOOLS if key == "tools" else RESIDUAL[key]
  data, _ = encode_stream(EncoderConfig(**kw))
  au = VVCDecoder(device="cpu")._split_aus(data)[0][2]
  jfs = JHost().decode_au(au, 0)
  tfs = THost().decode_au(au, 0)
  return tfs, JP.build_host_inputs(jfs, jfs.ctb_log2, pallas=False), \
      TI.build_host_inputs(tfs)


def _np(a):
  return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("key", ["tools", 8, 10, 12])
def test_host_inputs(key):
  """The port's exact-count host inputs equal the JAX builder's live
  rows (its capacities are ratcheted above the counts)."""
  _, j, t = _frame(key)
  assert len(j["planes"]) == len(t["planes"])
  for jp, tp in zip(j["planes"], t["planes"]):
    for wh, tb in tp["buckets"].items():
      jb = jp["buckets"][wh]
      n = int(tb["n"][0])
      assert int(jb["n"][0]) == n, wh
      np.testing.assert_array_equal(_np(jb["mat"])[:, :n], _np(tb["mat"]))
      np.testing.assert_array_equal(_np(jb["lv"])[:n], _np(tb["lv"]))
  for tag in ("y", "c"):
    jc, tc = j["ctrl"][tag], t["ctrl"][tag]
    nch = int(tc["n_chunks"])
    assert int(jc["n_chunks"]) == nch and int(jc["n_inter"]) == 0
    assert int(tc["n_inter"]) == 0 and len(tc["inter"]["x0"]) == 0
    n_iu = int(tc["intra"]["iend"][-1]) if nch else 0
    for k in TI.INTRA_KEYS:
      np.testing.assert_array_equal(_np(jc["intra"][k])[:n_iu + CHUNK_CAP],
                                    _np(tc["intra"][k]), err_msg=k)
    for k in ("ioff", "iend"):
      np.testing.assert_array_equal(_np(jc["intra"][k])[:nch],
                                    _np(tc["intra"][k]))
  assert ("cclm_vc" in j) == ("cclm_vc" in t)
  for group in ("deblock", "sao"):
    assert (group in j) == (group in t)
    for k, v in j.get(group, {}).items():
      np.testing.assert_array_equal(_np(v), _np(t[group][k]), err_msg=k)


_JRES = jax.jit(JP._residual_from_buckets, static_argnums=(1, 2, 3, 4, 5))


@pytest.mark.parametrize("key", ["tools", 8, 10, 12])
def test_residual_planes(key):
  fs, j, t = _frame(key)
  (Hp_y, Wp_y), (Hp_c, Wp_c) = TI._padded_plane_shapes(fs.width, fs.height,
                                                       fs.ctb_log2)
  # the JAX tree's residual buckets (its control layout is the JAX one)
  tj = inputs_from_numpy({"planes": j["planes"], "ctrl": {}}, "cpu")
  tt = inputs_from_numpy(t, "cpu")
  for c in range(len(j["planes"])):
    Hp, Wp = (Hp_y, Wp_y) if c == 0 else (Hp_c, Wp_c)
    sizes = TI.LUMA_SIZES if c == 0 else TI.CHROMA_SIZES
    want = np.asarray(_JRES(j["planes"][c]["buckets"], Hp, Wp, fs.bit_depth,
                            tuple(sizes), c > 0))
    assert np.any(want != 0)
    for inp in (tj, tt):
      got = residual_plane(inp["planes"][c]["buckets"], Hp, Wp, fs.bit_depth,
                           sizes, c > 0, "cpu")
      np.testing.assert_array_equal(got.numpy(), want, err_msg=f"plane {c}")


# ---- intra predictors ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _units(tag):
  """Live control rows of one plane kind of the tools frame, reference
  edges gathered from a seeded random plane (JAX edge_arrays), and the
  unit batch as numpy arrays."""
  fs, j, _ = _frame("tools")
  intra = j["ctrl"][tag]["intra"]
  n = int(intra["iend"][int(j["ctrl"][tag]["n_chunks"]) - 1])
  c = {k: np.asarray(intra[k][:n], np.int32) for k in TI.INTRA_KEYS}
  is_c = tag == "c"
  if is_c:
    c["mrl"] = np.zeros(n, np.int32)
  maxs = min(32, (1 << fs.ctb_log2) >> is_c)
  bd = fs.bit_depth
  (Hp_y, Wp_y), (Hp_c, Wp_c) = TI._padded_plane_shapes(fs.width, fs.height,
                                                       fs.ctb_log2)
  shape = (Hp_c, Wp_c) if is_c else (Hp_y, Wp_y)
  plane = np.random.default_rng(7 + is_c).integers(
      0, 1 << bd, shape).astype(np.int32)
  return c, plane, maxs, bd, is_c


def _vmap_jit(fn, n_batched, **static):
  """jax.vmap over the first n_batched positional args, then jit."""
  g = functools.partial(fn, **static) if static else fn
  return jax.jit(jax.vmap(g, in_axes=(0,) * n_batched))


def _edges(tag):
  c, plane, maxs, bd, _ = _units(tag)
  mid = 1 << (bd - 1)
  f = jax.jit(jax.vmap(lambda x0, y0, al, at, cul, r: JI.edge_arrays(
      jnp.asarray(plane), x0, y0, maxs, al, at, cul, mid, ref_idx=r)))
  left, top = f(*[jnp.asarray(c[k]) for k in ("x0", "y0", "avail_l",
                                               "avail_t", "cand_up_left",
                                               "mrl")])
  return np.asarray(left), np.asarray(top)


def _t(a):
  return torch.from_numpy(np.array(a, np.int32))


@pytest.mark.parametrize("tag", ["y", "c"])
def test_edge_arrays(tag):
  c, plane, maxs, bd, _ = _units(tag)
  left, top = _edges(tag)
  tl, tt = TIn.edge_arrays(_t(plane), _t(c["x0"]), _t(c["y0"]), maxs,
                           _t(c["avail_l"]), _t(c["avail_t"]),
                           _t(c["cand_up_left"]), 1 << (bd - 1),
                           ref_idx=_t(c["mrl"]))
  np.testing.assert_array_equal(tl.numpy(), left)
  np.testing.assert_array_equal(tt.numpy(), top)


def _predictor_cases():
  return [(tag, name) for tag in ("y", "c")
          for name in ("ref_filter_121", "project_negative_angle_v",
                       "project_negative_angle_h", "pred_planar", "pred_dc",
                       "pred_v", "pred_h", "pred_angular_v", "pred_angular_h",
                       "pdpc_hvdc", "pred_mip")]


@pytest.mark.parametrize("tag,name", _predictor_cases())
def test_intra_predictor(tag, name):
  c, _, maxs, bd, is_c = _units(tag)
  left, top = _edges(tag)
  _, OFF = JI.edge_len(maxs)
  maxv = (1 << bd) - 1
  J = {k: jnp.asarray(v) for k, v in c.items()}
  T = {k: _t(v) for k, v in c.items()}
  jl, jt, tl, tt = jnp.asarray(left), jnp.asarray(top), _t(left), _t(top)
  sel = np.ones(len(c["w"]), bool)
  if name == "ref_filter_121":
    want = _vmap_jit(lambda l, t, a, b, u: JI.ref_filter_121(l, t, OFF, a, b, u),
                     5)(jl, jt, J["left_size"], J["top_size"],
                        J["unfilter_last_one"])
    got = TIn.ref_filter_121(tl, tt, OFF, T["left_size"], T["top_size"],
                             T["unfilter_last_one"])
  elif name.startswith("project_negative_angle"):
    v = name.endswith("_v")
    dst, src = (jt, jl) if v else (jl, jt)
    lim = "h" if v else "w"
    want = _vmap_jit(lambda d, s, i, m, r: JI.project_negative_angle(
        d, s, OFF, i, m, ref_idx=r), 5)(dst, src, J["inv_angle"], J[lim],
                                        J["mrl"])
    got = TIn.project_negative_angle(_t(np.asarray(dst)), _t(np.asarray(src)),
                                     OFF, T["inv_angle"], T[lim], T["mrl"])
  elif name == "pred_planar":
    want = _vmap_jit(lambda t, l, w, h, a, b: JI.pred_planar(
        t, l, OFF, maxs, w, h, a, b), 6)(jt, jl, J["w"], J["h"], J["logw"],
                                         J["logh"])
    got = TIn.pred_planar(tt, tl, OFF, maxs, T["w"], T["h"], T["logw"],
                          T["logh"])
  elif name == "pred_dc":
    want = _vmap_jit(lambda t, l, w, h: JI.pred_dc(t, l, OFF, maxs, w, h),
                     4)(jt, jl, J["w"], J["h"])
    got = TIn.pred_dc(tt, tl, OFF, maxs, T["w"], T["h"])
  elif name == "pred_v":
    want = jax.vmap(lambda t: JI.pred_v(t, OFF, maxs))(jt)
    got = TIn.pred_v(tt, OFF, maxs)
  elif name == "pred_h":
    want = jax.vmap(lambda l: JI.pred_h(l, OFF, maxs))(jl)
    got = TIn.pred_h(tl, OFF, maxs)
  elif name.startswith("pred_angular"):
    jf = JI.pred_angular_v if name.endswith("_v") else JI.pred_angular_h
    tf = TIn.pred_angular_v if name.endswith("_v") else TIn.pred_angular_h
    keys = ("w", "h", "angle", "inv_angle", "filter_flag", "do_pdpc",
            "nscale", "mrl")
    want = _vmap_jit(lambda t, l, w, h, a, i, f, p, n, r: jf(
        t, l, OFF, maxs, w, h, a, i, f, p, n, is_c, maxv, ref_idx=r),
        10)(jt, jl, *[J[k] for k in keys])
    got = tf(tt, tl, OFF, maxs, *[T[k] for k in keys[:-1]], is_c, maxv,
             T["mrl"])
    sel = np.isin(c["mode_class"], (JI.MC_ANG_V, JI.MC_ANG_H))
  elif name == "pdpc_hvdc":
    pred = np.random.default_rng(3).integers(
        0, maxv + 1, (len(c["w"]), maxs, maxs)).astype(np.int32)
    want = _vmap_jit(lambda p, t, l, a, b, m: JI.pdpc_hvdc(
        p, t, l, OFF, maxs, a, b, m, maxv), 6)(
            jnp.asarray(pred), jt, jl, J["logw"], J["logh"], J["mode_class"])
    got = TIn.pdpc_hvdc(_t(pred), tt, tl, OFF, maxs, T["logw"], T["logh"],
                        T["mode_class"], maxv)
  elif name == "pred_mip":
    sel = c["mode_class"] == 7
    if not sel.any():
      assert is_c  # 4:2:0 chroma never takes MIP
      return
    keys = ("w", "h", "mip_id", "mip_t", "mip_sz")
    want = _vmap_jit(lambda t, l, w, h, i, tr, s: JI.pred_mip(
        t, l, OFF, maxs, w, h, i, tr, s, bd, maxv), 7)(
            jt, jl, *[J[k] for k in keys])
    got = TIn.pred_mip(tt, tl, OFF, maxs, *[T[k] for k in keys], bd, maxv)
  assert sel.any()
  if isinstance(got, tuple):
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g.numpy()[sel], np.asarray(w)[sel])
  else:
    np.testing.assert_array_equal(got.numpy()[sel], np.asarray(want)[sel])


@functools.lru_cache(maxsize=None)
def _jax_planes():
  """The JAX frame program's reconstruction of the tools frame, stage
  by stage: residual planes, recon (luma; chroma with CCLM), deblock."""
  fs, j, _ = _frame("tools")
  bd = fs.bit_depth
  (Hp_y, Wp_y), (Hp_c, Wp_c) = TI._padded_plane_shapes(fs.width, fs.height,
                                                       fs.ctb_log2)
  res = [np.asarray(_JRES(j["planes"][c]["buckets"],
                          Hp_y if c == 0 else Hp_c, Wp_y if c == 0 else Wp_c,
                          bd, tuple(TI.LUMA_SIZES if c == 0
                                    else TI.CHROMA_SIZES), c > 0))
         for c in range(3)]

  def recon(res_p, inter, intra, n_chunks, cclm, *, maxs, is_chroma, H, W):
    return JP._recon_plane(res_p, inter, 0, intra, n_chunks,
                           jnp.zeros((1, H, W), jnp.int32), maxs_inter=maxs,
                           maxs_intra=maxs, is_chroma=is_chroma,
                           bit_depth=bd, cclm=cclm)

  jrec = jax.jit(recon, static_argnames=("maxs", "is_chroma", "H", "W"))
  cy = j["ctrl"]["y"]
  y = jrec(res[0], cy["inter"], cy["intra"], cy["n_chunks"], None,
           maxs=min(32, 1 << fs.ctb_log2), is_chroma=False, H=fs.height,
           W=fs.width)
  vc = j["cclm_vc"]
  cclm = (y, JI.cclm_dsy_plane(y, vc), vc)
  cc = j["ctrl"]["c"]
  chroma = [jrec(res[c], cc["inter"], cc["intra"], cc["n_chunks"], cclm,
                 maxs=min(32, (1 << fs.ctb_log2) >> 1), is_chroma=True,
                 H=fs.height >> 1,
                 W=fs.width >> 1) for c in (1, 2)]
  return fs, j, res, [np.asarray(y)] + [np.asarray(p) for p in chroma]


@pytest.mark.parametrize("tag", ["y", "c"])
def test_recon_plain(tag):
  """The plain reconstruction (the kernel's oracle) vs JAX _recon_plane
  on an intra frame; chroma with CCLM from the same reconstructed luma."""
  fs, _, t = _frame("tools")
  _, _, res, want = _jax_planes()
  inp = inputs_from_numpy(t, "cpu")
  ct = inp["ctrl"][tag]
  TR.PLAIN_RUNS["recon"] = 0
  if tag == "y":
    got = TR.recon_plane(_t(res[0])[None], ct["intra"], ct["n_chunks"],
                         ct["inter"], None, maxs=min(32, 1 << fs.ctb_log2),
                         is_chroma=False, bit_depth=fs.bit_depth)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
  else:
    luma = _t(want[0])
    cclm = (luma, TIn.cclm_dsy_plane(luma, inp["cclm_vc"]))
    got = TR.recon_plane(torch.stack([_t(res[1]), _t(res[2])]), ct["intra"],
                         ct["n_chunks"], ct["inter"], None,
                         maxs=min(32, (1 << fs.ctb_log2) >> 1), is_chroma=True,
                         bit_depth=fs.bit_depth, cclm=cclm)
    np.testing.assert_array_equal(got[0].numpy(), want[1])
    np.testing.assert_array_equal(got[1].numpy(), want[2])
  assert TR.PLAIN_RUNS["recon"] == got.shape[0]


def test_cclm_model():
  """CCLM pieces on the tools frame's CCLM units: the downsampled luma
  plane, the boundary luma picks and the (a, k, b) model."""
  fs, j, _, planes = _jax_planes()
  c, _, maxs, bd, _ = _units("c")
  sel = c["cclm"] > 0
  assert sel.any()
  luma = planes[0]
  vc = int(j["cclm_vc"])
  np.testing.assert_array_equal(
      TIn.cclm_dsy_plane(_t(luma), vc).numpy(),
      np.asarray(JI.cclm_dsy_plane(jnp.asarray(luma), vc)))
  pos = np.stack([c[f"cclm_p{i}"] for i in range(4)], axis=1)
  vcf = c["cclm_vc"]
  args = (c["x0"], c["y0"], c["cclm_ct"], pos, vcf & 1, (vcf >> 1) & 1,
          (vcf >> 2) & 1, (vcf >> 3) & 1)
  want = jax.vmap(lambda *a: JI.cclm_select_luma(jnp.asarray(luma), *a))(
      *[jnp.asarray(a) for a in args])
  got = TIn.cclm_select_luma(_t(luma), *[_t(a) for a in args])
  np.testing.assert_array_equal(got.numpy()[sel], np.asarray(want)[sel])
  sel_c = np.random.default_rng(5).integers(0, 1 << bd, pos.shape)
  n_sel = c["cclm_ct"] + c["cclm_cl"]
  sl = np.asarray(want)
  two = (n_sel == 2)[:, None]
  sl = np.where(two, np.asarray(jax.vmap(JI.cclm_reorder2)(sl)), sl)
  sc = np.where(two, sel_c[:, [1, 0, 1, 0]], sel_c)
  np.testing.assert_array_equal(
      TIn.cclm_reorder2(_t(np.asarray(want))).numpy(),
      np.asarray(jax.vmap(JI.cclm_reorder2)(jnp.asarray(want))))
  jp = jax.vmap(lambda a, b, n: JI.cclm_get_params(a, b, n, bd))(
      jnp.asarray(sl), jnp.asarray(sc), jnp.asarray(n_sel))
  tp = TIn.cclm_get_params(_t(sl), _t(sc), _t(n_sel), bd)
  for g, w in zip(tp, jp):
    np.testing.assert_array_equal(g.numpy()[sel], np.asarray(w)[sel])


@pytest.mark.parametrize("plane,direction", [("y", "v"), ("y", "h"),
                                             ("c1", "v"), ("c1", "h"),
                                             ("c2", "v"), ("c2", "h")])
def test_deblock(plane, direction):
  fs, j, _, planes = _jax_planes()
  d = j["deblock"]
  dbo, dto = tuple(fs.beta_offset), tuple(fs.tc_offset)
  if plane == "y":
    src = planes[0]
    keys = [f"y{k}_{direction}" for k in ("bs", "qp", "mp", "mq")]
    keys.append("yhor0" if direction == "v" else "yhor")
    jf, tf, ci = JD.deblock_vertical_luma, TD.deblock_vertical_luma_plain, 0
  else:
    ci = int(plane[1])
    src = planes[ci]
    keys = [f"c{ci}{k}_{direction}" for k in ("bs", "qp", "mp", "mq")]
    jf, tf = JD.deblock_vertical_chroma, TD.deblock_vertical_chroma_plain
  grids = [np.asarray(d[k], np.int32) for k in keys]
  kw = dict(bit_depth=fs.bit_depth, beta_off=dbo[ci], tc_off=dto[ci])
  assert grids[0].any()  # some edge of this pass has bs > 0
  # the port's horizontal pass runs on the plane's transposed view
  view = _t(src).T if direction == "h" else _t(src)
  if direction == "h":
    src = np.ascontiguousarray(src.T)
  want = np.asarray(jf(jnp.asarray(src), *map(jnp.asarray, grids), **kw))
  got = tf(view, *map(_t, grids), **kw).numpy()
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [0, 1, 2])
def test_sao(c):
  fs, j, _, planes = _jax_planes()
  s = {k: np.asarray(v, np.int32) for k, v in j["sao"].items()}
  ss = 0 if c == 0 else 1
  args = (s["type"][..., c], s["band"][..., c], s["offv"][..., c, :],
          s["eo"][..., c])
  kw = dict(ctb=(1 << fs.ctb_log2) >> ss, bit_depth=fs.bit_depth)
  want = np.asarray(JS.sao_plane(jnp.asarray(planes[c]),
                                 *map(jnp.asarray, args), fs.width >> ss,
                                 fs.height >> ss, **kw))
  got = TS.sao_plane(_t(planes[c]), *map(_t, args), fs.width >> ss,
                     fs.height >> ss, **kw).numpy()
  np.testing.assert_array_equal(got, want)
