"""The PyTorch port's copied constants, tables and sources equal the JAX
package's; the port imports neither JAX nor the JAX package."""
import ast
import os
import re

import jax  # noqa: F401  (JAX on the CPU, as conftest configures it)
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ffmpeg_tpu_torch")


def _port_py_files():
  out = [os.path.join(ROOT, "chip_smoke.py")]
  for d, _, files in os.walk(PORT):
    out += [os.path.join(d, f) for f in files if f.endswith(".py")]
  return sorted(out)


@pytest.mark.parametrize("path", _port_py_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  bad = []
  for node in ast.walk(tree):
    names = []
    if isinstance(node, ast.Import):
      names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      names = [node.module or ""]
    bad += [n for n in names
            if n.split(".")[0] in ("jax", "jaxlib", "ffmpeg_tpu")]
  assert not bad, f"{path} imports {bad}"


def test_vvc_tables_copied():
  from ffmpeg_tpu.ops import intra as J
  from ffmpeg_tpu_torch.ops import intra as T

  assert sorted(J._TABLES.files) == sorted(T._TABLES)
  for k in J._TABLES.files:
    np.testing.assert_array_equal(J._TABLES[k], T._TABLES[k], err_msg=k)


@pytest.mark.parametrize("name", ["INTRA_LUMA_FILTER", "MIP_BANK",
                                  "CCLM_DIV_SIG"])
def test_intra_constants(name):
  from ffmpeg_tpu.ops import intra as J
  from ffmpeg_tpu_torch.ops import intra as T

  np.testing.assert_array_equal(getattr(J, name), getattr(T, name))
  assert (J.MC_PLANAR, J.MC_DC, J.MC_VERT, J.MC_HORZ, J.MC_ANG_V,
          J.MC_ANG_H) == (T.MC_PLANAR, T.MC_DC, T.MC_VERT, T.MC_HORZ,
                          T.MC_ANG_V, T.MC_ANG_H)


@pytest.mark.parametrize("name", ["TCTABLE", "BETATABLE", "LARGE_COEF_M",
                                  "LARGE_COEF_R", "LARGE_TC_MULT"])
def test_deblock_tables(name):
  from ffmpeg_tpu.ops import deblock as J
  from ffmpeg_tpu_torch.ops import deblock as T

  np.testing.assert_array_equal(getattr(J, name), getattr(T, name))


def test_transform_tables():
  from ffmpeg_tpu.ops import transform as J
  from ffmpeg_tpu_torch.ops import transform as T

  np.testing.assert_array_equal(J.LEVEL_SCALE, T.LEVEL_SCALE)
  for kind, sizes in (("dct2", (2, 4, 8, 16, 32)), ("dst7", (4, 8, 16, 32)),
                      ("dct8", (4, 8, 16, 32))):
    for n in sizes:
      np.testing.assert_array_equal(J.itx_matrix(kind, n),
                                    T.itx_matrix(kind, n))
  for qp in range(0, 64):
    for lw in range(1, 6):
      for lh in range(1, 6):
        for bd in (8, 10, 12):
          for dq in (False, True):
            assert (J.dequant_scale_shift(qp, lw, lh, bd, dq)
                    == T.dequant_scale_shift(qp, lw, lh, bd, dq))


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 32), (8, 4),
                                 (2, 8)])
def test_diag_scan(w, h):
  from ffmpeg_tpu.encoder.scan import diag_scan as J
  from ffmpeg_tpu_torch.ops.transform import diag_scan as T

  assert J(w, h) == T(w, h)


@pytest.mark.parametrize("big", [False, True])
def test_lfnst_consts(big):
  from ffmpeg_tpu.models.vvc.pipeline import _lfnst_consts
  from ffmpeg_tpu_torch.ops.transform import lfnst_consts

  for a, b in zip(_lfnst_consts(big), lfnst_consts(big)):
    np.testing.assert_array_equal(a, b)


def test_controls_and_layout_keys():
  from ffmpeg_tpu.models.vvc import pipeline as JP
  from ffmpeg_tpu.models.vvc import recon as JR
  from ffmpeg_tpu_torch.models.vvc import inputs as TI
  from ffmpeg_tpu_torch.models.vvc import recon as TR
  from ffmpeg_tpu_torch.models.vvc.host import CHUNK_CAP
  from ffmpeg_tpu_torch.ops.transform import BUCKET_ROWS

  assert TR.CTRL_KEYS == JR.CTRL_KEYS and len(TR.CTRL_KEYS) == 75
  assert (TR.MC_INTER, TR.MC_MIP, TR.MC_CCLM) == (JR.MC_INTER, JR.MC_MIP,
                                                  JR.MC_CCLM)
  assert TI.INTRA_KEYS == JP.INTRA_KEYS
  assert BUCKET_ROWS == JP.BUCKET_ROWS
  assert TI.LUMA_SIZES == JP.LUMA_SIZES
  assert TI.CHROMA_SIZES == JP.CHROMA_SIZES
  assert CHUNK_CAP == JP.CHUNK_CAP


@pytest.mark.parametrize("sizes", ["luma", "chroma"])
@pytest.mark.parametrize("bd,dq", [(8, False), (10, True), (12, False)])
def test_dequant_blob(sizes, bd, dq):
  from ffmpeg_tpu.models.vvc import pipeline as JP
  from ffmpeg_tpu_torch.models.vvc import inputs as TI

  sz = TI.LUMA_SIZES if sizes == "luma" else TI.CHROMA_SIZES
  np.testing.assert_array_equal(JP._scsh_blob(sz, bd, dq),
                                TI._scsh_blob(sz, bd, dq))


def test_padded_plane_shapes():
  from ffmpeg_tpu.models.vvc.pipeline import _padded_plane_shapes as J
  from ffmpeg_tpu_torch.models.vvc.inputs import _padded_plane_shapes as T

  for W, H, ctb in ((64, 64, 5), (1280, 720, 5), (72, 40, 6), (256, 192, 7)):
    assert J(W, H, ctb) == T(W, H, ctb)


@pytest.mark.parametrize("name", ["headers.cc", "decode.cc", "headers.h",
                                  "bits.h", "cabac.h", "cabac_tables.h"])
def test_native_sources_copied(name):
  with open(os.path.join(ROOT, "ffmpeg_tpu", "native", name), "rb") as f:
    want = f.read()
  with open(os.path.join(PORT, "native", name), "rb") as f:
    assert f.read() == want


def test_native_makefile_decode_only():
  with open(os.path.join(PORT, "native", "Makefile")) as f:
    srcs = re.search(r"^SRCS\s*=\s*(.*)$", f.read(), re.M).group(1).split()
  assert srcs == ["headers.cc", "decode.cc"]


def test_kernel_control_rows_match_layout():
  """The CUDA kernel reads control rows by an enum that must follow
  INTRA_KEYS (the kernel cannot be compiled here)."""
  from ffmpeg_tpu_torch.models.vvc.inputs import INTRA_KEYS

  assert _kernel_enum("recon.cu") == INTRA_KEYS


def test_kernel_readiness_cell_matches_twin():
  """The recon kernel's readiness cells are the ones its Python twin
  (ops/recon.py readiness_cell, dependency_levels, _wait_rects) counts
  in: the wrapper passes readiness_cell's edge, 2 (CELL) on layouts of
  2-aligned units and 1 otherwise, and the kernel takes exactly those two
  edges, as the shift log2(cell)."""
  from ffmpeg_tpu_torch.models.vvc.inputs import INTRA_KEYS
  from ffmpeg_tpu_torch.ops.recon import CELL, readiness_cell

  with open(os.path.join(PORT, "csrc", "recon.cu")) as f:
    src = f.read()
  assert "(cell != 1 && cell != 2)" in src
  assert "const int cl2 = cell == 2," in src
  rows = np.zeros((len(INTRA_KEYS), 3), np.int32)
  xywh = [INTRA_KEYS.index(k) for k in ("x0", "y0", "w", "h")]
  rows[xywh] = [[0, 8, 4], [0, 4, 6], [8, 4, 8], [4, 2, 2]]
  assert CELL == 2 and readiness_cell(rows) == CELL
  rows[xywh[3], 2] = 1  # a 1-high ISP sub-partition
  assert readiness_cell(rows) == 1


def _kernel_enum(name):
  with open(os.path.join(PORT, "csrc", name)) as f:
    src = f.read()
  body = re.search(r"enum \{\s*(k_x0.*?)NUM_KEYS", src, re.S).group(1)
  return tuple(n.strip()[2:] for n in body.split(",") if n.strip())


def test_inter_kernel_control_rows_match_layout():
  """The inter-prediction kernel's enum follows INTER_KEYS, which are the
  JAX frame program's INTER_KEYS, DMVR's rows included."""
  from ffmpeg_tpu.models.vvc import pipeline as JP
  from ffmpeg_tpu_torch.models.vvc.inputs import INTER_KEYS

  assert _kernel_enum("inter_pred.cu") == INTER_KEYS
  assert INTER_KEYS == JP.INTER_KEYS


def test_inter_kernel_lmcs_table():
  """The inter kernel's parameter block holds the LMCS forward table the
  wrapper passes: 16 pivots and 16 scales."""
  from ffmpeg_tpu_torch.ops import inter as T

  with open(os.path.join(PORT, "csrc", "inter_pred.cu")) as f:
    src = f.read()
  assert "int lm_pivot[16], lm_fwd[16];" in src
  assert T.LMCS_TABLE == 32


def _kernel_table(src, name):
  body = re.search(name + r"\[[^=]*= \{(.*?)\};", src, re.S).group(1)
  return np.array([int(v) for v in re.findall(r"-?\d+", body)])


def test_inter_kernel_constants_match_tables():
  """The inter-prediction kernel's __constant__ filter banks are the
  port's interpolation tables, its small-unit bound and largest unit
  edge are the host's, and its small slices hold the window and the
  horizontal pass of every unit the host calls small (the kernel cannot
  be compiled here)."""
  from ffmpeg_tpu_torch.models.vvc.inputs import SMALL_AREA
  from ffmpeg_tpu_torch.models.vvc.mc_tiles import MC_TILE
  from ffmpeg_tpu_torch.ops import inter as T

  with open(os.path.join(PORT, "csrc", "inter_pred.cu")) as f:
    src = f.read()

  def define(name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))

  np.testing.assert_array_equal(_kernel_table(src, "c_luma"),
                                T.INTERP_LUMA.reshape(-1))
  np.testing.assert_array_equal(_kernel_table(src, "c_chroma"),
                                T.INTERP_CHROMA[0].reshape(-1))
  assert define("SMALL_AREA") == SMALL_AREA
  assert define("LARGE_EDGE") == MC_TILE
  assert define("GW") == MC_TILE
  assert define("MAX_NCH") == T.MAX_NCH
  assert define("MAX_REFS") == T.MAX_REFS
  for w in range(1, MC_TILE + 1):
    for h in range(1, MC_TILE + 1):
      ww, hh = max(w, 4), max(h, 4)
      if ww * hh <= SMALL_AREA:
        assert (ww + 7) * (hh + 7) <= define("SMALL_WIN"), (w, h)
        assert (hh + 7) * ww <= define("SMALL_TMP"), (w, h)


def test_interp_tables():
  from ffmpeg_tpu.models.vvc import pipeline as JP
  from ffmpeg_tpu_torch.ops import inter as T

  np.testing.assert_array_equal(JP.INTERP_LUMA, T.INTERP_LUMA)
  np.testing.assert_array_equal(JP.INTERP_CHROMA, T.INTERP_CHROMA)


@pytest.mark.parametrize("part", [0, 5, 17, 31, 44, 63])
def test_gpm_weight_plane(part):
  from ffmpeg_tpu.models.vvc import pipeline as JP
  from ffmpeg_tpu_torch.models.vvc import inputs as TI

  for w, h in ((8, 8), (8, 32), (16, 64), (64, 16), (32, 32), (64, 64)):
    np.testing.assert_array_equal(JP._gpm_weight_plane(part, w, h),
                                  TI._gpm_weight_plane(part, w, h))


def test_split_annexb_raw():
  from ffmpeg_tpu.bitstream.bits import split_annexb_raw as J
  from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream
  from ffmpeg_tpu_torch.bitstream.bits import split_annexb_raw as T

  data, _ = encode_stream(EncoderConfig(width=64, height=64, seed=5,
                                        n_frames=2, separate_ph=True))
  assert J(data) == T(data) and len(T(data)) > 3
