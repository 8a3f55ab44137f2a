"""The deblock edge grids' native pass (`native/host.cc`
`vvch_fo_deblock_grids`, through `models/vvc/inputs.py` `_deblock_grids`)
against their numpy derivation `_deblock_grids_plain`, key by key: the
same keys in the same order, and each grid's dtype, shape and every
value.  Every frame of the committed fixtures and of generated streams
that carry each rule: intra, CIIP, affine with PROF and SbTMVP, GPM,
weighted prediction, large MVs past the picture, BDPCM, 4:0:0,
uni-prediction from two pictures of one list, and DMVR, whose frames'
grids are built after `host.dmvr_apply`, as the session builds them.
A FrameSyntax without a native handle takes the numpy path.  No JAX:
the streams come from the port's own generator."""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from ffmpeg_tpu_torch.encoder.encoder import EncoderConfig, encode_stream
from ffmpeg_tpu_torch.models.vvc import host as TH
from ffmpeg_tpu_torch.models.vvc import inputs as TI
from ffmpeg_tpu_torch.models.vvc.decoder import VVCDecoder
from ffmpeg_tpu_torch.models.vvc.pipeline import submit_frame
from ffmpeg_tpu_torch.ops import dmvr as TD
from ffmpeg_tpu_torch.utils import trace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata")

# committed fixtures: name -> access units to parse, from the first
# (ctu128_1080: its I frame and first B frame, which have no DMVR units:
# parsing a later frame would wait on a DMVR frame's refined motion)
FIXTURES = {"ai720": None, "ai256x128_10b": None, "ctu128_1080": 2,
            "ciip64": None}

# generated streams: tests/test_torch_inter.py's inter tools, the BDPCM
# and 4:0:0 cases of tests/test_torch_deblock.py and
# tests/test_torch_decode.py, and tests/test_torch_dmvr.py's DMVR case
# with deblocking (the same ids and configs), and one of this file's own.
# No stream here reaches the bi-predicted rule's swapped pair (P's L0
# picture Q's L1 and the other way round, neither pair equal): the
# generator's two lists share at most one picture.
STREAMS = {
    "ciip": dict(width=96, height=96, seed=1802, qp=28, inter=True,
                 b_slices=True, n_frames=3, ciip=True, deblock=True,
                 sao=True),
    "bdof-affine": dict(width=96, height=96, seed=2405, qp=28, inter=True,
                        b_slices=True, ra=True, n_frames=5, bdof=True,
                        affine=True, prof=True, sbtmvp=True, deblock=True,
                        sao=True, max_mv=90),
    "gpm": dict(width=96, height=96, seed=1902, qp=28, inter=True,
                b_slices=True, n_frames=3, gpm=True, deblock=True, sao=True),
    "wp": dict(width=96, height=96, seed=2002, qp=28, inter=True,
               b_slices=True, n_frames=3, weighted_pred=True, deblock=True,
               sao=True),
    "wrap": dict(width=96, height=64, seed=4102, qp=32, wraparound=True,
                 inter=True, b_slices=True, ra=True, tmvp=True, n_frames=5,
                 max_mv=400, deblock=True, sao=True),
    "bdpcm-ts-inter": dict(width=96, height=64, seed=902, qp=28, bdpcm=True,
                           transform_skip=True, deblock=True, inter=True,
                           b_slices=True, n_frames=3),
    "mono-filters": dict(width=96, height=64, seed=3902, qp=28,
                         chroma_format_idc=0, deblock=True, sao=True),
    # P slices over a short-term and a long-term reference, most CUs
    # skipped: uni-predicted sides on different pictures with near MVs
    # and no cbf, which only the reference-POC rule tells apart
    "ltr-skip": dict(width=96, height=96, seed=3002, qp=28, inter=True,
                     n_frames=3, deblock=True, ltr=True, skip_prob=0.8),
    "dmvr-bdof-tmvp": dict(width=96, height=96, seed=2502, qp=28, inter=True,
                           b_slices=True, ra=True, n_frames=9, dmvr=True,
                           bdof=True, tmvp=True, deblock=True, sao=True,
                           max_mv=90),
}

# what each stream must carry for its case to test its rule
CARRIES = {
    "ciip": lambda fs: np.any(fs.mvf["ciip"]),
    "bdof-affine": lambda fs: np.any(fs.cus["affine"])
    and np.any(fs.cus["sbtmvp"]),
    "gpm": lambda fs: np.any(fs.cus["gpm_part"] >= 0),
    "wrap": lambda fs: fs.wrap_off > 0,
    "bdpcm-ts-inter": lambda fs: np.any(fs.tus["pcmf"] == 1),
    "mono-filters": lambda fs: fs.chroma_format_idc == 0,
    "ltr-skip": lambda fs: len(fs.ref_pocs[0]) > 1,
    "dmvr-bdof-tmvp": TI.has_dmvr,
}


def _grids(fs, fn):
  shapes = TI._padded_plane_shapes(fs.width, fs.height, fs.ctb_log2)
  (Hp_y, Wp_y), (Hp_c, Wp_c) = shapes
  return fn(fs, Hp_y, Wp_y, Hp_c, Wp_c, fs.ctb_log2)


def _check(fs):
  """The native grids of one frame equal the plain ones; returns the
  native grids."""
  assert fs.fo is not None and not fs.deblock_disabled
  got, want = _grids(fs, TI._deblock_grids), _grids(
      fs, TI._deblock_grids_plain)
  assert list(got) == list(want), fs.poc
  for k in want:
    assert got[k].dtype == want[k].dtype == np.int8, (fs.poc, k)
    assert got[k].shape == want[k].shape, (fs.poc, k)
    np.testing.assert_array_equal(got[k], want[k],
                                  err_msg=f"poc {fs.poc} {k}")
  return got


def _aus(data):
  return VVCDecoder(device="cpu")._split_aus(data)


@functools.lru_cache(maxsize=None)
def _stream(name):
  return encode_stream(EncoderConfig(**STREAMS[name]))[0]


def _parsed(data, n=None):
  """The frames of the first n access units (all when None), parsed in
  decode order."""
  host = TH.HostDecoder(TH.ColStore())
  return [host.decode_au(au, epoch) for _, epoch, au in _aus(data)[:n]]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_native_grids_fixture(name):
  with open(os.path.join(TESTDATA, name + ".vvc"), "rb") as f:
    frames = _parsed(f.read(), FIXTURES[name])
  assert frames
  for fs in frames:
    _check(fs)
  if name == "ctu128_1080":
    assert [fs.slice_type for fs in frames] == [2, 0]


@pytest.mark.parametrize(
    "name", sorted(n for n in STREAMS if n != "dmvr-bdof-tmvp"))
def test_native_grids_generated(name):
  frames = _parsed(_stream(name))
  assert frames and any(CARRIES.get(name, lambda fs: True)(fs)
                        for fs in frames)
  motion_edges = 0
  for fs in frames:
    got = _check(fs)
    assert ("c1bs_v" in got) == (fs.chroma_format_idc != 0)
    motion_edges += int((got["ybs_v"] == 1).sum())
  if name != "mono-filters":
    assert motion_edges > 0


def test_native_grids_dmvr_after_apply():
  """Every frame of a DMVR stream decoded on the CPU, each DMVR frame's
  grids built after its refinement has been handed to the native side
  (host.dmvr_apply): the native pass reads the parse's motion planes, as
  the plain one reads fs.mvf, the parse's copy of them."""
  colstore = TH.ColStore()
  host, dpb, n_dmvr = TH.HostDecoder(colstore), {}, 0
  for _, epoch, au in _aus(_stream("dmvr-bdof-tmvp")):
    fs = host.decode_au(au, epoch)
    if TI.has_dmvr(fs):
      planes6 = TD.refine_frame(fs, dpb, "cpu")
      TH.dmvr_apply(fs, colstore, epoch, planes6)
      n_dmvr += 1
    _check(fs)
    _, dpb[fs.poc], _ = submit_frame(TI.build_host_inputs(fs), fs, "cpu",
                                     dpb)
  assert n_dmvr > 0


def test_plain_path_without_a_native_handle():
  """A FrameSyntax without `fo` takes the numpy path (span attribute
  native 0), and gives the native pass's grids."""
  with open(os.path.join(TESTDATA, "ai256x128_10b.vvc"), "rb") as f:
    fs = _parsed(f.read(), 1)[0]
  trace.reset()
  trace.enable(True)
  try:
    got = _grids(fs, TI._deblock_grids)
    plain = _grids(dataclasses.replace(fs, fo=None), TI._deblock_grids)
  finally:
    trace.enable(False)
  recs = [r for r in trace.records() if r["name"] == "deblock_grids"]
  trace.reset()
  assert [r["attrs"] for r in recs] == [{"native": 1}, {"native": 0}]
  assert list(got) == list(plain)
  for k in got:
    np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


def test_native_grids_refuse_too_small_grids():
  with open(os.path.join(TESTDATA, "ai256x128_10b.vvc"), "rb") as f:
    fs = _parsed(f.read(), 1)[0]
  with pytest.raises(RuntimeError, match="cannot hold"):
    TI._deblock_grids(fs, fs.height - 8, fs.width, fs.height, fs.width,
                      fs.ctb_log2)
