"""The configs of tests/test_conformance.py that no other port test
decodes, by tool group, and their JAX MD5s.

Each group is one test file, so that `--dist loadfile` spreads them over
the test workers:
  test_torch_conformance_residual.py   RESIDUAL_CASES
  test_torch_conformance_intra.py      INTRA_CASES
  test_torch_conformance_inter.py      INTER_CASES
  test_torch_conformance_partition.py  PARTITION_CASES

The ids and configs are test_conformance.py's.  The JAX MD5s live in
ffmpeg_tpu_torch/testdata/conformance_cases.md5.json; regenerate them
with the JAX package's decoder on the CPU, one config per subprocess:

  python tests/torch_conformance_cases.py

This module imports neither torch nor JAX at its top, so that the
regenerator's subprocesses load only the JAX package.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CONFORMANCE_JSON = os.path.join(ROOT, "ffmpeg_tpu_torch", "testdata",
                                "conformance_cases.md5.json")

# MTS, dependent quantisation, sign hiding, joint CbCr, transform skip
# and BDPCM, LFNST, QP deltas
RESIDUAL_CASES = {
    "mts-explicit": dict(width=96, height=96, seed=301, qp=30, mts=True),
    "mts-implicit": dict(width=96, height=96, seed=302, qp=28,
                         mts_implicit=True),
    "mts-inter-full": dict(width=96, height=64, seed=303, qp=30, mts=True,
                           inter=True, b_slices=True, deblock=True, sao=True,
                           n_frames=3),
    "qp-delta": dict(width=96, height=96, seed=601, qp=30, cu_qp_delta=True),
    "qp-delta-ctu64-mts": dict(width=128, height=64, seed=604, qp=32,
                               cu_qp_delta=True, ctu_log2=6, max_bt_size=64,
                               mts=True, sao=True),
    "joint-cbcr": dict(width=96, height=96, seed=701, qp=30, joint_cbcr=True),
    "joint-cbcr-inter": dict(width=96, height=64, seed=702, qp=28,
                             joint_cbcr=True, inter=True, b_slices=True,
                             deblock=True, n_frames=3),
    "joint-cbcr-full": dict(width=128, height=64, seed=703, qp=32,
                            joint_cbcr=True, cu_qp_delta=True, mts=True,
                            sao=True, ctu_log2=6, max_bt_size=64),
    "transform-skip": dict(width=96, height=96, seed=801, qp=30,
                           transform_skip=True),
    "transform-skip-full": dict(width=96, height=96, seed=807, qp=28,
                                transform_skip=True, joint_cbcr=True,
                                mts=True, deblock=True, inter=True,
                                b_slices=True, n_frames=4),
    "bdpcm": dict(width=96, height=96, seed=901, qp=30, bdpcm=True),
    "lfnst": dict(width=96, height=96, seed=1001, qp=30, lfnst=True),
    "lfnst-ctu64": dict(width=128, height=128, seed=1005, qp=30, lfnst=True,
                        ctu_log2=6, max_bt_size=64, min_qt_size=16),
    "dep-quant": dict(width=96, height=96, seed=1301, qp=30, dep_quant=True),
    "dep-quant-inter": dict(width=96, height=64, seed=1302, qp=28,
                            dep_quant=True, inter=True, b_slices=True,
                            deblock=True, n_frames=3),
    "dep-quant-tools": dict(width=128, height=64, seed=1303, qp=32,
                            dep_quant=True, mts=True, lfnst=True,
                            cu_qp_delta=True, sao=True, ctu_log2=6,
                            max_bt_size=64),
    "dep-quant-ts": dict(width=96, height=96, seed=1304, qp=30,
                         dep_quant=True, transform_skip=True,
                         joint_cbcr=True),
    "sign-hiding": dict(width=96, height=96, seed=1311, qp=30,
                        sign_hiding=True, coeff_density=0.4),
    "sign-hiding-inter": dict(width=96, height=64, seed=1312, qp=28,
                              sign_hiding=True, inter=True, b_slices=True,
                              deblock=True, n_frames=3, coeff_density=0.4),
}

# MIP, MRL, CCLM, dual tree, 4:0:0, CTU-64, and two frames of intra
INTRA_CASES = {
    "128x64x2f": dict(width=128, height=64, seed=102, qp=22, n_frames=2),
    "ctu64": dict(width=128, height=128, seed=401, qp=30, ctu_log2=6,
                  max_bt_size=64, max_tt_size=64, min_qt_size=16),
    "mip": dict(width=96, height=96, seed=2601, qp=30, mip=True),
    "mip-lfnst": dict(width=96, height=64, seed=2602, qp=28, mip=True,
                      lfnst=True),
    "mip-mts-implicit": dict(width=96, height=64, seed=2603, qp=30, mip=True,
                             mts_implicit=True),
    "mip-ctu64-10bit": dict(width=128, height=128, seed=2604, qp=30,
                            mip=True, ctu_log2=6, max_bt_size=64,
                            min_qt_size=16, bit_depth=10),
    "cclm": dict(width=96, height=96, seed=2701, qp=30, cclm=True),
    "cclm-noncollocated": dict(width=96, height=64, seed=2702, qp=28,
                               cclm=True, cclm_vertical_collocated=False),
    "cclm-jcbcr-lfnst": dict(width=96, height=64, seed=2704, qp=30,
                             cclm=True, joint_cbcr=True, lfnst=True),
    "mrl": dict(width=96, height=96, seed=2801, qp=30, mrl=True),
    "mrl-mip-lfnst": dict(width=96, height=64, seed=2802, qp=28, mrl=True,
                          mip=True, lfnst=True),
    "mrl-ctu64-10bit": dict(width=128, height=128, seed=2803, qp=30,
                            mrl=True, ctu_log2=6, max_bt_size=64,
                            min_qt_size=16, bit_depth=10),
    "dualtree": dict(width=96, height=64, seed=3201, qp=30, dual_tree=True,
                     split_prob=0.75),
    "dualtree-ts-tools": dict(width=96, height=96, seed=3203, qp=28,
                              dual_tree=True, bdpcm=True,
                              transform_skip=True, dep_quant=True, mts=True),
    "dualtree-ctu64-lfnst": dict(width=128, height=128, seed=3204, qp=30,
                                 dual_tree=True, ctu_log2=6, lfnst=True,
                                 joint_cbcr=True),
    "mono": dict(width=96, height=64, seed=3901, qp=30, chroma_format_idc=0),
}

# TMVP, SbTMVP, CIIP, GPM, weighted prediction, SBT, MMVD, the first
# wave of inter tools and random access, LTR and RPL signalling,
# wraparound
INTER_CASES = {
    "ctu64-inter-full": dict(width=192, height=128, seed=402, qp=28,
                             ctu_log2=6, max_bt_size=64, max_tt_size=64,
                             inter=True, b_slices=True, deblock=True,
                             sao=True, n_frames=3),
    "ra-tools": dict(width=96, height=64, seed=1103, qp=30, inter=True,
                     b_slices=True, ra=True, n_frames=13, mts=True,
                     cu_qp_delta=True, transform_skip=True, deblock=True),
    "tmvp": dict(width=96, height=64, seed=1202, qp=28, inter=True,
                 b_slices=True, tmvp=True, n_frames=4, deblock=True),
    "mmvd-fullpel": dict(width=96, height=64, seed=1702, qp=28, inter=True,
                         b_slices=True, n_frames=3, mmvd=True,
                         mmvd_fullpel=True),
    "inter-wave1-ra": dict(width=96, height=64, seed=1705, qp=28, inter=True,
                           b_slices=True, ra=True, n_frames=9, mmvd=True,
                           amvr=True, bcw=True, deblock=True, sao=True),
    "ciip": dict(width=96, height=64, seed=1801, qp=28, inter=True,
                 n_frames=3, ciip=True),
    "wp": dict(width=96, height=64, seed=2001, qp=28, inter=True, n_frames=3,
               weighted_pred=True),
    "sbtmvp": dict(width=96, height=64, seed=2101, qp=28, inter=True,
                   n_frames=3, sbtmvp=True),
    "affine-sbtmvp": dict(width=96, height=96, seed=2205, qp=28, inter=True,
                          b_slices=True, n_frames=4, affine=True,
                          sbtmvp=True, deblock=True, sao=True),
    "affine-wp": dict(width=96, height=64, seed=2208, qp=28, inter=True,
                      b_slices=True, n_frames=4, affine=True,
                      weighted_pred=True, deblock=True),
    "gpm": dict(width=96, height=64, seed=1901, qp=28, inter=True,
                b_slices=True, n_frames=3, gpm=True),
    "sbt": dict(width=96, height=64, seed=3401, qp=30, inter=True,
                b_slices=True, n_frames=4, sbt=True, mts=True),
    "sbt-tools-ra": dict(width=96, height=96, seed=3402, qp=28, inter=True,
                         b_slices=True, ra=True, n_frames=9, sbt=True,
                         mts=True, tmvp=True, deblock=True, sao=True),
    "sbt-p": dict(width=96, height=64, seed=3403, qp=30, inter=True,
                  n_frames=3, sbt=True, deblock=True, sao=True),
    "ltr-p": dict(width=96, height=64, seed=3501, qp=30, inter=True,
                  n_frames=5, ltr=True, deblock=True),
    "rpl-sps-p": dict(width=96, height=64, seed=3801, qp=30, inter=True,
                      n_frames=5, rpl_in_sps=True, deblock=True, sao=True,
                      max_mv=48),
    "rpl-sps-ra": dict(width=96, height=64, seed=3802, qp=30, inter=True,
                       b_slices=True, ra=True, tmvp=True, n_frames=9,
                       rpl_in_sps=True, deblock=True, sao=True, max_mv=48),
    "rpl-ph": dict(width=96, height=64, seed=3803, qp=30, inter=True,
                   b_slices=True, tmvp=True, n_frames=5, rpl_in_ph=True,
                   deblock=True, sao=True, max_mv=48),
    "wraparound-p": dict(width=96, height=64, seed=4101, qp=32,
                         wraparound=True, inter=True, n_frames=4, max_mv=400,
                         deblock=True),
}

# tiles, WPP, slices (raster and rectangular), a separate picture header
PARTITION_CASES = {
    "tiles": dict(width=96, height=96, seed=3001, qp=30, tile_cols=(2, 1),
                  tile_rows=(1, 2)),
    "wpp": dict(width=96, height=96, seed=3101, qp=30, wpp=True),
    "separate-ph": dict(width=96, height=96, seed=2901, qp=30,
                        separate_ph=True),
    "slices": dict(width=96, height=64, seed=3701, qp=30, tile_cols=(2, 1),
                   tile_rows=(1, 1), n_slices=2, deblock=True, sao=True),
    "slices-wpp": dict(width=96, height=64, seed=3702, qp=30,
                       tile_cols=(2, 1), tile_rows=(1, 1), n_slices=4,
                       wpp=True),
    "slices-tools-ra": dict(width=96, height=64, seed=3703, qp=28,
                            tile_cols=(2, 1), tile_rows=(1, 1), n_slices=3,
                            inter=True, b_slices=True, ra=True, n_frames=9,
                            tmvp=True, deblock=True, sao=True),
    "rect-slices": dict(width=128, height=96, seed=4001, qp=30,
                        tile_cols=(2, 2), tile_rows=(2, 1),
                        rect_slices=((0, 0, 1, 2), (1, 0, 1, 2))),
    "rect-slices-ra": dict(width=128, height=96, seed=4003, qp=32,
                           tile_cols=(2, 2), tile_rows=(2, 1),
                           rect_slices=((0, 0, 2, 1), (0, 1, 2, 1)),
                           inter=True, b_slices=True, ra=True, tmvp=True,
                           n_frames=5, deblock=True, sao=True, max_mv=48),
}

GROUPS = {"residual": RESIDUAL_CASES, "intra": INTRA_CASES,
          "inter": INTER_CASES, "partition": PARTITION_CASES}
ALL_CASES = {k: v for cases in GROUPS.values() for k, v in cases.items()}


def committed(case):
  """The committed {"config", "md5"} entry of one case."""
  with open(CONFORMANCE_JSON) as f:
    return json.load(f)[case]


def _stream(kw) -> bytes:
  from ffmpeg_tpu.encoder.encoder import EncoderConfig, encode_stream

  return encode_stream(EncoderConfig(**kw))[0]


def _jax_md5s(case):
  """One case through the JAX package's decoder on the CPU."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  from ffmpeg_tpu.models.vvc.decoder import DecoderConfig, VVCDecoder

  dec = VVCDecoder(config=DecoderConfig(errors="contain"))
  return [f.md5() for f in dec.decode(_stream(ALL_CASES[case]))]


def _jax_subprocess(case, tries=3):
  """One case's JAX MD5s from a subprocess; a subprocess that a signal
  ends (the JAX package's decoder has segfaulted on the CPU) runs again,
  up to `tries` times, and is reported."""
  for _ in range(tries):
    proc = subprocess.run([sys.executable, __file__, "--one", case],
                          stdout=subprocess.PIPE, text=True,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if proc.returncode >= 0:
      break
    print(f"{case}: the JAX decode ended by signal {-proc.returncode}",
          file=sys.stderr, flush=True)
  proc.check_returncode()
  md5 = json.loads(proc.stdout.strip().splitlines()[-1])
  print(case, md5, flush=True)
  return md5


def main(argv):
  """Regenerate conformance_cases.md5.json: each case's JAX MD5s from a
  subprocess of its own (`--one CASE` prints them as one JSON line),
  `--jobs N` of them at a time (default 1: each JAX compile takes
  gigabytes)."""
  if argv[:1] == ["--one"]:
    print(json.dumps(_jax_md5s(argv[1])), flush=True)
    return 0
  from concurrent.futures import ThreadPoolExecutor

  jobs = int(argv[argv.index("--jobs") + 1]) if "--jobs" in argv else 1
  with ThreadPoolExecutor(jobs) as pool:
    md5s = dict(zip(ALL_CASES, pool.map(_jax_subprocess, ALL_CASES)))
  out = {case: {"config": kw, "md5": md5s[case]}
         for case, kw in ALL_CASES.items()}
  with open(CONFORMANCE_JSON, "w") as f:
    json.dump(out, f, indent=1)
    f.write("\n")
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
