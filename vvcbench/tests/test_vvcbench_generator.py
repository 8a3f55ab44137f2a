"""The frozen generator and the frozen reference against data an
independent decoder made: the committed fixtures and their JAX MD5s."""
import hashlib
import json
import os

import pytest

from vvcbench import cells, reference
from vvcbench.frozen.encoder import config_from_json, encode_stream

TESTDATA = os.path.join(cells.REPO, "ffmpeg_tpu_torch", "testdata")


def _load(name):
  with open(os.path.join(TESTDATA, name)) as f:
    return json.load(f)


def _md5s(frames):
  return [hashlib.md5(f).hexdigest() for f in frames]


@pytest.mark.parametrize("fixture", ["ai720", "full1080"])
def test_frozen_generator_remakes_the_fixture_byte_for_byte(fixture):
  data = encode_stream(config_from_json(
      _load(f"{fixture}.md5.json")["config"]))[0]
  with open(os.path.join(TESTDATA, f"{fixture}.vvc"), "rb") as f:
    assert data == f.read()


@pytest.mark.parametrize("config", ["ra1080_full", "ai720"])
def test_configs_keep_the_common_test_conditions_widths(config):
  """10-bit samples, CTU 128 and a CTC QP, as JVET-T2010 codes them."""
  with open(os.path.join(cells.ROOT, "configs", config + ".json")) as f:
    cfg = json.load(f)
  gen = cfg["generator"]
  assert gen["bit_depth"] == 10 and gen["ctu_log2"] == 7
  assert gen["qp"] in (22, 27, 32, 37)
  assert cfg["reduced"] == ["n_frames"]
  # the one pair the generator refuses at CTU 128 (dual tree with CCLM)
  # and the pair neither package's parser reads at CTU 128 (CIIP, GPM)
  assert not gen.get("dual_tree") and gen["cclm"]
  assert not gen.get("ciip") and not gen.get("gpm")


# generated cases of every tool the two configurations turn on, with the
# JAX package's MD5s
CASES = [("tools_cases", "dmvr-tools-ra"), ("tools_cases", "alf-lmcs-ra"),
         ("tools_cases", "dmvr-bdof-tmvp"), ("tools_cases", "gpm-tools-ra"),
         ("tools_cases", "mrl-tools-ra"), ("tools_cases", "cclm-lmcs-ra")]


@pytest.mark.parametrize("stem,case", CASES, ids=[c for _, c in CASES])
def test_reference_decodes_committed_cases_to_the_jax_md5s(stem, case):
  entry = _load(f"{stem}.md5.json")[case]
  data = encode_stream(config_from_json(entry["config"]))[0]
  assert _md5s(reference.decode(data, "cpu")) == entry["md5"]


@pytest.mark.gpu
@pytest.mark.parametrize("fixture", ["ai720", "full1080"])
def test_reference_on_the_card_decodes_the_fixtures(fixture, cuda):
  """The plain path on the card, at 1080p and 720p, to the JAX MD5s."""
  with open(os.path.join(TESTDATA, f"{fixture}.vvc"), "rb") as f:
    data = f.read()
  assert _md5s(reference.decode(data, cuda)) == _load(
      f"{fixture}.md5.json")["md5"]
