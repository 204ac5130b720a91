"""chip_smoke.py's phases at a tiny size on the CPU: the same functions the
card runs, with the CPU standing in for the device."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    return cs.make_sample(str(tmp_path_factory.mktemp("smoke")), cs.TINY)


def test_sample_is_deterministic(tmp_path, sample):
    again = cs.make_sample(str(tmp_path), cs.TINY)
    assert again["genome"] == sample["genome"]
    with open(sample["r1"], "rb") as a, open(again["r1"], "rb") as b:
        assert a.read() == b.read()
    assert cs._size_of(again) == cs.TINY


def test_one_card_flow(sample):
    """Phase 1 device routes + the CPU child's references + phase 2 against
    the child's host-route run: every comparison exact."""
    lines = cs.smoke_one_card(sample, cs.CompileClock(), "[cpu]")
    text = "\n".join(lines)
    for name in ("count31", "count141", "edges141", "graph141", "filter",
                 "viterbi_scores_multi", "viterbi_scan", "sw_align",
                 "genewise_align"):
        assert f"phase1 {name}: exact" in text
    assert "contigs.fa byte-identical" in text
    assert "locs.json byte-identical" in text
    assert "golden contract (cpu): circular, all 4 PCGs" in text


def test_mesh_flow_matches_one_device(sample):
    """The --four-cards comparison on the virtual 8-device CPU mesh."""
    lines = cs.smoke_four_cards(sample, cs.CompileClock(), "[cpu]")
    assert sum("byte-identical" in line for line in lines) == 3


def test_mismatch_is_a_failure():
    got = {"x.a": np.arange(4)}
    with pytest.raises(cs.SmokeFailure, match="1 of 4 elements differ"):
        cs._same("x", got, {"x.a": np.array([0, 1, 2, 4])}, [])
    with pytest.raises(cs.SmokeFailure, match="shape/dtype"):
        cs._same("x", got, {"x.a": np.arange(4, dtype=np.int8)}, [])


def test_no_gpu_exits_nonzero_without_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_alone_exits_nonzero(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


def test_mesh_config_file(tmp_path):
    from mitoflex_tpu.config import load_config_file

    cfg = load_config_file(cs._mesh_config(str(tmp_path), [1]))
    assert cfg.run.mesh_shape == [1]


@pytest.mark.gpu
def test_phase1_on_gpu(gpu, sample):
    """On a card: the device routes against the in-process host routes."""
    lines = []
    cs.phase1_device(sample, lines)
    assert any("graph31: exact" in line for line in lines)
    assert any("map: exact" in line for line in lines)
