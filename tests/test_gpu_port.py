"""What the move to the GPU changed outside the kernels: the persistent
compile cache's placement, exact (HIGHEST-precision) one-hot emission
products, the retired ``run.use_tpu`` key, the mesh rule, and the native
library build key."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
from jax.extend import core as jax_core
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set in code;
    without it the cache sits at one fixed path inside the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "MITOFLEX_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax; from mitoflex_tpu.utils import compile_cache as c; "
            "assert c.enable(); print(jax.config.jax_compilation_cache_dir); "
            "print(c.cache_dir())")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    used, reported = r.stdout.split()
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(ROOT, ".jax_cache"))
    assert used == reported == want


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            subs = v if isinstance(v, (list, tuple)) else [v]
            for sub in subs:
                if isinstance(sub, jax_core.ClosedJaxpr):
                    out.extend(_dot_precisions(sub.jaxpr))
                elif isinstance(sub, jax_core.Jaxpr):
                    out.extend(_dot_precisions(sub))
    return out


def _phmm_args():
    from mitoflex_tpu.models import hmm as hmm_models
    from mitoflex_tpu.ops import phmm as phmm_ops

    prof = phmm_ops.stage_profile(hmm_models.profile_from_consensus("X", "ACGT" * 8))
    return prof, jnp.zeros((4, 16), jnp.int8), jnp.full((4,), 16, jnp.int32)


def _op(name):
    from mitoflex_tpu.models import codon
    from mitoflex_tpu.ops import genewise as genewise_ops
    from mitoflex_tpu.ops import phmm as phmm_ops
    from mitoflex_tpu.ops import sw as sw_ops

    sub = jnp.asarray(codon.blosum62())
    q, ql = jnp.zeros((2, 8), jnp.int8), jnp.full((2,), 8, jnp.int32)
    if name == "viterbi_scan":
        prof, s, l = _phmm_args()
        return lambda: phmm_ops.viterbi_scan(prof, s, l, 32)
    if name == "viterbi_scores":
        prof, s, l = _phmm_args()
        return lambda: phmm_ops.viterbi_scores(prof, s, l, 32)
    if name == "viterbi_scores_multi":
        prof, s, l = _phmm_args()
        stack = phmm_ops.stack_profiles([prof, prof])
        return lambda: phmm_ops.viterbi_scores_multi(
            stack, jnp.asarray([32, 32], jnp.int32), s, l)
    if name == "sw_align":
        return lambda: sw_ops.sw_align(q, ql, q, ql, sub)
    if name == "genewise_align":
        return lambda: genewise_ops.genewise_align(q, ql, q, ql, sub)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["viterbi_scan", "viterbi_scores",
                                  "viterbi_scores_multi", "sw_align",
                                  "genewise_align"])
def test_one_hot_products_request_highest(name):
    """Every matrix product in the DP scans is a one-hot emission select;
    each must ask for HIGHEST so a GPU cannot run it in TF32."""
    precs = _dot_precisions(jax.make_jaxpr(_op(name))().jaxpr)
    assert precs, "no dot_general found"
    highest = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(x == highest for x in p), p


def test_config_file_naming_use_tpu_still_loads(tmp_path, capsys):
    from mitoflex_tpu.config import RuntimeConfig, load_config_file

    p = tmp_path / "old.py"
    p.write_text("config = {'run': {'use_tpu': True, 'workname': 'w'}}\n")
    cfg = load_config_file(str(p))
    assert cfg.run.workname == "w"
    assert not hasattr(RuntimeConfig(), "use_tpu")
    assert "run.use_tpu is no longer used" in capsys.readouterr().out


def test_mesh_shape_one_means_no_mesh(tmp_path):
    from mitoflex_tpu.config import PipelineConfig
    from mitoflex_tpu.pipeline import PipelineContext

    cfg = PipelineConfig()
    cfg.run.basedir = str(tmp_path)
    cfg.search.disable_taxa = True
    cfg.run.mesh_shape = [1]
    assert PipelineContext.create(cfg).mesh is None
    cfg.run.mesh_shape = None
    ctx = PipelineContext.create(cfg)
    assert int(np.prod(ctx.mesh.devices.shape)) == len(jax.devices())


def test_mesh_build_failure_raises(tmp_path):
    """A mesh that cannot be built stops the run (no silent single-device
    fallback)."""
    from mitoflex_tpu.config import PipelineConfig
    from mitoflex_tpu.pipeline import PipelineContext

    cfg = PipelineConfig()
    cfg.run.basedir = str(tmp_path)
    cfg.search.disable_taxa = True
    cfg.run.mesh_shape = [len(jax.devices()) + 1]
    with pytest.raises(Exception):
        PipelineContext.create(cfg)


def test_native_library_is_keyed_by_sources_and_host():
    from mitoflex_tpu.native import fastq_native

    path = fastq_native.library_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "mitoflex_tpu", "native", "build")
    assert path == fastq_native.library_path()
    if fastq_native.available():
        assert os.path.exists(path)
    assert "-march=native" not in fastq_native._CXXFLAGS
