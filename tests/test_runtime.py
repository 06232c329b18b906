"""Process-level plumbing: pytree records, the compile-cache directory,
sweep workers pinned to GPUs, the chip smoke test's refusal without a GPU,
and (on a machine with a card) the compiled CorAl kernel."""
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tbv_slam_public_tpu.core import runtime
from tbv_slam_public_tpu.core.types import PointCloud, pytree_dataclass
from tbv_slam_public_tpu.harness import sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(n=5):
    return PointCloud(xy=jnp.arange(2.0 * n).reshape(n, 2),
                      intensity=jnp.ones((n,)), mask=jnp.ones((n,), bool))


# ---- pytree dataclass -------------------------------------------------------
def test_pytree_dataclass_replace_is_a_copy():
    pc = _cloud()
    pc2 = pc.replace(intensity=pc.intensity * 3.0)
    np.testing.assert_array_equal(pc2.intensity, 3.0)
    np.testing.assert_array_equal(pc.intensity, 1.0)
    assert pc2.xy is pc.xy
    with pytest.raises(AttributeError):
        pc.xy = None  # frozen


def test_pytree_dataclass_tree_map_and_leaves():
    pc = _cloud()
    leaves, treedef = jax.tree_util.tree_flatten(pc)
    assert len(leaves) == 3  # every field is a leaf, in field order
    assert leaves[0] is pc.xy
    doubled = jax.tree.map(lambda x: x * 2, pc)
    assert isinstance(doubled, PointCloud)
    np.testing.assert_array_equal(doubled.xy, pc.xy * 2)
    assert jax.tree_util.tree_unflatten(treedef, leaves).capacity == 5


def test_pytree_dataclass_jit_vmap_round_trip():
    @pytree_dataclass
    class Pair:
        a: jnp.ndarray
        b: jnp.ndarray

    @jax.jit
    def swap(p: Pair) -> Pair:
        return p.replace(a=p.b, b=p.a + 1.0)

    out = swap(Pair(a=jnp.zeros(3), b=jnp.ones(3)))
    assert isinstance(out, Pair)
    np.testing.assert_array_equal(out.a, 1.0)
    np.testing.assert_array_equal(out.b, 1.0)
    batched = jax.vmap(swap)(Pair(a=jnp.zeros((4, 3)), b=jnp.ones((4, 3))))
    assert batched.a.shape == (4, 3)


# ---- compile cache ------------------------------------------------------------
def test_compile_cache_respects_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert runtime.enable_compile_cache() == str(tmp_path / "c")
    # nothing is set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_default(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = runtime.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert runtime.enable_compile_cache() == path  # stable
        assert os.path.isdir(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ---- sweep workers on GPUs -------------------------------------------------
def test_visible_gpus_cpu_run_and_env(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert runtime.visible_gpus() is None
    monkeypatch.delenv("JAX_PLATFORMS")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert runtime.visible_gpus() == ["2", "3"]


def test_sweep_worker_envs_one_card_each(monkeypatch):
    monkeypatch.setattr(runtime, "visible_gpus", lambda: ["0", "1", "2"])
    envs = sweep.worker_envs(3)
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2"]
    with pytest.raises(ValueError, match="3 visible GPU"):
        sweep.worker_envs(4)


def test_sweep_worker_envs_cpu_unchanged(monkeypatch):
    monkeypatch.setattr(runtime, "visible_gpus", lambda: None)
    assert sweep.worker_envs(5) == [None] * 5


def test_sweep_pinned_jobs_never_share_a_card(monkeypatch):
    """More jobs than cards: every job runs, each on a pinned card, and no
    two running jobs ever hold the same card."""
    monkeypatch.setattr(runtime, "visible_gpus", lambda: ["0", "1"])
    lock = threading.Lock()
    busy, seen = set(), []

    def fake_job(mode, dataset, outdir, overrides, max_frames, env=None):
        card = env["CUDA_VISIBLE_DEVICES"]
        with lock:
            assert card not in busy
            busy.add(card)
            seen.append(card)
        time.sleep(0.01)
        with lock:
            busy.remove(card)
        return {"out": outdir}

    monkeypatch.setattr(sweep, "_run_job_subprocess", fake_job)
    done = sweep._run_pinned(list(range(7)),
                             lambda k: ("odometry", "sim", f"job_{k}", [], 0),
                             workers=2)
    assert sorted(done) == list(range(7))
    assert done[3] == {"out": "job_3"}
    assert sorted(set(seen)) == ["0", "1"]


# ---- chip smoke test ---------------------------------------------------------
def test_chip_smoke_refuses_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Outside the repository the script cannot import the system."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


# ---- on the card ---------------------------------------------------------------
@pytest.fixture
def gpu():
    """Skip unless an NVIDIA card is visible (asked of nvidia-smi when the
    test runs, never at import)."""
    if not runtime.nvidia_smi_cards():
        pytest.skip("needs an NVIDIA GPU")


_GPU_KERNEL_CHECK = """
import jax, numpy as np
import chip_smoke as cs
from tbv_slam_public_tpu.ops import coral
from tbv_slam_public_tpu.pallas import coral_moments
assert jax.devices()[0].platform == "gpu"
args = cs.coral_clouds(np.random.default_rng(0), 4, 1024)
got = jax.vmap(lambda q, qm, p, pm: coral_moments.neighbor_moments(
    q, qm, p, pm, 1.0))(*args)
with jax.default_matmul_precision("highest"):
    ref = jax.vmap(lambda q, qm, p, pm: coral._neighbor_moments(
        q, qm, p, pm, 1.0))(*args)
cs._check_moments(got, ref, "compiled kernel vs plain")
print("KERNEL_OK")
"""


@pytest.mark.gpu
def test_compiled_coral_kernel_on_gpu(gpu):
    """The Triton kernel compiled for the card (not the interpreter)
    against the plain form, in a child process that owns the card."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", _GPU_KERNEL_CHECK], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "KERNEL_OK" in r.stdout
