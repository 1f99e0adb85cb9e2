"""The GPU bring-up surface, on the CPU: the x64 policy, the compilation
cache directory, and `chip_smoke.py` — its refusal to run without a GPU and
each of its phases at tiny sizes against the same solve on a second CPU
device (the sharded phases on four virtual devices)."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_python(code, env_updates, drop=()):
    env = dict(os.environ)
    for k in drop:
        env.pop(k, None)
    env.update(env_updates)
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)


@pytest.mark.parametrize("value,x64", [(None, True), ("", True),
                                       ("1", False)])
def test_x64_policy_from_environment(value, x64):
    """x64 is on unless PAROPT_TPU_NO_X64 holds a non-empty value; the
    platform plays no part."""
    env = {"JAX_PLATFORMS": "cpu"}
    drop = ("PAROPT_TPU_NO_X64",)
    if value is not None:
        env["PAROPT_TPU_NO_X64"] = value
        drop = ()
    out = _run_python("import jax, paropt_tpu; "
                      "print(jax.config.jax_enable_x64)", env, drop)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(x64)


def test_cache_dir_follows_env_var(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, wins over any fallback, and
    enabling the cache then sets no directory of its own."""
    from paropt_tpu.utils import compile_cache as cc

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.compilation_cache_dir() == str(tmp_path)
    assert cc.compilation_cache_dir(fallback="/elsewhere") == str(tmp_path)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert cc.enable_compilation_cache(fallback="/elsewhere") == \
        str(tmp_path)
    assert not any(k == "jax_compilation_cache_dir" for k, _ in calls)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    """Unset, the cache goes to the fixed `.jax_cache` in the checkout (or
    an explicit fallback), and that directory is set in JAX's config."""
    from paropt_tpu.utils import compile_cache as cc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cc.CHECKOUT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert cc.compilation_cache_dir() == cc.CHECKOUT_CACHE_DIR
    assert cc.compilation_cache_dir(fallback="/x") == "/x"
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    cc.enable_compilation_cache()
    assert ("jax_compilation_cache_dir", cc.CHECKOUT_CACHE_DIR) in calls


def test_chip_smoke_refuses_cpu():
    """On a CPU platform chip_smoke.py exits non-zero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def _devices():
    cpus = jax.devices("cpu")
    return cpus[0], cpus[1]


def test_chip_smoke_ip_phases_tiny():
    dev, ref = _devices()
    fobj = chip_smoke.phase_ip_f64(dev, ref, print, n=1 << 12)
    # at 4096 variables f32 stalls near 1e-5; the card runs 2^20 at 1e-6
    chip_smoke.phase_ip_f32(dev, ref, print, fobj, n=1 << 12, tol=1e-5,
                            rtol=1e-3)
    chip_smoke.phase_ip_scale(dev, print, n=1 << 13)


def test_chip_smoke_mma3d_phase_tiny():
    dev, ref = _devices()
    chip_smoke.phase_mma3d(dev, ref, print, small=(8, 4, 4),
                           large=(8, 4, 4), small_iters=3, large_iters=2)


def test_chip_smoke_tr_phases_tiny():
    dev, ref = _devices()
    chip_smoke.phase_tr2d(dev, ref, print, shape=(12, 6), iters=5)
    # 4 truncated iterations leave the frequency constraint ~2e-2 off
    chip_smoke.phase_eigtr(dev, ref, print, shape=(8, 4), iters=4, N=3,
                           max_infeas=5e-2)


def test_chip_smoke_callback_phase():
    chip_smoke.phase_callback(jax.devices("cpu")[0], print)


def test_chip_smoke_sharded_phases_on_four_devices():
    """The --chips 4 path on four virtual CPU devices: inputs split over
    all four, results equal to the one-device solve."""
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    chip_smoke.phase_sharded_ip(devices, print, n=1 << 12)
    chip_smoke.phase_sharded_mma(devices, print, shape=(8, 4, 4), iters=2)


def _keep_cache_dir(monkeypatch):
    """main() enables the compilation cache; keep the suite's own."""
    from paropt_tpu.utils import compile_cache as cc
    monkeypatch.setattr(cc, "enable_compilation_cache", lambda: "(suite)")


def test_chip_smoke_phase_failure_is_reported(monkeypatch, capsys):
    """A failing phase makes main() return non-zero with no result line,
    and the phases after it still run."""
    ran = []

    class FakeDev:
        platform, device_kind = "gpu", "fake"

    cpu = jax.devices("cpu")[0]
    monkeypatch.setattr(chip_smoke.jax, "devices",
                        lambda *a: [FakeDev()] if not a else [cpu])
    monkeypatch.setattr(chip_smoke, "_nvidia_smi",
                        lambda: ["Fake GPU, 700.00 W"])
    _keep_cache_dir(monkeypatch)

    def boom(*a, **k):
        ran.append("ip-f64")
        raise chip_smoke.PhaseFailure("forced")

    monkeypatch.setattr(chip_smoke, "phase_ip_f64", boom)
    for name in ("phase_ip_scale", "phase_mma3d", "phase_tr2d",
                 "phase_eigtr", "phase_callback"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: ran.append(_n))
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert "[ip-f64] FAIL" in out and "[ip-f32] FAIL" in out
    assert "Fake GPU, 700.00 W" in out
    assert '"ok"' not in out
    assert ran == ["ip-f64", "phase_ip_scale", "phase_mma3d", "phase_tr2d",
                   "phase_eigtr", "phase_callback"]


@pytest.mark.gpu
def test_chip_smoke_ip_on_gpu(gpu_device):
    """On a card: the f64 IP phase at 2^16 against the host CPU."""
    chip_smoke.phase_ip_f64(gpu_device, jax.devices("cpu")[0], print,
                            n=1 << 16)


def test_chip_smoke_result_line_schema(monkeypatch, capsys):
    """Every phase passing gives exactly the contract's last line."""
    class FakeDev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    cpu = jax.devices("cpu")[0]
    monkeypatch.setattr(chip_smoke.jax, "devices",
                        lambda *a: [FakeDev()] if not a else [cpu])
    monkeypatch.setattr(chip_smoke, "_nvidia_smi",
                        lambda: ["NVIDIA H100 80GB HBM3, 700.00 W"])
    _keep_cache_dir(monkeypatch)
    monkeypatch.setattr(chip_smoke, "phase_ip_f64", lambda *a, **k: 1.0)
    for name in ("phase_ip_f32", "phase_ip_scale", "phase_mma3d",
                 "phase_tr2d", "phase_eigtr", "phase_callback"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_full_precision_pins_f32_products():
    """`full_precision` traces its function's products at HIGHEST (no TF32
    passes on a GPU); the quasi-Newton update and the KKT solve carry it."""
    import jax.numpy as jnp
    from paropt_tpu.dtypes import full_precision
    from paropt_tpu.ops import qn as qnmod

    def prod(a, b):
        return a @ b

    a = jnp.ones((4, 8), jnp.float32)
    b = jnp.ones((8, 2), jnp.float32)
    plain = str(jax.make_jaxpr(prod)(a, b))
    pinned = str(jax.make_jaxpr(full_precision(prod))(a, b))
    assert "HIGHEST" not in plain
    assert "HIGHEST" in pinned
    st = qnmod.qn_init(3, 64, dtype=jnp.float32)
    s = jnp.ones(64, jnp.float32)
    assert "HIGHEST" in str(jax.make_jaxpr(qnmod.qn_update)(st, s, 2 * s))
