"""The port's host utilities (advancedvi_jl_tpu_torch.utils): checkpoints
(bitwise resume, refusals, a JAX checkpoint carried over through
convert.py), the streamed-data engine (the port's own copy of the native
reshuffle library, its permutations and batches equal to the JAX
package's), ``optimize_streamed``, the progress meter (after the JAX
package's meter tests) and the profiling guards."""

import io
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from numpy.testing import assert_allclose

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.models.logreg import make_logreg as jax_make_logreg
from advancedvi_jl_tpu.utils import checkpoint as jcheckpoint
from advancedvi_jl_tpu.utils import data as jdata
from advancedvi_jl_tpu_torch import convert
from advancedvi_jl_tpu_torch.core.pytree import tree_leaves
from advancedvi_jl_tpu_torch.utils import checkpoint, data, profiling
from advancedvi_jl_tpu_torch.utils.progress import ProgressMeter

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _gauss_target(d=5):
    mu = torch.linspace(-1.0, 1.0, d)
    return avt.fn_target(lambda th, _: -0.5 * ((th - mu) ** 2).sum(-1), d)


def _alg(n_samples=4, optimizer=None):
    return avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=n_samples,
                                   optimizer=optimizer or avt.adam(1e-2),
                                   operator=avt.ClipScale())


def _states_equal(a, b):
    la, lb = checkpoint.state_leaves(a), checkpoint.state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _families():
    d = 5
    return {
        "meanfield": (avt.MeanFieldGaussian(torch.zeros(d), torch.ones(d)), _alg()),
        "meanfield_float64": (avt.MeanFieldGaussian(torch.zeros(d, dtype=torch.float64),
                                                    torch.ones(d, dtype=torch.float64)),
                              _alg()),
        "fullrank_dowg": (avt.FullRankGaussian(torch.zeros(d), torch.eye(d)),
                          _alg(optimizer=avt.dowg())),
        "lowrank": (avt.LowRankGaussian(torch.zeros(d), torch.ones(d), 0.1 * torch.ones(d, 2)),
                    _alg()),
        "mixture": (avt.mixture_meanfield(1, d, 3, device="cpu"),
                    avt.ParamSpaceSGD(avt.MixtureELBO(n_samples=4), avt.adam(1e-2),
                                      avt.NoAveraging(), avt.ClipScale())),
        "planar_flow": (avt.planar_flow(2, d, 3, device="cpu"),
                        avt.ParamSpaceSGD(avt.FlowELBO(n_samples=4), avt.adam(1e-2),
                                          avt.NoAveraging(), avt.IdentityOperator())),
    }


@pytest.mark.parametrize("family", sorted(_families()))
def test_checkpoint_resume_is_bitwise(tmp_path, family):
    """save at 10 steps, restore onto a fresh template, 10 more: the whole
    state and output equal the uninterrupted 20 steps' bit for bit
    (tests/test_integration.py:123, :256)."""
    q0, alg = _families()[family]
    target = _gauss_target()
    out_full, infos_full, st_full = avt.optimize(0, alg, 20, target, q0)
    _, _, st_half = avt.optimize(0, alg, 10, target, q0)
    path = tmp_path / "ckpt.npz"
    avt.save_state(str(path), st_half)
    restored = avt.restore_state(str(path), alg.init(0, q0, target))
    assert restored.iteration == 10
    out, infos, st = avt.optimize(0, alg, 10, target, q0, state=restored)
    _states_equal(st, st_full)
    for a, b in zip(tree_leaves(out), tree_leaves(out_full)):
        assert torch.equal(a, b)
    assert [r["elbo"] for r in infos] == [r["elbo"] for r in infos_full[10:]]


def test_checkpoint_of_an_ingested_subsampled_state(tmp_path):
    """The schedule's permutation, epoch, step and seed words and the
    ingested target's data ride along: a resumed subsampled run on a
    ppl model is the uninterrupted one."""
    rng = np.random.default_rng(0)
    y = rng.standard_normal(32).astype(np.float32)

    def model(d):
        mu = avt.ppl.sample("mu", avt.ppl.Normal(0.0, 1.0))
        with avt.ppl.plate("obs", 32):
            avt.ppl.sample("y", avt.ppl.Normal(mu, 1.0), obs=d["y"])

    m = avt.ppl.ingest(model, data={"y": y}, device="cpu")
    alg = avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=4, optimizer=avt.adam(1e-2),
                                  operator=avt.ClipScale(),
                                  subsampling=avt.ReshufflingBatchSubsampling(32, 8))
    _, _, full = avt.optimize(3, alg, 13, m.target, m.q_init())
    _, _, half = avt.optimize(3, alg, 6, m.target, m.q_init())
    avt.save_state(tmp_path / "s", half)
    st = avt.restore_state(tmp_path / "s", alg.init(3, m.q_init(), m.target))
    assert st.obj_state.epoch == half.obj_state.epoch and st.seed == half.seed
    _, _, resumed = avt.optimize(3, alg, 7, None, None, state=st)
    _states_equal(resumed, full)


def test_checkpoint_refuses_another_configuration(tmp_path):
    target = _gauss_target()
    q0 = avt.MeanFieldGaussian(torch.zeros(5), torch.ones(5))
    _, _, state = avt.optimize(0, _alg(), 5, target, q0)
    path = str(tmp_path / "ckpt.npz")
    avt.save_state(path, state)
    other = avt.KLMinScoreGradDescent(n_samples=4, operator=avt.ClipScale())
    with pytest.raises(ValueError, match="structure mismatch"):
        avt.restore_state(path, other.init(0, avt.FullRankGaussian(torch.zeros(5)), target))
    with pytest.raises(ValueError, match="structure mismatch"):  # another rule
        avt.restore_state(path, _alg(optimizer=avt.dowg()).init(0, q0, target))
    with pytest.raises(ValueError, match="structure mismatch"):  # another dtype
        avt.restore_state(path, _alg().init(0, avt.MeanFieldGaussian(
            torch.zeros(5, dtype=torch.float64), torch.ones(5, dtype=torch.float64)), target))


def test_checkpoint_refuses_a_changed_static_field(tmp_path):
    """A static float of the target (a Sigmoid's bounds) is part of the
    fingerprint, as JAX's static fields are (utils/checkpoint.py:307)."""
    base = _gauss_target(2)

    def state_for(hi):
        target = avt.TransformedTarget(base, avt.stacked((avt.Identity(), 1),
                                                         (avt.Sigmoid(0.0, hi), 1)))
        return _alg().init(0, avt.MeanFieldGaussian(torch.zeros(2), torch.ones(2)), target)

    avt.save_state(tmp_path / "a", state_for(1.0))
    avt.restore_state(tmp_path / "a", state_for(1.0))
    with pytest.raises(ValueError, match="structure mismatch"):
        avt.restore_state(tmp_path / "a", state_for(2.0))


def test_checkpoint_extensionless_path_and_leaves(tmp_path):
    target = _gauss_target()
    q0 = avt.MeanFieldGaussian(torch.zeros(5), torch.ones(5))
    _, _, state = avt.optimize(7, _alg(), 5, target, q0)
    avt.save_state(str(tmp_path / "noext"), state)
    assert (tmp_path / "noext.npz").is_file()
    restored = avt.restore_state(str(tmp_path / "noext"), _alg().init(7, q0, target))
    assert restored.iteration == 5 and restored.seed == state.seed
    assert restored.opt_state.count == 5 and restored.avg_state[1] == 6
    with np.load(tmp_path / "noext.npz") as f:
        ints = [f[k] for k in f.files if k.startswith("leaf_") and f[k].dtype == np.int64]
    # iteration, Adam's count, the averaging's step, the two seed words
    assert sorted(int(v) for v in ints) == sorted([5, 5, 6, *state.seed])


def test_checkpoint_restores_in_another_process(tmp_path):
    """The fingerprint holds no address or process-local name: a state saved
    by one process restores in another (tests/test_integration.py:170)."""
    script = f"""
import torch
import advancedvi_jl_tpu_torch as avt
target = avt.fn_target(lambda th, _: -0.5 * (th ** 2).sum(-1), 3)
q0 = avt.MeanFieldGaussian(torch.zeros(3), torch.ones(3))
alg = avt.KLMinRepGradDescent(n_samples=2, operator=avt.ClipScale())
_, _, state = avt.optimize(0, alg, 3, target, q0)
avt.save_state({str(tmp_path / "xp")!r}, state)
"""
    subprocess.run([sys.executable, "-c", script], check=True, cwd=ROOT)
    target = avt.fn_target(lambda th, _: -0.5 * (th ** 2).sum(-1), 3)
    alg = avt.KLMinRepGradDescent(n_samples=2, operator=avt.ClipScale())
    q0 = avt.MeanFieldGaussian(torch.zeros(3), torch.ones(3))
    assert avt.restore_state(str(tmp_path / "xp"), alg.init(0, q0, target)).iteration == 3


def _jax_general_draws(alg, state, steps, n):
    step = jax.jit(alg.step)
    draws = []
    for _ in range(steps):
        _, u = state.q.sample_with_base(jax.random.fold_in(state.key, state.iteration), n)
        draws.append(np.asarray(u))
        state, _ = step(state)
    return state, draws


def test_jax_checkpoint_continues_as_jax_through_convert(tmp_path):
    """JAX's save_state after 5 steps on the flagship logreg, restored into
    the port through convert.paramspace_state_from_jax_checkpoint, then 5
    more steps on each side on the same injected draws: the port lands on
    JAX's state (rtol 1e-5, the general path's parity bars)."""
    jp = jax_make_logreg(jax.random.key(11), n_data=208, n_features=60)
    tp = convert.logreg_from_numpy(jp.X, jp.y, jp.likeadj, jp.prior_scale, device="cpu")
    d = jp.dim
    jalg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=10, optimizer=optax.adam(1e-3),
                                    operator=javt.ClipScale())
    jq0 = javt.MeanFieldGaussian(jnp.zeros(d), 0.1 * jnp.ones(d))
    js, _ = _jax_general_draws(jalg, jalg.init(jax.random.key(0), jq0, jp.unconstrained()), 5, 10)
    path = tmp_path / "jax.npz"
    jcheckpoint.save_state(str(path), js)
    talg = _alg(10, avt.adam(1e-3))
    template = talg.init(0, avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d)),
                         tp.unconstrained())
    ts = convert.paramspace_state_from_jax_checkpoint(path, template, seed=4)
    assert ts.iteration == 5 and ts.opt_state.count == 5 and ts.avg_state[1] == 6
    assert ts.seed == (4, 0)
    assert_allclose(ts.q.location.numpy(), np.asarray(js.q.location), rtol=0, atol=0)
    assert torch.equal(ts.prob.prob.X, torch.from_numpy(np.asarray(jp.X)))
    js2, draws = _jax_general_draws(jalg, js, 5, 10)
    for u in draws:
        ts, _ = talg.step(ts, noise=torch.from_numpy(u))
    assert_allclose(ts.q.location.numpy(), np.asarray(js2.q.location), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.q.scale_diag.numpy(), np.asarray(js2.q.scale_diag), rtol=1e-5, atol=1e-6)
    assert_allclose(ts.opt_state.mu.location.numpy(), np.asarray(js2.opt_state[0].mu.location),
                    rtol=1e-5, atol=1e-7)
    assert_allclose(talg.output(ts).location.numpy(), np.asarray(jalg.output(js2).location),
                    rtol=1e-5, atol=1e-6)


def test_jax_checkpoint_of_another_structure_is_refused(tmp_path):
    jalg = javt.KLMinRepGradDescent(entropy=javt.STL, n_samples=2, optimizer=optax.adam(1e-3))
    jt = javt.fn_target(lambda th, _: -0.5 * jnp.sum(th ** 2), 3)
    js = jalg.init(jax.random.key(0), javt.MeanFieldGaussian(jnp.zeros(3), jnp.ones(3)), jt)
    jcheckpoint.save_state(str(tmp_path / "j"), js)
    talg = _alg(2, avt.dowg())
    template = talg.init(0, avt.MeanFieldGaussian(torch.zeros(3), torch.ones(3)), _gauss_target(3))
    with pytest.raises(ValueError, match="in the checkpoint"):  # DoWG's leaves are not Adam's
        convert.paramspace_state_from_jax_checkpoint(tmp_path / "j", template)


# ---------------------------------------------------------------------------
# Streamed data
# ---------------------------------------------------------------------------


def test_the_native_library_builds_from_the_ports_own_source():
    assert data.native_available()
    assert data.SOURCE == ROOT / "advancedvi_jl_tpu_torch" / "csrc" / "reshuffle.cc"
    assert data.library_path().parent == ROOT / "build" / "native"
    assert data.library_path().is_file()


@pytest.mark.parametrize("seed,n", [(0, 1), (7, 1000), (123456789, 4097)])
def test_fill_permutation_is_jaxs(seed, n):
    if not jdata.native_available():
        pytest.skip("the JAX package's native library did not build")
    p = data.fill_permutation(seed, n)
    assert p.dtype == np.int32 and sorted(p.tolist()) == list(range(n))
    np.testing.assert_array_equal(p, jdata.fill_permutation(seed, n))


def test_gather_rows_matches_numpy():
    X = np.random.default_rng(0).normal(size=(5000, 64)).astype(np.float32)
    idx = data.fill_permutation(3, 5000)[:2048]
    np.testing.assert_array_equal(data.gather_rows(X, idx), X[idx])
    np.testing.assert_array_equal(data.gather_rows(X, idx, n_threads=1), X[idx])


def _host_arrays(n=100, k=4):
    return (np.arange(n * k, dtype=np.float32).reshape(n, k), np.arange(n, dtype=np.float32))


def test_host_loader_batches_are_jaxs_over_two_epochs():
    X, y = _host_arrays()
    ours, theirs = data.HostDataLoader(X, y, 16, seed=5), jdata.HostDataLoader(X, y, 16, seed=5)
    assert len(ours) == 6
    seen = []
    for t in range(12):
        Xb, yb, idx = ours.next_batch()
        jXb, jyb, jidx = theirs.next_batch()
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(Xb, jXb)
        np.testing.assert_array_equal(yb, jyb)
        np.testing.assert_array_equal(Xb, X[idx])
        assert yb.shape == (16, 1)
        if t < 6:
            seen.extend(idx.tolist())
    assert len(set(seen)) == len(seen) == 96
    np.testing.assert_array_equal(seen, data.fill_permutation(5, 100)[:96])
    assert ours.epoch == 2


def test_prefetching_loader_yields_the_loaders_sequence():
    X, y = _host_arrays()
    plain = data.HostDataLoader(X, y, 16, seed=2)
    with avt.PrefetchingLoader(data.HostDataLoader(X, y, 16, seed=2), depth=3) as pre:
        for _ in range(15):
            a, b = plain.next_batch(), pre.next_batch()
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    assert not pre._thread.is_alive()
    with pytest.raises(ValueError, match="exceeds"):
        avt.HostDataLoader(X, y, 101)


def _linreg(n=4096, d=8, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    y = (X @ w + 0.1 * rng.normal(size=(n,))).astype(np.float32)
    return X, y


def _linreg_template(X, y, b):
    s2 = 0.01

    def loglike(theta, dat):
        Xb, yb = dat
        return torch.sum(-0.5 * (yb - theta @ Xb.T) ** 2 / s2, dim=-1)

    t = avt.factorized_target(lambda th: torch.sum(-0.5 * th * th, dim=-1), loglike,
                              data=(torch.from_numpy(X[:b]), torch.from_numpy(y[:b])),
                              dim=X.shape[1])
    import dataclasses

    return dataclasses.replace(t, likeadj=torch.tensor(X.shape[0] / b))


def test_optimize_streamed_fits_the_posterior_mean():
    """tests/test_native.py:131 on the port: batches from the prefetching
    native loader reach the step through place_batch; the Bayesian linear
    regression's exact posterior mean is recovered."""
    import dataclasses

    X, y = _linreg()
    n, d, b = X.shape[0], X.shape[1], 512
    post_mean = np.linalg.solve(X.T @ X / 0.01 + np.eye(d), X.T @ y / 0.01)
    loader = avt.PrefetchingLoader(avt.HostDataLoader(X, y, b, seed=11))
    try:
        q, infos, state = avt.optimize_streamed(
            0, _alg(8, avt.adam(2e-2)), 1200, _linreg_template(X, y, b),
            lambda p, Xb, yb: dataclasses.replace(p, data=(Xb, yb[:, 0])), loader,
            avt.MeanFieldGaussian(torch.zeros(d), 0.1 * torch.ones(d)))
    finally:
        loader.close()
    assert len(infos) == 1200 and infos[-1]["iteration"] == 1200 and state.iteration == 1200
    assert math.isfinite(infos[-1]["elbo"])
    err = np.linalg.norm(q.location.numpy() - post_mean)
    assert err < 0.15 * np.linalg.norm(post_mean), err


def test_optimize_streamed_names_the_first_non_finite_step():
    import dataclasses

    X, y = _linreg(n=256)
    X[100:] = np.nan
    loader = avt.HostDataLoader(X, y, 32, seed=0)
    first_bad = next(t for t in range(8) if (loader._perm[32 * t:32 * (t + 1)] >= 100).any())
    with pytest.raises(avt.DivergenceError, match=f"iteration {first_bad + 1}"):
        avt.optimize_streamed(0, _alg(), 8, _linreg_template(X, y, 32),
                              lambda p, Xb, yb: dataclasses.replace(p, data=(Xb, yb[:, 0])),
                              loader, avt.MeanFieldGaussian(torch.zeros(8), torch.ones(8)))


# ---------------------------------------------------------------------------
# The progress meter
# ---------------------------------------------------------------------------


def test_progress_meter_merges_info_names():
    pm = ProgressMeter(100, stream=io.StringIO(), min_interval_s=0.0)
    line = pm.render(50, {"elbo": torch.tensor(-1.5), "epoch": 3,
                          "covweighted_fisher": np.float64(0.25), "terminate": False,
                          "diverged": False, "vec": np.zeros(3)})
    assert "elbo=-1.5" in line and "epoch=3" in line and "covweighted_fisher=0.25" in line
    assert "terminate" not in line and "diverged" not in line and "vec" not in line
    assert "50/100" in line and "it/s" in line


def test_progress_chunk_mode_streams_without_changing_the_run():
    """No chunk_size: about 20 chunks, the meter moving at each chunk's one
    host read; the result is the silent run's, bit for bit."""
    target = _gauss_target(4)
    q0 = avt.MeanFieldGaussian(torch.zeros(4), torch.ones(4))
    buf = io.StringIO()
    out, infos, _ = avt.optimize(0, _alg(), 200, target, q0,
                                 progress=ProgressMeter(200, stream=buf, min_interval_s=0.0))
    text = buf.getvalue()
    assert text.count("\r") == 20
    assert "elbo=" in text and "200/200" in text and text.endswith("\n")
    out2, infos2, _ = avt.optimize(0, _alg(), 200, target, q0)
    assert torch.equal(out.location, out2.location)
    assert [r["elbo"] for r in infos] == [r["elbo"] for r in infos2]


def test_progress_callback_mode_merges_extras():
    buf = io.StringIO()

    def cb(iteration, state, info):
        return {"my_metric": float(iteration) * 2.0}

    avt.optimize(0, _alg(), 10, _gauss_target(4),
                 avt.MeanFieldGaussian(torch.zeros(4), torch.ones(4)), callback=cb,
                 progress=ProgressMeter(10, stream=buf, min_interval_s=0.0))
    text = buf.getvalue()
    assert "my_metric=20" in text and "elbo=" in text and text.endswith("\n")


def test_show_progress_writes_one_line_to_stderr(capsys):
    avt.optimize(0, _alg(), 40, _gauss_target(4),
                 avt.MeanFieldGaussian(torch.zeros(4), torch.ones(4)), show_progress=True)
    err = capsys.readouterr().err
    assert "40/40" in err and err.endswith("\n") and err.count("\n") == 1


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_retrace_guard_passes_on_a_stable_step():
    alg = _alg()
    state = alg.init(0, avt.MeanFieldGaussian(torch.zeros(5), torch.ones(5)), _gauss_target())
    state, _ = alg.step(state)
    with profiling.retrace_guard(alg.step):
        for _ in range(20):
            state, _ = alg.step(state)


def test_retrace_guard_counts_new_k5_traces():
    target = avt.fn_target(lambda th, _: -(th ** 4).sum(-1), 3)
    with pytest.raises(profiling.RetraceError, match="1 new"):
        with profiling.retrace_guard():
            avt.ad_spec(target, device="cpu")
    with profiling.retrace_guard(allowed=1):
        avt.ad_spec(target, device="cpu")


def test_nan_debugging_turns_on_anomaly_detection():
    assert not torch.is_anomaly_enabled()
    with profiling.nan_debugging():
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_trace_writes_a_chrome_trace(tmp_path):
    alg = _alg()
    state = alg.init(0, avt.MeanFieldGaussian(torch.zeros(5), torch.ones(5)), _gauss_target())
    with profiling.trace(str(tmp_path / "tb")):
        alg.step(state)
    text = (tmp_path / "tb" / "trace.json").read_text()
    assert '"traceEvents"' in text and "aten::" in text
