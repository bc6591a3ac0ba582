"""The port's stop channel and info rows (advancedvi_jl_tpu_torch.optimize,
algorithms/termination.py), mirroring tests/test_termination.py:41-160 on
ADVI and on a measure-space algorithm, and the chunk rows' repair: every
scalar tensor entry of a step's info reaches its row."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedvi_jl_tpu as javt
import advancedvi_jl_tpu_torch as avt
from advancedvi_jl_tpu.models.normal import normal_fullrank as jax_normal_fullrank
from advancedvi_jl_tpu.models.normal import normal_meanfield as jax_normal_meanfield
from advancedvi_jl_tpu_torch import convert

torch.set_num_threads(1)
CPU = "cpu"


def _advi():
    return avt.KLMinRepGradDescent(entropy=avt.STL, n_samples=4, operator=avt.ClipScale())


def _ngd():
    return avt.KLMinNaturalGradDescent(stepsize=0.1, n_samples=8)


def _setup(kind):
    """(algorithm maker, target, q0, the ELBO to stop at): ADVI on
    tests/test_termination.py's d = 4 mean-field Gaussian (first reaching
    -1.0 at step 29), or NGD on it with a full-rank q (0.0 at step 12)."""
    jt, _, _ = jax_normal_meanfield(jax.random.key(3), 4)
    target = convert.normal_target_from_numpy(jt.mu, jt.scale_tril, device=CPU)
    if kind == "advi":
        return _advi, target, avt.MeanFieldGaussian(torch.zeros(4), torch.ones(4)), -1.0
    return _ngd, target, avt.FullRankGaussian(torch.zeros(4)), 0.0


KINDS = ["advi", "ngd"]


@pytest.mark.parametrize("kind", KINDS)
def test_target_elbo_early_stop_chunk_mode(kind):
    """WithTermination + elbo_at_least stops at the exact first step whose
    ELBO reaches the target; the state is that step's."""
    make, target, q0, x = _setup(kind)
    alg = avt.WithTermination(make(), avt.elbo_at_least(x))
    out, infos, state = avt.optimize(0, alg, 2000, target, q0, chunk_size=8)
    stop = infos[-1]["iteration"]
    assert 8 < stop < 2000 and state.iteration == stop
    assert infos[-1]["elbo"] >= x and infos[-1]["terminate"] is True
    assert all(r["elbo"] < x for r in infos[:-1])
    assert [r["iteration"] for r in infos] == list(range(1, stop + 1))
    assert torch.isfinite(out.location).all()


@pytest.mark.parametrize("kind", KINDS)
def test_early_stop_rows_and_state_match_the_dense_run(kind):
    """The terminated run's rows are the prefix of the run without the
    criterion, and its state is that run's state at the stop, bitwise."""
    make, target, q0, x = _setup(kind)
    _, dense, _ = avt.optimize(0, make(), 300, target, q0)
    _, rows, st = avt.optimize(0, avt.WithTermination(make(), avt.elbo_at_least(x)), 300,
                               target, q0)
    stop = rows[-1]["iteration"]
    assert stop < 300
    assert stop == next(r["iteration"] for r in dense if r["elbo"] >= x)
    for row, ref in zip(rows, dense):
        assert row["elbo"] == ref["elbo"] and row["iteration"] == ref["iteration"]
    _, _, ref_state = avt.optimize(0, make(), stop, target, q0)
    assert torch.equal(st.q.location, ref_state.q.location)
    assert torch.equal(st.q.scale if kind == "ngd" else st.q.scale_diag,
                       ref_state.q.scale if kind == "ngd" else ref_state.q.scale_diag)


@pytest.mark.parametrize("kind", KINDS)
def test_termination_thinned_mode_exact_iteration(kind):
    """With log_every > 1 the last row carries the terminating iteration;
    the earlier rows sit on the grid."""
    make, target, q0, x = _setup(kind)
    alg = avt.WithTermination(make(), avt.elbo_at_least(x))
    _, dense, st_d = avt.optimize(0, alg, 2000, target, q0)
    _, thin, st_t = avt.optimize(0, alg, 2000, target, q0, log_every=5, chunk_size=10)
    stop = dense[-1]["iteration"]
    assert thin[-1]["iteration"] == stop == st_t.iteration == st_d.iteration
    assert thin[-1]["elbo"] == dense[-1]["elbo"]
    assert stop % 5 != 0 and len(thin) == stop // 5 + 1
    assert all(r["iteration"] % 5 == 0 for r in thin[:-1])


@pytest.mark.parametrize("kind", KINDS)
def test_termination_callback_mode(kind):
    """Callback mode stops on the algorithm's terminate too."""
    make, target, q0, x = _setup(kind)
    alg = avt.WithTermination(make(), avt.elbo_at_least(x))
    calls = []

    def cb(iteration, info):
        calls.append(iteration)
        return {}

    _, infos, state = avt.optimize(0, alg, 2000, target, q0, callback=cb)
    _, dense, _ = avt.optimize(0, alg, 2000, target, q0)
    assert len(calls) == state.iteration == dense[-1]["iteration"] < 2000
    assert infos[-1]["iteration"] == state.iteration


@pytest.mark.parametrize("kind", KINDS)
def test_divergence_wins_over_simultaneous_terminate(kind):
    """A criterion that fires on the divergence itself must not mask the
    raise (chunk and callback modes)."""
    make, target, q0, _ = _setup(kind)
    alg = avt.WithTermination(make(), lambda state, info: info["diverged"])
    if kind == "advi":
        alg.algorithm.optimizer = avt.descent(1e8)
    else:
        alg.algorithm.stepsize, alg.algorithm.ensure_posdef = 5.0, False
    with pytest.raises(avt.DivergenceError):
        avt.optimize(0, alg, 500, target, q0)
    with pytest.raises(avt.DivergenceError):
        avt.optimize(0, alg, 500, target, q0, callback=lambda **kw: None)
    # without the check the terminate stops the run at the first NaN step
    _, rows, st = avt.optimize(0, alg, 500, target, q0, check_divergence=False)
    assert rows[-1]["diverged"] and rows[-1]["terminate"] and st.iteration < 500


@dataclasses.dataclass(frozen=True)
class _State:
    x: torch.Tensor
    iteration: int


class _NaNAtStep:
    """A minimal algorithm whose objective turns NaN at a fixed step, with
    an extra scalar info entry of its own."""

    def __init__(self, nan_at: int):
        self.nan_at = nan_at

    def init(self, seed, q_init, prob):
        return _State(x=torch.eye(8), iteration=0)

    def step(self, state, **kwargs):
        it = state.iteration + 1
        elbo = torch.tensor(float("nan") if it >= self.nan_at else -1.0 / it)
        info = {"elbo": elbo, "diverged": ~torch.isfinite(elbo),
                "extra": torch.tensor(it, dtype=torch.int64), "wide": torch.ones(3)}
        return _State(x=state.x @ state.x * 1e-3 + torch.eye(8), iteration=it), info

    def output(self, state):
        return state.x


def test_step3_nan_raises_at_3_in_default_mode():
    """tests/test_termination.py:164: a NaN at step 3 of a long single-chunk
    run raises naming iteration 3."""
    with pytest.raises(avt.DivergenceError, match="iteration 3\\."):
        avt.optimize(0, _NaNAtStep(3), 10_000, None, None)
    with pytest.raises(avt.DivergenceError, match="iteration 3\\."):
        avt.optimize(0, _NaNAtStep(3), 10_000, None, None, chunk_size=2)


def test_rows_carry_every_scalar_tensor_entry():
    """The chunk rows carry each 0-dim tensor entry of the step's info, as
    its Python type and value; a wider tensor is not a row entry."""
    _, rows, _ = avt.optimize(0, _NaNAtStep(10**9), 5, None, None, chunk_size=2)
    assert [r["extra"] for r in rows] == [1, 2, 3, 4, 5]
    assert all(type(r["extra"]) is int and type(r["diverged"]) is bool for r in rows)
    assert [r["elbo"] for r in rows] == [float(torch.tensor(-1.0 / k)) for k in range(1, 6)]
    assert all("wide" not in r for r in rows)


def test_bam_rows_carry_the_fisher_divergence_as_jax():
    """BaM's rows carry covweighted_fisher in chunk and callback modes, as
    the JAX package's rows do, and the values are the steps' own."""
    d = 5
    jt, mu, L = jax_normal_fullrank(jax.random.key(3), d)
    _, jrows, _ = javt.optimize(jax.random.key(0), javt.FisherMinBatchMatch(n_samples=8), 3,
                                jt, javt.FullRankGaussian(jnp.zeros(d)))
    from advancedvi_jl_tpu_torch import convert

    tt = convert.normal_target_from_numpy(jt.mu, jt.scale_tril, device=CPU)
    alg = avt.FisherMinBatchMatch(n_samples=8)
    q0 = avt.FullRankGaussian(torch.zeros(d))
    _, rows, _ = avt.optimize(0, alg, 3, tt, q0)
    _, cb_rows, _ = avt.optimize(0, alg, 3, tt, q0, callback=lambda **kw: None)
    assert set(jrows[-1]) == set(rows[-1]) == set(cb_rows[-1])
    state = alg.init(0, q0, tt)
    for row, cb_row in zip(rows, cb_rows):
        state, info = alg.step(state)
        assert row["covweighted_fisher"] == cb_row["covweighted_fisher"] == float(
            info["covweighted_fisher"])
    assert np.isfinite(rows[-1]["covweighted_fisher"])
