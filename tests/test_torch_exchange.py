"""The port's SMC² exchange step (Chopin's N-doubling) and
``run_segmented`` against the JAX package's contract: the invariants of
its exchange tests (``tests/test_samplers.py``) at the same configurations
on the LG model, in both padding policies; the posterior against the exact
prior-IS oracle; grow mode that never fires is bitwise the run without the
exchange step; ``run_segmented`` is bitwise the ``step`` + ``maybe_exchange``
loop, and a run split at a ``max_steps`` bound with a doubling pending
resumes to the whole run; the launch schedule; and a JAX state carried
across by ``interop`` with its live count and pending flag."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sequential_monte_carlo_tpu as jsmc
import sequential_monte_carlo_tpu_torch as tsmc
from sequential_monte_carlo_tpu_torch import interop
from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

# One intra-op thread, as in the other port test files (ROADMAP Queue 3).
torch.set_num_threads(1)

LG_PRIOR = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
            ("lognormal", 0.0, 1.0)]
# JAX's exchange tests' configuration (tests/test_samplers.py:180-265)
EXCHANGE = tsmc.SMCConfig(n_particles=64, n_theta=64, chain=2, ess_threshold=0.5,
                          acc_threshold=1.1, exchange_max_n=128)
FIELDS = ("theta", "log_omega", "particles", "log_w", "log_z", "ess", "acc_ratio")


@pytest.fixture(scope="module")
def lg_setup():
    """The JAX tests' series: simulate(key(1998), lg_model(0.5, 0.9, 0.8), 100)."""
    _, y = jsmc.simulate(jax.random.key(1998), jsmc.lg_model(jnp.array([0.5, 0.9, 0.8])), 100)
    return prior_from_spec(LG_PRIOR, device="cpu"), torch.from_numpy(np.array(y, np.float32))


@pytest.fixture(scope="module")
def oracle_mean(lg_setup):
    """The exact posterior mean: prior importance sampling (100,000 θ)
    weighted by the port's Kalman likelihood."""
    prior, y = lg_setup
    theta = prior.sample(torch.Generator().manual_seed(77), (100_000,))
    _, lz = tsmc.kalman_log_likelihood(tsmc.lg_model(theta), y)
    return (torch.softmax(lz.double(), 0) @ theta.double()).numpy()


def _equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS) and (
        (a.t, a.active_n, a.exchange_pending) == (b.t, b.active_n, b.exchange_pending))


def test_exchange_doubles_n_full_padding(lg_setup):
    """elastic_pad="full": arrays padded once to the doubling cap (256),
    the live count doubles inside the step, the dead tail stays at exactly
    −inf and the live slots finite (JAX's test_exchange_doubles_n)."""
    prior, y = lg_setup
    sampler = tsmc.SMC2(tsmc.lg_model, prior, EXCHANGE._replace(elastic_pad="full"))
    gen = torch.Generator().manual_seed(11)
    state = sampler.init(gen, y)
    assert state.particles.shape[1] == 256 and state.active_n == 64
    sizes = {64}
    for _ in range(1, 30):
        state, _ = sampler.step(gen, state, y)
        sizes.add(state.active_n)
        assert state.particles.shape[1] == 256
    assert 128 in sizes and max(sizes) <= 256
    lw = state.log_w
    assert torch.all(lw[:, state.active_n:] == -torch.inf)
    assert torch.all(torch.isfinite(lw[:, :state.active_n]))


def test_exchange_grow_mode_step_driven(lg_setup):
    """elastic_pad="grow": no padding at init; a fired exchange raises
    exchange_pending, which maybe_exchange services at 2N; the live count
    is the array size at every step, and no slot is dead (JAX's
    test_exchange_grow_mode_step_driven)."""
    prior, y = lg_setup
    sampler = tsmc.SMC2(tsmc.lg_model, prior, EXCHANGE)
    gen = torch.Generator().manual_seed(11)
    state = sampler.init(gen, y)
    assert state.particles.shape[1] == 64 and state.active_n == 64
    sizes = {64}
    for _ in range(1, 30):
        state, info = sampler.step(gen, state, y)
        state = sampler.maybe_exchange(gen, state, y, info)
        assert state.active_n == state.particles.shape[1] and not state.exchange_pending
        sizes.add(state.active_n)
    assert 128 in sizes and max(sizes) <= 256
    assert torch.all(torch.isfinite(state.log_w))


@pytest.mark.parametrize("pad", ["grow", "full"])
def test_exchange_posterior_matches_oracle(lg_setup, oracle_mean, pad):
    """A whole run with the exchange step armed (it fires after every
    rejuvenation while N ≤ 128) in either padding policy: N reaches 256, and
    the posterior mean is within the JAX tests' 0.3 of the exact oracle."""
    prior, y = lg_setup
    sampler = tsmc.SMC2(tsmc.lg_model, prior, EXCHANGE._replace(elastic_pad=pad))
    state, infos = sampler.run(torch.Generator().manual_seed(11), y)
    assert state.active_n == 256 and state.t == y.shape[0]
    assert infos.ess.shape == (y.shape[0] - 1,)
    assert np.isfinite(state.ess.item()) and torch.all(torch.isfinite(infos.log_evidence_incr))
    got = tsmc.expected_parameters(state).numpy()
    assert np.all(np.abs(got - oracle_mean) < 0.3), (got, oracle_mean)


def test_exchange_grow_mode_no_fire_is_free(lg_setup):
    """Armed but never fired (acc_threshold 1e-6), grow mode is bitwise the
    run without the exchange step: a step that fires no exchange draws
    nothing more (JAX's test_exchange_grow_mode_no_fire_is_free)."""
    prior, y = lg_setup
    base = EXCHANGE._replace(acc_threshold=-1.0)
    s_base, i_base = tsmc.SMC2(tsmc.lg_model, prior, base).run_segmented(
        torch.Generator().manual_seed(3), y, segment_size=16)
    s_el, i_el = tsmc.SMC2(tsmc.lg_model, prior, base._replace(acc_threshold=1e-6)).run_segmented(
        torch.Generator().manual_seed(3), y, segment_size=16)
    assert not s_el.exchange_pending and bool(i_el.rejuvenated.any())
    assert _equal(s_el, s_base)
    assert all(torch.equal(a, b) for a, b in zip(i_el, i_base))


def _step_loop(sampler, gen, y, collect_fn=None):
    """init + step + maybe_exchange over the series; the steps after which
    a doubling was pending, and the collected series."""
    state = sampler.init(gen, y)
    pending, infos, series = [], [], []
    for _ in range(1, y.shape[0]):
        state, info = sampler.step(gen, state, y)
        infos.append(info)
        if collect_fn is not None:
            series.append(collect_fn(state))
        if state.exchange_pending:
            pending.append(state.t)
        state = sampler.maybe_exchange(gen, state, y, info)
    return state, infos, pending, series


def test_run_segmented_equals_step_loop_and_resumes(lg_setup):
    """Grow mode: ``run_segmented`` (and ``run``, which delegates to it) is
    bitwise the step + maybe_exchange loop, collect_fn series included
    (collected before the doubling's service, as in JAX). Split at a
    ``max_steps`` bound right after a step that raised a doubling, the
    returned state keeps it pending at the old N, and resuming with that
    state and the same generator gives the whole run and the rest of its
    infos; a resume past the end returns zero-length infos and the state as
    it was."""
    prior, y = lg_setup
    sampler = tsmc.SMC2(tsmc.lg_model, prior, EXCHANGE)
    collect = lambda st: (st.log_z.mean(), st.ess)  # noqa: E731
    loop, infos, pending, series = _step_loop(sampler, torch.Generator().manual_seed(5), y,
                                              collect)
    assert len(pending) >= 2
    seg, (seg_infos, seg_series) = sampler.run_segmented(torch.Generator().manual_seed(5), y,
                                                         segment_size=16, collect_fn=collect)
    assert _equal(seg, loop)
    assert all(torch.equal(a, torch.stack(b)) for a, b in zip(seg_infos, zip(*infos)))
    assert seg_series[0].shape == (y.shape[0] - 1,)
    assert all(torch.equal(a, torch.stack(b)) for a, b in zip(seg_series, zip(*series)))
    run, _ = sampler.run(torch.Generator().manual_seed(5), y)
    assert _equal(run, loop)

    gen = torch.Generator().manual_seed(5)
    bound = pending[0] - 1  # steps from t = 1 to the step that raised the doubling
    mid, first = sampler.run_segmented(gen, y, max_steps=bound)
    assert mid.t == pending[0] and mid.exchange_pending
    assert mid.particles.shape[1] == mid.active_n == 64
    assert first.ess.shape == (bound,)
    end, rest = sampler.run_segmented(gen, y, state=mid)
    assert _equal(end, loop)
    both = [torch.cat(pair) for pair in zip(first, rest)]
    assert all(torch.equal(a, b) for a, b in zip(both, seg_infos))
    again, none = sampler.run_segmented(gen, y, state=end, max_steps=5)
    assert _equal(again, end)
    assert all(f.shape == (0,) for f in none)
    _, (none, none_series) = sampler.run_segmented(gen, y, state=end, collect_fn=collect)
    assert none.ess.shape == (0,) and none_series[0].shape == (0,)


@pytest.mark.parametrize("pad", ["grow", "full"])
def test_exchange_step_schedule(lg_setup, monkeypatch, pad):
    """The inner-step schedule: one step a propagate launch, T − 1 online
    steps, chain·(t − 1) for a rejuvenation at t, and per doubling a
    refilter of the consumed history — t − 1 steps at the doubled N (grow,
    serviced after the step that raised it, over t observations) or at the
    padded shape (full, inside the step at t, over t − 1)."""
    prior, y = lg_setup
    sampler = tsmc.SMC2(tsmc.lg_model, prior, EXCHANGE._replace(elastic_pad=pad))
    models_t = type(tsmc.lg_model(torch.zeros(1, 3)))
    orig = models_t.fused_propagate_reweight
    calls = []
    monkeypatch.setattr(models_t, "fused_propagate_reweight",
                        lambda self, *a, **kw: (calls.append(kw.get("normalize", True)),
                                                orig(self, *a, **kw))[1])
    gen = torch.Generator().manual_seed(7)
    state = sampler.init(gen, y)
    expected, doublings = 0, 0
    for _ in range(1, y.shape[0]):
        t0, n0 = state.t, state.active_n
        state, info = sampler.step(gen, state, y)
        expected += 1 + (sampler.config.chain * (t0 - 1) if bool(info.rejuvenated) else 0)
        if pad == "full" and state.active_n != n0:
            expected += t0 - 1
            doublings += 1
        if state.exchange_pending:
            expected += state.t - 1
            doublings += 1
        state = sampler.maybe_exchange(gen, state, y, info)
    assert doublings == 2 and state.active_n == 256
    assert len(calls) == expected
    # full padding runs every step on the route without the normalize
    assert set(calls) == ({False} if pad == "full" else {True})


def test_interop_carries_the_elastic_fields(lg_setup):
    """A JAX SMC² state carried across keeps its live count and pending
    flag: a full-padding init (N padded to 256, 64 live) steps on in the
    port with its dead tail at −inf; the same fields with a doubling
    pending are serviced by the port's maybe_exchange at 2N."""
    prior, y = lg_setup
    cfg_j = jsmc.SMCConfig(n_particles=64, n_theta=64, chain=2, ess_threshold=0.5,
                           acc_threshold=1.1, exchange_max_n=128, elastic_pad="full")
    f = jsmc.product_distribution([
        jsmc.TruncatedNormal(*(jnp.float32(v) for v in (0.0, 1.0, -1.0, 1.0))),
        jsmc.LogNormal(jnp.float32(0.0), jnp.float32(1.0)),
        jsmc.LogNormal(jnp.float32(0.0), jnp.float32(1.0))])
    st_j = jsmc.SMC2(jsmc.lg_model, f, cfg_j).init(jax.random.key(1), jnp.asarray(y.numpy()))
    fields = {k: np.asarray(getattr(st_j, k)) for k in FIELDS + ("t", "active_n",
                                                                 "exchange_pending")}
    state = interop.from_numpy_state(fields, device="cpu")
    assert (state.active_n, state.exchange_pending, state.particles.shape) == (64, False,
                                                                               (64, 256, 1))
    full = tsmc.SMC2(tsmc.lg_model, prior, EXCHANGE._replace(elastic_pad="full"))
    gen = torch.Generator().manual_seed(2)
    for _ in range(5):
        state, _ = full.step(gen, state, y)
    assert torch.all(state.log_w[:, state.active_n:] == -torch.inf)

    grow_fields = dict(fields, particles=fields["particles"][:, :64],
                       log_w=fields["log_w"][:, :64], exchange_pending=np.asarray(True))
    state = interop.from_numpy_state(grow_fields, device="cpu")
    assert state.exchange_pending and state.active_n == 64
    grow = tsmc.SMC2(tsmc.lg_model, prior, EXCHANGE)
    state = grow.maybe_exchange(gen, state, y)
    assert state.particles.shape == (64, 128, 1) and state.active_n == 128
    assert not state.exchange_pending and torch.all(torch.isfinite(state.log_w))
    legacy = {k: v for k, v in fields.items() if k not in ("active_n", "exchange_pending")}
    assert interop.from_numpy_state(legacy, device="cpu").active_n == 256
