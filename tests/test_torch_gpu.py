"""The port's CUDA and Triton kernels against their plain PyTorch versions,
on a GPU (``gpu`` marker; they skip where there is no CUDA device).

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from sequential_monte_carlo_tpu_torch.kernels.propagate import (
    fused_elementwise_step,
    fused_elementwise_step_plain,
    normalize_rows,
)
from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
    resample_gather_sorted,
    resample_gather_sorted_plain,
    stratified_uniforms,
    systematic_uniforms,
)
from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
    resample_gather,
    resample_gather_plain,
)
from sequential_monte_carlo_tpu_torch.kernels.ucsv import (
    ucsv_propagate_reweight,
    ucsv_propagate_reweight_plain,
)
from sequential_monte_carlo_tpu_torch.models.linear_gaussian import LG_UPDATES
from sequential_monte_carlo_tpu_torch.models.stochastic_volatility import SV_UPDATE
from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192])
@pytest.mark.parametrize("c", [2, 3, 4])
def test_resample_kernel_matches_plain(cuda, n, c):
    """Kernel 1: ancestors equal to the plain version's (both sum in f64),
    output ≡ xs gathered by them, one launch counted."""
    rng = np.random.default_rng(7)
    a = 2.0 * rng.standard_normal((64, n))
    w = np.exp(a - a.max(-1, keepdims=True))
    w = torch.tensor(w / w.sum(-1, keepdims=True), dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((64, c, n)), dtype=torch.float32, device=cuda)
    u0 = torch.tensor(rng.random((64, 1)), dtype=torch.float32, device=cuda)
    before = resample_gather.launches
    out, anc = resample_gather(u0, w, xs, return_ancestors=True)
    assert resample_gather.launches == before + 1
    ref, anc_ref = resample_gather_plain(u0, w, xs)
    assert torch.equal(anc, anc_ref)
    assert torch.equal(out, torch.gather(xs, 2, anc.long()[:, None, :].expand(xs.shape)))


@pytest.mark.parametrize("n", [1, 1000, 8191])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("weights", ["skewed", "first", "last"])
def test_resample_kernel_edge_shapes(cuda, n, c, weights):
    """Kernel 1 on shapes its warp chunks and 16-byte accesses must take
    (N=1, N not a multiple of 4, one particle short of 8192, C=1) and on a
    point mass at slot 0 and at slot N−1, whose one run covers every slot:
    no ancestor differs from the plain version's; output ≡ xs gathered."""
    rng = np.random.default_rng(15)
    m = 64
    if weights == "skewed":
        a = 2.0 * rng.standard_normal((m, n))
        w = np.exp(a - a.max(-1, keepdims=True))
    else:
        w = np.zeros((m, n))
        w[:, 0 if weights == "first" else -1] = 1.0
    w = torch.tensor(w, dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((m, c, n)), dtype=torch.float32, device=cuda)
    u0 = torch.tensor(rng.random((m, 1)), dtype=torch.float32, device=cuda)
    u0[0] = 0.0
    out, anc = resample_gather(u0, w, xs, return_ancestors=True)
    ref, anc_ref = resample_gather_plain(u0, w, xs)
    assert torch.equal(anc, anc_ref)
    assert torch.equal(out, torch.gather(xs, 2, anc.long()[:, None, :].expand(xs.shape)))
    if weights != "skewed":
        assert bool(torch.all(anc == (0 if weights == "first" else n - 1)))


def test_resample_kernel_refuses_rows_beyond_its_limit(cuda):
    """The kernel keeps a row's marks in shared memory up to its N limit;
    one past it, the large route (marks in the ancestors' buffer) takes the
    row, with or without the ancestors returned, and gives the plain
    version's ancestors."""
    from sequential_monte_carlo_tpu_torch.kernels import _build

    n = _build.library().smc_resample_count_max_n() + 1
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.random((2, n)), dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((2, 1, n)), dtype=torch.float32, device=cuda)
    u0 = torch.tensor([[0.25], [0.75]], device=cuda)
    out, anc = resample_gather(u0, w, xs, return_ancestors=True)
    ref, anc_ref = resample_gather_plain(u0, w, xs)
    assert torch.equal(anc, anc_ref) and torch.equal(out, ref)
    assert torch.equal(resample_gather(u0, w, xs), ref)


@pytest.mark.parametrize("kernel", ["count", "sorted"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("weights", ["flat", "skewed", "point"])
def test_resample_kernels_take_large_n(cuda, kernel, c, weights):
    """K1 and K3 at M=64, N=65,536, past their shared-memory caps (the
    reference ran SMC² at this N): ancestors equal to the plain versions'
    bit for bit under flat, skewed and point-mass weights, output ≡ xs
    gathered by them."""
    rng = np.random.default_rng(17)
    m, n = 64, 65536
    if weights == "flat":
        w = np.ones((m, n))
    elif weights == "skewed":
        a = 2.0 * rng.standard_normal((m, n))
        w = np.exp(a - a.max(-1, keepdims=True))
    else:
        w = np.zeros((m, n))
        w[np.arange(m), rng.integers(0, n, m)] = 1.0
    w = torch.tensor(w, dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((m, c, n)), dtype=torch.float32, device=cuda)
    if kernel == "count":
        u0 = torch.tensor(rng.random((m, 1)), dtype=torch.float32, device=cuda)
        out, anc = resample_gather(u0, w, xs, return_ancestors=True)
        _, anc_ref = resample_gather_plain(u0, w, xs)
    else:
        u = stratified_uniforms(torch.Generator(device=cuda).manual_seed(5), m, n)
        out, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
        _, anc_ref = resample_gather_sorted_plain(u, w, xs)
    assert torch.equal(anc, anc_ref)
    assert torch.equal(out, torch.gather(xs, 2, anc.long()[:, None, :].expand(xs.shape)))


@pytest.mark.parametrize("active_n", [1, 1024, 4096, 8191, 8192])
@pytest.mark.parametrize("scheme", ["systematic", "stratified"])
def test_sorted_resample_kernel_on_the_elastic_grid(cuda, active_n, scheme):
    """K3 on the elastic filter's live-prefix grid (u_i = (i + offset) /
    active_n, clamped at 1 − 1e-7, so a dead tail of equal u) with weights 0
    past active_n: ancestors equal to the plain version's and all below
    active_n."""
    from sequential_monte_carlo_tpu_torch.ops.batched_filter import _elastic_sorted_u

    rng = np.random.default_rng(23)
    m, n = 64, 8192
    a = 2.0 * rng.standard_normal((m, n))
    w = np.exp(a - a.max(-1, keepdims=True))
    w[:, active_n:] = 0.0
    w = torch.tensor(w, dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((m, 3, n)), dtype=torch.float32, device=cuda)
    off = torch.tensor(rng.random((m, 1) if scheme == "systematic" else (m, n)),
                       dtype=torch.float32, device=cuda)
    u = _elastic_sorted_u(off, n, active_n)
    out, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
    _, anc_ref = resample_gather_sorted_plain(u, w, xs)
    assert torch.equal(anc, anc_ref)
    assert int(anc.max()) < active_n
    assert torch.equal(out, torch.gather(xs, 2, anc.long()[:, None, :].expand(xs.shape)))


def _enough_draws(z):
    """The moment checks need ≥ 5·10⁵ draws a normal (small N has fewer)."""
    return z[0].numel() >= 500_000


@pytest.mark.parametrize("n", [1, 1000, 1024, 2048, 3000, 4096, 8192])
def test_fused_step_kernel_matches_plain(cuda, n):
    """Kernel 2: the plain version, fed the normals recovered from the
    kernel's state deltas, gives the kernel's outputs to rtol 1e-5 (exp and
    log in another library); the draws do not depend on the row's
    neighbours (row_offset shifts them by rows)."""
    rng = np.random.default_rng(8)
    scale = np.array([1.0, 0.5, 0.5])[None, :, None]
    state = torch.tensor(rng.standard_normal((64, 3, n)) * scale, dtype=torch.float32,
                         device=cuda)
    params = torch.tensor(rng.uniform(0.05, 0.5, (64, 2)), dtype=torch.float32, device=cuda)
    y = torch.tensor(1.3, device=cuda)
    seed = torch.tensor([12345], device=cuda)
    new, log_norm, lse, ess = fused_elementwise_step(UCSV_UPDATE, params, state, y, seed=seed)
    z = _recover_normals("ucsv", params, state, new)
    ref = fused_elementwise_step_plain(UCSV_UPDATE, params, state, y, z)
    for a, b in zip((new, log_norm, lse, ess), ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # rows 32.. of the full call are rows 0.. of a call on them at offset 32
    half = fused_elementwise_step(UCSV_UPDATE, params[32:].contiguous(),
                                  state[32:].contiguous(), y, seed=seed, row_offset=32)
    assert torch.equal(half[0], new[32:])


@pytest.mark.parametrize("m, n", [(64, 65536), (1, 65536), (3, 40000)])
@pytest.mark.parametrize("carry", [False, True])
def test_fused_step_split_route(cuda, m, n, carry):
    """Kernel 2's split route (normalized rows of more than 16,384 over
    programs of 4096, one launch, each row finished by its last program),
    LG dx=1 with distinct θ a row: the new cloud bit for bit the route
    without the normalize at the same seed (the same Philox stream), and
    log_norm, lse and ess within 1e-5 of the plain normalize of its
    log-weights (plus the carry); rows 0..M/2 − 1 bit for bit an M/2-row
    call; a CUDA graph of the call replayed twice bit for bit the eager
    call; one ``_split`` launch counted a call."""
    rng = np.random.default_rng(22)
    update, p = _instance("lg1", rng, m)
    params = torch.tensor(p, dtype=torch.float32, device=cuda)
    state = torch.tensor(rng.standard_normal((m, 1, n)), dtype=torch.float32, device=cuda)
    y, seed = torch.tensor(0.6, device=cuda), torch.tensor([8642], device=cuda)
    c = None
    if carry:
        a = 3.0 * rng.standard_normal((m, n))
        c = torch.tensor(a - np.log(np.exp(a).sum(1, keepdims=True)), dtype=torch.float32,
                         device=cuda)
    key = "lg1" + ("_carry" if carry else "") + "_split"

    def step(rows=m, out=None):
        return fused_elementwise_step(update, params[:rows], state[:rows], y, seed=seed,
                                      carry_logw=None if c is None else c[:rows], out=out)

    before = fused_elementwise_step.instance_launches[key]
    got = step()
    assert fused_elementwise_step.instance_launches[key] == before + 1
    new, logw = fused_elementwise_step(update, params, state, y, seed=seed, normalize=False)
    assert torch.equal(got[0], new)
    for a, b in zip(got[1:], normalize_rows(logw if c is None else logw + c)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if m > 1:
        assert all(torch.equal(a, b[:m // 2]) for a, b in zip(step(m // 2), got))
    out = (torch.empty_like(state), torch.empty((m, n), device=cuda))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(out=out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = step(out=out)
    for _ in range(2):
        for t in replayed:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(replayed, got))


@pytest.mark.parametrize("n", [1000, 1024, 8192])
@pytest.mark.parametrize("weights", ["skewed", "point"])
def test_sorted_resample_kernel_matches_plain(cuda, n, weights):
    """Sorted-grid kernel on stratified grids (N=1000 is a shape the TPU
    walk cannot tile): ancestors equal to the plain version's on all but
    < 1e-3 of slots (both sum in f64), output ≡ xs gathered by them, within
    [0, N), one launch counted."""
    rng = np.random.default_rng(9)
    m = 64
    if weights == "point":
        w = np.zeros((m, n))
        w[np.arange(m), rng.integers(0, n, m)] = 1.0
    else:
        a = 2.0 * rng.standard_normal((m, n))
        w = np.exp(a - a.max(-1, keepdims=True))
    w = torch.tensor(w, dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((m, 3, n)), dtype=torch.float32, device=cuda)
    u = ((torch.arange(n, device=cuda) + torch.tensor(rng.random((m, n)), device=cuda)) / n).float()
    before = resample_gather_sorted.launches
    out, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
    assert resample_gather_sorted.launches == before + 1
    ref, anc_ref = resample_gather_sorted_plain(u, w, xs)
    assert (anc != anc_ref).float().mean().item() < 1e-3
    assert bool(torch.all((anc >= 0) & (anc < n)))
    assert torch.equal(out, torch.gather(xs, 2, anc.long()[:, None, :].expand(xs.shape)))


def _sorted_grid(kind, rng, w):
    """A sorted grid for the weights w (M, N) on the card: ``stratified``
    (u_i = (i + v_i)/N) with an exact 0 in every other row, or ``ties``:
    entries of the rows' cdf as the plain version rounds it, drawn with
    repeats (runs of equal values), and an exact 0 in every row."""
    m, n = w.shape
    if kind == "stratified":
        u = torch.tensor((np.arange(n) + rng.random((m, n))) / n, dtype=torch.float32,
                         device=w.device)
        u[::2, 0] = 0.0
        return u
    cum = torch.cumsum(w, dim=-1, dtype=torch.float64)
    cdf = (cum / cum[..., -1:]).to(torch.float32)
    cdf[..., -1] = 1.0 + 1e-6
    idx = torch.tensor(np.sort(rng.integers(0, n, (m, n)), axis=1), device=w.device)
    u = torch.gather(cdf, 1, idx)
    u[:, 0] = 0.0
    return u


@pytest.mark.parametrize("n", [1, 1000, 8191])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("weights", ["skewed", "first", "last"])
@pytest.mark.parametrize("grid", ["stratified", "ties"])
def test_sorted_resample_kernel_edge_shapes(cuda, n, c, weights, grid):
    """Sorted-grid kernel on shapes its warp chunks and 16-byte accesses must
    take (N=1, N not a multiple of 4, one particle short of 8192, C=1 and 4),
    point masses at slot 0 and at slot N−1, and grids with exact zeros, values
    equal to cdf entries and runs of equal values: no ancestor differs from
    the plain version's where the cdf is exact (point masses, ties), fewer
    than 1e-3 elsewhere; a grid value 0 takes ancestor 0; output ≡ xs
    gathered by the ancestors, which are sorted and within [0, N)."""
    rng = np.random.default_rng(16)
    m = 64
    if weights == "skewed":
        a = 2.0 * rng.standard_normal((m, n))
        w = np.exp(a - a.max(-1, keepdims=True))
    else:
        w = np.zeros((m, n))
        w[:, 0 if weights == "first" else -1] = 1.0
    w = torch.tensor(w, dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((m, c, n)), dtype=torch.float32, device=cuda)
    u = _sorted_grid(grid, rng, w)
    out, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
    ref, anc_ref = resample_gather_sorted_plain(u, w, xs)
    mismatch = (anc != anc_ref).float().mean().item()
    if weights != "skewed" or grid == "ties":
        assert mismatch == 0.0
    else:
        assert mismatch < 1e-3
    assert bool(torch.all(anc[u == 0.0] == 0))
    assert bool(torch.all((anc >= 0) & (anc < n))) and bool(torch.all(anc[:, 1:] >= anc[:, :-1]))
    assert torch.equal(out, torch.gather(xs, 2, anc.long()[:, None, :].expand(xs.shape)))


def test_sorted_resample_kernel_refuses_rows_beyond_its_limit(cuda):
    """The sorted-grid kernel keeps a row's cdf in shared memory up to its N
    limit; one past it (an odd N, so no 16-byte accesses), the large route
    (the cdf in an (M, N) scratch) takes the row, counts one launch and
    gives the plain version's ancestors."""
    from sequential_monte_carlo_tpu_torch.kernels import _build

    n = _build.library().smc_resample_sorted_max_n() + 1
    rng = np.random.default_rng(4)
    w = torch.tensor(rng.random((2, n)), dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((2, 2, n)), dtype=torch.float32, device=cuda)
    u = stratified_uniforms(torch.Generator(device=cuda).manual_seed(2), 2, n)
    before = resample_gather_sorted.launches
    out, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
    assert resample_gather_sorted.launches == before + 1
    ref, anc_ref = resample_gather_sorted_plain(u, w, xs)
    assert torch.equal(anc, anc_ref) and torch.equal(out, ref)


def _instance(name, rng, m):
    """(update, (M, P) params, state scale) of a kernel-2 instance, with a
    non-singular F for LG so that the normals can be recovered."""
    if name == "sv":
        p = np.stack([rng.normal(-1, 0.3, m), rng.uniform(0.5, 0.95, m),
                      rng.uniform(0.1, 0.5, m)], 1)
        return SV_UPDATE, p
    dx = int(name[-1])
    a = rng.uniform(-0.9, 0.9, (m, dx, dx))
    f = np.tril(rng.uniform(0.3, 1.0, (m, dx, dx)))
    p = np.concatenate([a.reshape(m, -1), f.reshape(m, -1), rng.uniform(0.5, 1.5, (m, dx)),
                        rng.uniform(0.3, 1.0, (m, 1))], 1)
    return LG_UPDATES[dx], p


def _assert_standard_normals(z):
    """The recovered normals (K, M, N), over ≥ 5·10⁵ draws each, look
    standard and independent: |mean| < 5e-3, |var − 1| < 1e-2, |corr| <
    5e-3 (about 3.5, 5 and 3.5 standard errors). An update that scales or
    mixes the draws wrongly (Fᵀ in place of F, σ² in place of σ) fails."""
    flat = z.reshape(z.shape[0], -1).double()
    assert flat.shape[1] >= 500_000
    assert flat.mean(1).abs().max().item() < 5e-3
    assert (flat.var(1) - 1.0).abs().max().item() < 1e-2
    if flat.shape[0] > 1:
        corr = torch.corrcoef(flat)
        assert (corr - torch.diag(torch.diag(corr))).abs().max().item() < 5e-3


def _recover_normals(name, params, state, new):
    """The normals the kernel drew, from the state deltas."""
    if name == "ucsv":
        return torch.stack([(new[:, 0] - state[:, 0]) / torch.exp(0.5 * state[:, 1]),
                            (new[:, 1] - state[:, 1]) / params[:, :1],
                            (new[:, 2] - state[:, 2]) / params[:, 1:]])
    if name == "sv":
        mu, phi, sig = (params[:, i:i + 1] for i in range(3))
        return ((new[:, 0] - mu - phi * (state[:, 0] - mu)) / sig)[None]
    dx = int(name[-1])
    m = params.shape[0]
    a = params[:, :dx * dx].reshape(m, dx, dx)
    f = params[:, dx * dx:2 * dx * dx].reshape(m, dx, dx)
    return torch.linalg.solve_triangular(f, new - a @ state, upper=False).transpose(0, 1)


@pytest.mark.parametrize("n", [1, 1000, 3000, 8192])
@pytest.mark.parametrize("name,carry", [("lg1", False), ("lg1", True), ("lg2", False),
                                        ("sv", False), ("sv", True)])
def test_fused_step_instances_match_plain(cuda, n, name, carry):
    """Kernel 2's LG (dx 1, 2) and SV instances, with and without the
    carried log-weights: the plain version, fed the normals recovered from
    the kernel's state deltas, gives the kernel's outputs to rtol 1e-5, and
    those normals have standard moments (the first check holds whatever the
    update does; the second shows it right)."""
    rng = np.random.default_rng(10)
    m = 512
    update, p = _instance(name, rng, m)
    params = torch.tensor(p, dtype=torch.float32, device=cuda)
    state = torch.tensor(rng.standard_normal((m, update.n_normals, n)), dtype=torch.float32,
                         device=cuda)
    carry_logw = None
    if carry:
        a = 3.0 * rng.standard_normal((m, n))
        carry_logw = torch.tensor(a - np.log(np.exp(a).sum(-1, keepdims=True)),
                                  dtype=torch.float32, device=cuda)
        carry_logw[1] = -60.0  # a row carrying very negative log-weights
    y = torch.tensor(0.6, device=cuda)
    seed = torch.tensor([4321], device=cuda)
    got = fused_elementwise_step(update, params, state, y, seed=seed, carry_logw=carry_logw)
    z = _recover_normals(name, params, state, got[0])
    ref = fused_elementwise_step_plain(update, params, state, y, z, carry_logw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert bool(torch.all(torch.isfinite(got[2])))
    if _enough_draws(z):
        _assert_standard_normals(z)


@pytest.mark.parametrize("n", [1000, 3000, 8192])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dx", [3, 4, 5])
def test_fused_step_lg_any_dx_matches_plain(cuda, n, normalize, dx):
    """Kernel 2's LG instances generated for dx ≥ 3 (dx = 5 draws its fifth
    normal at the second Philox counter), normalized and raw: the plain
    version, fed the normals recovered from the kernel's state deltas, gives
    the kernel's outputs to rtol 1e-5, and those normals have standard
    moments and are uncorrelated across the counters."""
    rng = np.random.default_rng(12)
    m = 512
    update, p = _instance(f"lg{dx}", rng, m)
    params = torch.tensor(p, dtype=torch.float32, device=cuda)
    state = torch.tensor(rng.standard_normal((m, dx, n)), dtype=torch.float32, device=cuda)
    y = torch.tensor(0.6, device=cuda)
    seed = torch.tensor([1357], device=cuda)
    key = f"lg{dx}" + ("" if normalize else "_raw")
    before = fused_elementwise_step.instance_launches[key]
    got = fused_elementwise_step(update, params, state, y, seed=seed, normalize=normalize)
    assert fused_elementwise_step.instance_launches[key] == before + 1
    z = _recover_normals(f"lg{dx}", params, state, got[0])
    ref = fused_elementwise_step_plain(update, params, state, y, z, normalize=normalize)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if _enough_draws(z):
        _assert_standard_normals(z)


@pytest.mark.parametrize("n", [1, 1000, 3000, 8192])
@pytest.mark.parametrize("name", ["ucsv", "lg1", "lg2", "sv"])
def test_fused_step_raw_route_matches_plain(cuda, n, name):
    """Kernel 2's route without the normalize (the auxiliary filter's
    second stage), per instance, on a strided view of a wider cloud: the
    plain version, fed the normals recovered from the kernel's state deltas,
    gives its planes and raw log-weights to rtol 1e-5, those normals have
    standard moments, and the launch is counted under the ``_raw`` key."""
    rng = np.random.default_rng(11)
    m = 512
    if name == "ucsv":
        update, p = UCSV_UPDATE, rng.uniform(0.05, 0.5, (m, 2))
    else:
        update, p = _instance(name, rng, m)
    params = torch.tensor(p, dtype=torch.float32, device=cuda)
    s = 3 if name == "ucsv" else update.n_normals
    wide = torch.tensor(0.5 * rng.standard_normal((m, s + 1, n)), dtype=torch.float32, device=cuda)
    state = wide[:, :s]
    y = torch.tensor(0.6, device=cuda)
    seed = torch.tensor([2468], device=cuda)
    before = fused_elementwise_step.instance_launches[update.triton + "_raw"]
    got = fused_elementwise_step(update, params, state, y, seed=seed, normalize=False)
    assert fused_elementwise_step.instance_launches[update.triton + "_raw"] == before + 1
    assert len(got) == 2
    z = _recover_normals(name, params, state, got[0])
    ref = fused_elementwise_step_plain(update, params, state, y, z, normalize=False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if _enough_draws(z):
        _assert_standard_normals(z)


def _ucsv_cloud(rng, m, n, cuda, layout="view"):
    """A (M, 3, N) UC-SV cloud, and γ: a strided view of a (M, 4, N) one
    (the auxiliary filter's split-off planes), or contiguous."""
    scale = np.array([1.0, 0.5, 0.5, 1.0])[None, :, None]
    wide = torch.tensor(rng.standard_normal((m, 4, n)) * scale, dtype=torch.float32, device=cuda)
    gam = torch.tensor(rng.uniform(0.05, 0.5, (m, 2)), dtype=torch.float32, device=cuda)
    return (wide[:, :3] if layout == "view" else wide[:, :3].contiguous()), gam


@pytest.mark.parametrize("n", [1, 1000, 1001, 1024, 3001, 8192])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("layout", ["view", "contiguous"])
def test_ucsv_kernel_matches_plain(cuda, n, normalize, layout):
    """The hand-written UC-SV kernel on a strided cloud view and on a
    contiguous cloud, at N that its 16-byte accesses take and that they do
    not (N=1, 1001, 3001; the (M, 4, 1001) view's plane stride): the plain
    version, fed the normals recovered from its state deltas, gives its
    outputs to rtol 1e-5; those normals have standard moments (where there
    are enough of them); the log-weights are the observation density at the
    returned state; a call on rows 256.. at row_offset 256 returns rows 256..
    of the full call, bitwise; one launch is counted."""
    rng = np.random.default_rng(12)
    m = 512
    cloud, gam = _ucsv_cloud(rng, m, n, cuda, layout)
    ge, gn = gam[:, 0], gam[:, 1]
    y = torch.tensor(1.3, device=cuda)
    seed = torch.tensor([97531], device=cuda)
    before = ucsv_propagate_reweight.launches
    got = ucsv_propagate_reweight(seed, y, ge, gn, cloud, normalize=normalize)
    assert ucsv_propagate_reweight.launches == before + 1
    new = got[0]
    z = _recover_normals("ucsv", gam, cloud, new)
    ref = ucsv_propagate_reweight_plain(y, ge, gn, cloud, z, normalize)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if _enough_draws(z):
        _assert_standard_normals(z)
    zz = (y - new[:, 0]) * torch.exp(-0.5 * new[:, 2])
    logw = -0.5 * zz * zz - 0.5 * new[:, 2] - 0.5 * np.log(2 * np.pi)
    torch.testing.assert_close(got[1] + got[2] if normalize else got[1], logw,
                               rtol=1e-5, atol=1e-5)
    half = ucsv_propagate_reweight(seed, y, ge[256:], gn[256:], cloud[256:], row_offset=256,
                                   normalize=normalize)
    for a, b in zip(half, got):
        assert torch.equal(a, b[256:])


def test_ucsv_kernel_zero_gamma_freezes_the_vols(cuda):
    rng = np.random.default_rng(13)
    cloud, _ = _ucsv_cloud(rng, 64, 1024, cuda)
    zero = torch.zeros(64, device=cuda)
    new, _ = ucsv_propagate_reweight(torch.tensor([5], device=cuda), torch.tensor(0.2, device=cuda),
                                     zero, zero, cloud)
    assert torch.equal(new[:, 1:], cloud[:, 1:])


@pytest.mark.parametrize("n", [1, 1001, 1024, 3001, 8192])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("layout", ["view", "contiguous"])
def test_ucsv_kernel_matches_kernel2_at_the_same_seed(cuda, n, normalize, layout):
    """The two UC-SV routes, written independently (CUDA C++ and Triton),
    draw the same normals at the same seed: every output is within rtol =
    atol = 1e-5 (the normalize sums in another order). Where N is a multiple
    of 16, Triton compiles the update as the CUDA kernel writes it out, and
    the new cloud and the raw log-weights are equal bit for bit."""
    rng = np.random.default_rng(14)
    m = 512
    cloud, gam = _ucsv_cloud(rng, m, n, cuda, layout)
    y = torch.tensor(1.1, device=cuda)
    seed = torch.tensor([(1 << 40) + 12345], device=cuda)  # both halves of the key in use
    k6 = ucsv_propagate_reweight(seed, y, gam[:, 0], gam[:, 1], cloud, normalize=normalize)
    k2 = fused_elementwise_step(UCSV_UPDATE, gam.contiguous(), cloud, y, seed=seed,
                                normalize=normalize)
    for a, b in zip(k6, k2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if n % 16 == 0:
        assert torch.equal(k6[0], k2[0])
        if not normalize:
            assert torch.equal(k6[1], k2[1])


@pytest.mark.parametrize("grid", [systematic_uniforms, stratified_uniforms])
def test_uniform_grids_draw_on_the_card(cuda, grid):
    """A CUDA generator draws its grid on the card when no device is given."""
    u = grid(torch.Generator(device=cuda).manual_seed(0), 8, 256)
    assert u.device.type == "cuda" and u.shape == (8, 256)


@pytest.mark.parametrize("pad", ["grow", "full"])
def test_exchange_doubling_on_the_card(cuda, pad):
    """SMC² on UC-SV (M=64, N=64) with the exchange step firing after every
    rejuvenation while N ≤ 128: on the card N doubles to 256 through the
    kernels of each padding policy — K1 + K2-UC-SV in "grow" mode, K3 on the
    live-prefix grid + K6 raw under "full" padding, whose dead tail stays at
    exactly −inf — and the run ends with finite weights."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    prior = prior_from_spec([("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
                             ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)], device=cuda)
    rng = np.random.default_rng(1998)
    y = torch.tensor(3.0 + np.cumsum(rng.normal(0, 0.3, 60)) + rng.normal(0, 0.5, 60),
                     dtype=torch.float32, device=cuda)
    cfg = smc.SMCConfig(n_particles=64, n_theta=64, chain=2, acc_threshold=1.1,
                        exchange_max_n=128, elastic_pad=pad)
    sampler = smc.SMC2(smc.ucsv_model, prior, cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = (resample_gather.launches, resample_gather_sorted.launches,
              ucsv_propagate_reweight.launches, fused_elementwise_step.instance_launches["ucsv"])
    state = sampler.init(gen, y)
    assert state.particles.shape[1] == (256 if pad == "full" else 64)
    sizes = {state.active_n}
    for _ in range(1, y.shape[0]):
        state, info = sampler.step(gen, state, y)
        state = sampler.maybe_exchange(gen, state, y, info)
        sizes.add(state.active_n)
    after = (resample_gather.launches, resample_gather_sorted.launches,
             ucsv_propagate_reweight.launches, fused_elementwise_step.instance_launches["ucsv"])
    used = [a > b for a, b in zip(after, before)]
    assert used == ([True, False, False, True] if pad == "grow" else [False, True, True, False])
    assert sizes == {64, 128, 256}
    lw = state.log_w
    assert torch.all(torch.isfinite(lw[:, :state.active_n]))
    assert torch.all(lw[:, state.active_n:] == -torch.inf)
    assert np.isfinite(state.ess.item())


def _as_row(t, layout):
    """``t`` as a one-row (1, *t.shape) tensor: contiguous, a row of a wider
    tensor seen through ``unsqueeze`` (an offset, stride(0) of the wider
    rows), through ``expand`` (stride(0) 0), or dense with stride 1 on every
    axis of length 1 (as the resample kernels return a one-row cloud)."""
    if layout == "contiguous":
        return t[None].clone()
    if layout == "unsqueeze":
        wide = t.new_zeros((3,) + tuple(t.shape))
        wide[1] = t
        return wide[1].unsqueeze(0)
    if layout == "size1_strides":  # the resample kernels' output for a one-row, one-plane cloud
        shape = (1,) + tuple(t.shape)
        strides = [1 if d == 1 else st for d, st in zip(shape, t[None].contiguous().stride())]
        out = t.new_empty_strided(shape, strides)
        out.copy_(t[None])
        return out
    return t.expand((1,) + tuple(t.shape))


ROW_LAYOUTS = ["contiguous", "unsqueeze", "expand", "size1_strides"]


@pytest.mark.parametrize("n", [1024, 8192])
@pytest.mark.parametrize("layout", ROW_LAYOUTS)
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_resample_kernels_at_one_row(cuda, n, layout, c):
    """K1 and K3 at M = 1 (the per-θ filters' rows) on a contiguous row and
    on unsqueezed, expanded and length-1-strided views of the weights and
    cloud: ancestors and output bitwise the plain versions', one launch
    counted each."""
    rng = np.random.default_rng(20 + c)
    a = 2.0 * rng.standard_normal(n)
    w = _as_row(torch.tensor(np.exp(a - a.max()), dtype=torch.float32, device=cuda), layout)
    xs = _as_row(torch.tensor(rng.standard_normal((c, n)), dtype=torch.float32, device=cuda),
                 layout)
    u0 = torch.tensor(rng.random((1, 1)), dtype=torch.float32, device=cuda)
    before = resample_gather.launches
    out, anc = resample_gather(u0, w, xs, return_ancestors=True)
    assert resample_gather.launches == before + 1
    ref, anc_ref = resample_gather_plain(u0, w, xs)
    assert torch.equal(anc, anc_ref) and torch.equal(out, ref)
    u = torch.sort(torch.tensor(rng.random((1, n)), dtype=torch.float32, device=cuda), -1).values
    before = resample_gather_sorted.launches
    out, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
    assert resample_gather_sorted.launches == before + 1
    ref, anc_ref = resample_gather_sorted_plain(u, w, xs)
    assert torch.equal(anc, anc_ref) and torch.equal(out, ref)


@pytest.mark.parametrize("n", [1024, 8192])
@pytest.mark.parametrize("layout", ROW_LAYOUTS)
@pytest.mark.parametrize("name,route", [("ucsv", "normalized"), ("lg1", "normalized"),
                                        ("lg1", "carry"), ("lg1", "raw"), ("sv", "raw"),
                                        ("ucsv", "k6")])
def test_propagate_kernels_at_one_row(cuda, n, layout, name, route):
    """K2 (normalized, with carry, raw) and K6 at M = 1 on a contiguous row
    and on unsqueezed, expanded and length-1-strided views of the state,
    parameters and carry: the plain version, fed the normals recovered from
    the kernel's state deltas, gives its outputs to rtol 1e-5; K6 equals
    K2-UC-SV raw at the same seed to 1e-5."""
    rng = np.random.default_rng(30)
    if name == "ucsv":
        update, p = UCSV_UPDATE, rng.uniform(0.05, 0.5, 2)
    else:
        update, p = _instance(name, rng, 1)
        p = p[0]
    params = _as_row(torch.tensor(p, dtype=torch.float32, device=cuda), layout)
    s = 3 if name == "ucsv" else update.n_normals
    scale = np.array([1.0, 0.5, 0.5])[:s, None]
    state = _as_row(torch.tensor(rng.standard_normal((s, n)) * scale, dtype=torch.float32,
                                 device=cuda), layout)
    y = torch.tensor(0.6, device=cuda)
    seed = torch.tensor([97531], device=cuda)
    if route == "k6":
        before = ucsv_propagate_reweight.launches
        got = ucsv_propagate_reweight(seed, y, params[:, 0], params[:, 1], state)
        assert ucsv_propagate_reweight.launches == before + 1
        z = _recover_normals(name, params, state, got[0])
        ref = ucsv_propagate_reweight_plain(y, params[:, 0], params[:, 1], state, z)
        k2 = fused_elementwise_step(update, params, state, y, seed=seed, normalize=False)
        for a, b in zip(got, k2):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        carry = None
        if route == "carry":
            a = 3.0 * rng.standard_normal(n)
            carry = _as_row(torch.tensor(a - np.log(np.exp(a).sum()), dtype=torch.float32,
                                         device=cuda), layout)
        normalize = route != "raw"
        got = fused_elementwise_step(update, params, state, y, seed=seed, carry_logw=carry,
                                     normalize=normalize)
        z = _recover_normals(name, params, state, got[0])
        ref = fused_elementwise_step_plain(update, params, state, y, z, carry, normalize)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(got[1]).all()


@pytest.mark.parametrize("m,n,name,route", [(8, 8192, "ucsv", "normalized"),
                                          (8, 8192, "ucsv", "k6"), (8, 128, "lg1", "normalized"),
                                          (8, 128, "lg1", "raw"), (1, 256, "lg1", "raw"),
                                          (8, 1024, "lg1", "normalized")])
def test_propagate_kernels_at_the_bank_shapes(cuda, m, n, name, route):
    """K2 and K6 at the banks' shapes of the smoothers and particle Gibbs
    (the posterior mixture's and the pooled UC-SV chains' 8×8192, the pooled
    LG chains' 8×128, the CSMC runs' 1×256, the inflation example's UC
    posterior mixture's 8×1024), distinct parameters per row:
    the plain version, fed the normals recovered from the kernel's state
    deltas, gives its outputs to rtol 1e-5; K6 equals K2-UC-SV raw at the
    same seed to 1e-5; the normals' moments within 5 standard errors of
    their count."""
    rng = np.random.default_rng(40 + m)
    if name == "ucsv":
        update, p = UCSV_UPDATE, rng.uniform(0.05, 0.5, (m, 2))
    else:
        update, p = _instance(name, rng, m)
    params = torch.tensor(p, dtype=torch.float32, device=cuda)
    s = 3 if name == "ucsv" else update.n_normals
    scale = np.array([1.0, 0.5, 0.5])[:s, None]
    state = torch.tensor(rng.standard_normal((m, s, n)) * scale, dtype=torch.float32, device=cuda)
    y = torch.tensor(0.6, device=cuda)
    seed = torch.tensor([24680], device=cuda)
    if route == "k6":
        got = ucsv_propagate_reweight(seed, y, params[:, 0], params[:, 1], state)
        z = _recover_normals(name, params, state, got[0])
        ref = ucsv_propagate_reweight_plain(y, params[:, 0], params[:, 1], state, z)
        k2 = fused_elementwise_step(update, params, state, y, seed=seed, normalize=False)
        for a, b in zip(got, k2):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        normalize = route != "raw"
        got = fused_elementwise_step(update, params, state, y, seed=seed, normalize=normalize)
        z = _recover_normals(name, params, state, got[0])
        ref = fused_elementwise_step_plain(update, params, state, y, z, None, normalize)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    flat = z.reshape(z.shape[0], -1).double()
    count = flat.shape[1]
    assert flat.mean(1).abs().max().item() < 5 / np.sqrt(count)
    assert (flat.var(1) - 1.0).abs().max().item() < 5 * np.sqrt(2 / count)


@pytest.mark.parametrize("name", ["ucsv", "lg", "sv"])
def test_csmc_slot0_log_weight_on_the_raw_route(cuda, name):
    """CSMC's step on the card: the model's raw kernel route (K6 on UC-SV,
    K2 raw on LG and SV) propagates every slot, then slot 0's state is the
    reference and its raw log-weight g(y | ref) exactly as torch evaluates
    it; the other slots' log-weights are the observation density at their
    new states (to 1e-5); slot 0's ancestor is 0."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.ops.batched_filter import _draws
    from sequential_monte_carlo_tpu_torch.ops.csmc import _MULTINOMIAL, _csmc_step_from_draws

    models = {"ucsv": lambda: smc.ucsv_model(torch.tensor([0.2, 3.0, 0.3, 0.3], device=cuda)),
              "lg": lambda: smc.lg_model(torch.tensor([0.5, 0.9, 0.8], device=cuda)),
              "sv": lambda: smc.stochastic_volatility(device=cuda)}
    bank = smc.broadcast_model(models[name]())
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = 4096
    x = bank.initial_distribution().sample(gen, (n,))
    cloud = x.permute(1, 2, 0).contiguous()
    log_w = torch.log_softmax(torch.randn((1, n), generator=gen, device=cuda), -1)
    ref = x[5] + 0.1  # (1, dx): the one row's reference state
    y = torch.tensor(2.9, device=cuda)
    u, rest = _draws(gen, bank, 1, n, cuda, _MULTINOMIAL)
    ref_log_g = bank.observation_distribution(ref).log_prob(y)  # g(y | ref), torch's
    counts = (ucsv_propagate_reweight.launches, dict(fused_elementwise_step.instance_launches))
    new, logw, anc = _csmc_step_from_draws(u, None, rest, bank, cloud, log_w, y, ref, ref_log_g)
    if name == "ucsv":
        assert ucsv_propagate_reweight.launches == counts[0] + 1
    else:
        key = ("lg1" if name == "lg" else "sv") + "_raw"
        assert fused_elementwise_step.instance_launches[key] == counts[1].get(key, 0) + 1
    assert torch.equal(new[:, :, 0], ref) and int(anc[0, 0]) == 0
    assert torch.equal(logw[:, 0], ref_log_g)
    dens = bank.observation_distribution(new.permute(2, 0, 1)).log_prob(y).T
    torch.testing.assert_close(logw[:, 1:], dens[:, 1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["bs", "as"])
def test_particle_gibbs_on_the_card_reads_nothing_back(cuda, method):
    """A short particle-Gibbs run on UC-SV on the card: θ, acceptance and
    paths stay on the device, K6 runs once per CSMC step and K2-UC-SV once
    per step of the initial filter."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    prior = prior_from_spec([("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
                             ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)], device=cuda)
    rng = np.random.default_rng(1998)
    y = torch.tensor(3.0 + np.cumsum(rng.normal(0, 0.3, 40)) + rng.normal(0, 0.5, 40),
                     dtype=torch.float32, device=cuda)
    k6, k2 = ucsv_propagate_reweight.launches, fused_elementwise_step.instance_launches["ucsv"]
    res = smc.particle_gibbs(torch.Generator(device=cuda).manual_seed(0), smc.ucsv_model, prior,
                             y, smc.PGConfig(n_particles=256, sweeps=5, chain=2, method=method))
    assert ucsv_propagate_reweight.launches == k6 + 39 * 5
    assert fused_elementwise_step.instance_launches["ucsv"] == k2 + 39
    assert res.theta.device.type == "cuda" and res.theta.shape == (5, 4)
    assert torch.isfinite(res.theta).all() and torch.isfinite(res.final_path).all()


@pytest.mark.parametrize("m,n,c", [(8, 1024, 1), (8, 8192, 3), (1, 1024, 1), (512, 1024, 4)])
def test_resample_kernels_at_the_new_paths_shapes(cuda, m, n, c):
    """K1 and K3 at the shapes the inflation example and the DSL routes hand
    them (the UC posterior mixture's 8×1024 C=1, the UC-SV one's 8×8192
    C=3, the UC filter at θ̂'s 1×1024, the DSL UC-SV APF's 512×1024 C=4):
    ancestors and output bitwise the plain versions'."""
    rng = np.random.default_rng(50 + c)
    a = 2.0 * rng.standard_normal((m, n))
    w = torch.tensor(np.exp(a - a.max(-1, keepdims=True)), dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.standard_normal((m, c, n)), dtype=torch.float32, device=cuda)
    u0 = torch.tensor(rng.random((m, 1)), dtype=torch.float32, device=cuda)
    out, anc = resample_gather(u0, w, xs, return_ancestors=True)
    ref, anc_ref = resample_gather_plain(u0, w, xs)
    assert torch.equal(anc, anc_ref) and torch.equal(out, ref)
    u = torch.sort(torch.tensor(rng.random((m, n)), dtype=torch.float32, device=cuda), -1).values
    out, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
    ref, anc_ref = resample_gather_sorted_plain(u, w, xs)
    assert torch.equal(anc, anc_ref) and torch.equal(out, ref)


def _dsl_ucsv(m: int, cuda):
    """UC-SV written with ssm_model (ucsv_model's θ layout), an m-row bank
    on the card."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.distributions import Normal

    spec = smc.ssm_model(
        "ucsv4", params=("gamma", "x0", "lse0", "lsn0"),
        init=lambda p: dict(x=Normal(p["x0"], torch.exp(0.5 * p["lse0"])),
                            lse=Normal(p["lse0"], p["gamma"]),
                            lsn=Normal(p["lsn0"], p["gamma"])),
        transition=lambda p, prev: dict(x=Normal(prev["x"], torch.exp(0.5 * prev["lse"])),
                                        lse=Normal(prev["lse"], p["gamma"]),
                                        lsn=Normal(prev["lsn"], p["gamma"])),
        observe=lambda p, s: Normal(s["x"], torch.exp(0.5 * s["lsn"])))
    return spec(torch.tensor([0.2, 3.0, -1.0, -1.0], device=cuda).expand(m, 4))


@pytest.mark.parametrize("inner, active_n, kernel", [
    (("systematic", 1.0), None, "count"), (("stratified", 0.5), None, "sorted"),
    (("systematic", 1.0), 768, "sorted"), (("systematic", 1.0, None, "apf"), None, "count")])
def test_dsl_route_on_the_card(cuda, inner, active_n, kernel):
    """A DSL UC-SV bank (64×1024, T=40) on the bootstrap, ESS-triggered,
    elastic and auxiliary routes: every step launches K1 or K3 once, no
    propagate kernel runs, the weights are normalized and log Z finite."""
    import sequential_monte_carlo_tpu_torch as smc

    rng = np.random.default_rng(1998)
    y = torch.tensor(3.0 + np.cumsum(rng.normal(0, 0.3, 40)) + rng.normal(0, 0.5, 40),
                     dtype=torch.float32, device=cuda)
    before = (resample_gather.launches, resample_gather_sorted.launches,
              ucsv_propagate_reweight.launches, sum(fused_elementwise_step.instance_launches.values()))
    _, lw, lz = smc.batched_log_likelihood(torch.Generator(device=cuda).manual_seed(0),
                                           _dsl_ucsv(64, cuda), 1024, 64, y,
                                           smc.PFConfig(*inner), active_n=active_n)
    after = (resample_gather.launches, resample_gather_sorted.launches,
             ucsv_propagate_reweight.launches, sum(fused_elementwise_step.instance_launches.values()))
    steps = {"count": (39, 0), "sorted": (0, 39)}[kernel]
    assert (after[0] - before[0], after[1] - before[1]) == steps
    assert after[2:] == before[2:]
    assert torch.isfinite(lz).all()
    torch.testing.assert_close(torch.logsumexp(lw, 1), torch.zeros(64, device=cuda),
                               atol=1e-4, rtol=0)


def test_checkpoint_on_the_card_keeps_planar_storage(cuda, tmp_path):
    """An SMC² state on the card round-trips through a checkpoint bitwise,
    onto the card, with its planar particle storage and its generator."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
    from sequential_monte_carlo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    prior = prior_from_spec([("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
                             ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)], device=cuda)
    y = torch.linspace(2.0, 4.0, 20, device=cuda)
    sampler = smc.SMC2(smc.ucsv_model, prior, smc.SMCConfig(n_particles=256, n_theta=32, chain=2))
    gen = torch.Generator(device=cuda).manual_seed(1)
    state = sampler.init(gen, y)
    state, _ = sampler.step(gen, state, y)
    path = str(tmp_path / "s.pt")
    save_checkpoint(path, state, gen)
    gen2 = torch.Generator(device=cuda).manual_seed(9)
    back = load_checkpoint(path, state, generator=gen2)
    assert back.particles.device.type == "cuda" and back.particles.transpose(1, 2).is_contiguous()
    assert torch.equal(back.particles, state.particles) and torch.equal(back.theta, state.theta)
    assert torch.equal(gen2.get_state(), gen.get_state())


def test_debug_nans_on_the_card(cuda):
    from sequential_monte_carlo_tpu_torch.utils.debug import debug_nans

    x = torch.tensor([1.0, -1.0], device=cuda)
    with debug_nans(), pytest.raises(FloatingPointError, match="sqrt"):
        torch.sqrt(x)


def _weights(rng, m, n, cuda):
    a = 2.0 * rng.standard_normal((m, n))
    w = np.exp(a - a.max(-1, keepdims=True))
    return torch.tensor(w / w.sum(-1, keepdims=True), dtype=torch.float32, device=cuda)


@pytest.mark.parametrize("m, n, shards", [(512, 8192, 2), (512, 8192, 4), (64, 65536, 2),
                                          (64, 1000, 4), (64, 1002, 2)])
def test_resample_windows_equal_the_whole_outputs_slots(cuda, m, n, shards):
    """Particle-axis sharding: K1 with a slot window and K3 on a window of
    the grid give the whole launch's slots of the window bit for bit, and
    their ancestors, on both routes of each (the large route above the
    shared-memory cap) and on windows that 16-byte stores do not take."""
    rng = np.random.default_rng(21)
    w = _weights(rng, m, n, cuda)
    xs = torch.tensor(rng.standard_normal((m, 3, n)), dtype=torch.float32, device=cuda)
    u0 = torch.tensor(rng.random((m, 1)), dtype=torch.float32, device=cuda)
    u = stratified_uniforms(torch.Generator(device=cuda).manual_seed(3), m, n)
    whole1, anc1 = resample_gather(u0, w, xs, return_ancestors=True)
    whole3, anc3 = resample_gather_sorted(u, w, xs, return_ancestors=True)
    k = n // shards
    for lo in range(0, n, k):
        out, anc = resample_gather(u0, w, xs, return_ancestors=True, slot_lo=lo, n_out=k)
        assert torch.equal(out, whole1[:, :, lo:lo + k]) and torch.equal(anc, anc1[:, lo:lo + k])
        out, anc = resample_gather_sorted(u[:, lo:lo + k].contiguous(), w, xs,
                                          return_ancestors=True)
        assert torch.equal(out, whole3[:, :, lo:lo + k]) and torch.equal(anc, anc3[:, lo:lo + k])
    out = resample_gather(u0, w, xs, slot_lo=3, n_out=5)
    assert torch.equal(out, whole1[:, :, 3:8])


@pytest.mark.parametrize("name", ["ucsv", "lg1", "ucsv_k6"])
@pytest.mark.parametrize("normalize", [False, True])
def test_propagate_particle_offset_draws_the_whole_launchs_columns(cuda, name, normalize):
    """K2 (UC-SV, LG dx=1) and K6 on particles 4096.. of 512×8192 rows at
    particle_offset 4096 draw what the whole launch draws there: the new
    cloud, and the raw log-weights, are its columns bit for bit (the
    normalize is the slice's own)."""
    rng = np.random.default_rng(22)
    m, n, k = 512, 8192, 4096
    if name == "lg1":
        update, p = _instance("lg1", rng, m)
    else:
        update, p = UCSV_UPDATE, rng.uniform(0.05, 0.5, (m, 2))
    params = torch.tensor(p, dtype=torch.float32, device=cuda)
    s = 3 if update is UCSV_UPDATE else 1
    state = torch.tensor(0.5 * rng.standard_normal((m, s, n)), dtype=torch.float32, device=cuda)
    y, seed = torch.tensor(0.6, device=cuda), torch.tensor([(1 << 33) + 99], device=cuda)
    if name == "ucsv_k6":
        def step(st, **kw):
            return ucsv_propagate_reweight(seed, y, params[:, 0], params[:, 1], st,
                                           normalize=normalize, **kw)
    else:
        def step(st, **kw):
            return fused_elementwise_step(update, params, st, y, seed=seed, normalize=normalize,
                                          **kw)
    whole = step(state)
    part = step(state[:, :, k:].contiguous(), particle_offset=k)
    assert torch.equal(part[0], whole[0][:, :, k:])
    if not normalize:
        assert torch.equal(part[1], whole[1][:, k:])


@pytest.mark.parametrize("offset, width", [(8, 1016), (500, 500), (16, 1000), (0, 1000),
                                           (3, 1001)])
@pytest.mark.parametrize("layout", ["view", "contiguous"])
def test_ucsv_kernel_takes_any_particle_slice(cuda, offset, width, layout):
    """K6 on particles offset..offset+width of 64×1024 rows at that
    particle_offset, on the APF's strided view and on a contiguous copy:
    its new cloud and raw log-weights are the whole call's columns bit for
    bit, and its normalized route's new cloud too, at offsets and widths
    off a multiple of 16 (a particle-sharded UC-SV filter at N = 1000) and
    off a multiple of 4 (the 4-byte access route)."""
    cloud, gam = _ucsv_cloud(np.random.default_rng(23), 64, 1024, cuda, layout)
    seed, y = torch.tensor([(1 << 33) + 5], device=cuda), torch.tensor(0.1, device=cuda)
    cols = slice(offset, offset + width)
    part = cloud[:, :, cols]
    if layout == "contiguous":
        part = part.contiguous()
    whole = ucsv_propagate_reweight(seed, y, gam[:, 0], gam[:, 1], cloud)
    new, logw = ucsv_propagate_reweight(seed, y, gam[:, 0], gam[:, 1], part,
                                        particle_offset=offset)
    assert torch.equal(new, whole[0][:, :, cols]) and torch.equal(logw, whole[1][:, cols])
    norm = ucsv_propagate_reweight(seed, y, gam[:, 0], gam[:, 1], part, normalize=True,
                                   particle_offset=offset)
    assert torch.equal(norm[0], new)
    with pytest.raises(ValueError, match="particle_offset"):
        ucsv_propagate_reweight(seed, y, gam[:, 0], gam[:, 1], part, particle_offset=-1)


# -- the masked filter's captured steps (ops/graphs.py) -----------------------

def _launch_counts():
    return (resample_gather.launches, resample_gather_sorted.launches,
            ucsv_propagate_reweight.launches, dict(fused_elementwise_step.instance_launches))


def _graph_bank(kind, m, seed, cuda):
    """An m-row UC-SV or LG θ bank drawn with numpy, on the card."""
    import sequential_monte_carlo_tpu_torch as smc

    rng = np.random.default_rng(seed)
    if kind == "ucsv":
        theta = np.c_[rng.uniform(0.1, 0.4, m), rng.normal(3.0, 0.5, m),
                      rng.normal(-1.0, 0.3, m), rng.normal(-1.0, 0.3, m)]
        return smc.ucsv_model(torch.tensor(theta, dtype=torch.float32, device=cuda))
    theta = np.c_[rng.uniform(0.3, 0.9, m), rng.uniform(0.5, 1.0, m), rng.uniform(0.5, 1.0, m)]
    return smc.lg_model(torch.tensor(theta, dtype=torch.float32, device=cuda))


def _masked_run(seed, models, m, n, y, mask, inner, cuda):
    """One masked filter of m rows from ``seed``: (its outputs, the
    launches it counted, the generator's state after it)."""
    import sequential_monte_carlo_tpu_torch as smc

    gen = torch.Generator(device=cuda).manual_seed(seed)
    before = _launch_counts()
    out = smc.batched_log_likelihood_masked(gen, models, n, m, y, mask, smc.PFConfig(*inner))
    torch.cuda.synchronize()
    after = _launch_counts()
    counts = tuple(a - b for a, b in zip(after[:3], before[:3])) + (
        {k: v - before[3].get(k, 0) for k, v in after[3].items() if v != before[3].get(k, 0)},)
    return out, counts, gen.get_state()


def _series_on(cuda, t):
    rng = np.random.default_rng(1998)
    return torch.tensor(3.0 + np.cumsum(rng.normal(0, 0.3, t)) + rng.normal(0, 0.5, t),
                        dtype=torch.float32, device=cuda)


def test_kernel_wrappers_write_out_on_the_card(cuda):
    """Every kernel wrapper with ``out=`` writes its allocating launch's
    bits into the given buffers (K1, K3, K2 normalized with a carry and
    raw, K6 raw and normalized on the APF's strided view), at 512×1024."""
    rng = np.random.default_rng(31)
    m, n = 512, 1024
    w = torch.tensor(rng.gamma(0.5, size=(m, n)), dtype=torch.float32, device=cuda)
    xs = torch.tensor(rng.normal(size=(m, 3, n)), dtype=torch.float32, device=cuda)
    u0 = torch.rand((m, 1), device=cuda)
    u = stratified_uniforms(torch.Generator(device=cuda).manual_seed(0), m, n)
    for fn, args in ((resample_gather, (u0, w, xs)), (resample_gather_sorted, (u, w, xs))):
        buf = torch.full_like(xs, float("nan"))
        assert fn(*args, out=buf) is buf and torch.equal(buf, fn(*args))
    seed, y = torch.tensor([12345], device=cuda), torch.tensor(3.0, device=cuda)
    params = torch.tensor(rng.uniform(0.1, 0.3, size=(m, 2)), dtype=torch.float32, device=cuda)
    carry = torch.log(w / w.sum(1, keepdim=True))
    aug = torch.tensor(rng.normal(size=(m, 4, n)), dtype=torch.float32, device=cuda)
    calls = [lambda out=None: fused_elementwise_step(UCSV_UPDATE, params, xs, y, seed=seed,
                                                     carry_logw=carry, out=out),
             lambda out=None: fused_elementwise_step(UCSV_UPDATE, params, xs, y, seed=seed,
                                                     normalize=False, out=out)]
    calls += [lambda out=None, norm=norm: ucsv_propagate_reweight(
        seed, y, params[:, 0], params[:, 1], aug[:, :3], normalize=norm, out=out)
        for norm in (False, True)]
    for call in calls:
        ref = call()
        out = (torch.full_like(xs, float("nan")), torch.full_like(w, float("nan")))
        got = call(out=out)
        assert got[0] is out[0] and got[1] is out[1]
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind, inner, n", [
    ("ucsv", ("systematic", 1.0), 1024), ("ucsv", ("systematic", 1.0), 8192),
    ("lg", ("stratified", 0.5), 1024), ("ucsv", ("systematic", 1.0, None, "apf"), 1024),
    ("lg", ("systematic", 1.0, None, "apf"), 1024), ("lg", ("systematic", 1.0), 32768),
    ("lg", ("stratified", 0.5), 32768)])
def test_graph_replays_equal_eager(cuda, kind, inner, n):
    """Each captured route at 512 rows (UC-SV also at N=8192, LG also at
    N=32,768: K2's split route, with and without the carry): the masked
    filter replayed from its graphs equals the eager loop under
    ``disable_graphs`` bit for bit — particles, log-weights, log Z and the
    generator's state after it — with the same launch counts, for the first
    bank (warm-up step, capture, replays) and for a second bank replayed
    through the same graphs (the copy-in)."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.ops import graphs

    smc.clear_graphs()
    y = _series_on(cuda, 100)
    mask = torch.arange(100) < 80
    banks = [_graph_bank(kind, 512, seed, cuda) for seed in (0, 1)]
    with smc.disable_graphs():
        ref = [_masked_run(s, bank, 512, n, y, mask, inner, cuda) for s, bank in enumerate(banks)]
    got = [_masked_run(s, bank, 512, n, y, mask, inner, cuda) for s, bank in enumerate(banks)]
    assert len(graphs._cache) == 1
    for (out, counts, state), (ref_out, ref_counts, ref_state) in zip(got, ref):
        for a, b in zip(out, ref_out):
            assert torch.equal(a, b)
        assert counts == ref_counts and sum(counts[:3]) + sum(counts[3].values()) == 2 * 79
        assert torch.equal(state, ref_state)
    assert not torch.equal(got[0][0][2], got[1][0][2])
    smc.clear_graphs()


@pytest.mark.parametrize("route", ["guided", "dsl", "metropolis"])
def test_guided_dsl_and_metropolis_routes_replay(cuda, route):
    """A guided proposal, a DSL model and the metropolis resampler replay
    graphs on the card: one route is cached and replayed, and the run
    equals the one under ``disable_graphs`` bit for bit with the same
    launch counts."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.ops import graphs

    smc.clear_graphs()
    y = _series_on(cuda, 40)
    mask = torch.ones(40)
    bank = _dsl_ucsv(64, cuda) if route == "dsl" else _graph_bank("ucsv", 64, 0, cuda)
    inner = {"guided": ("systematic", 1.0, smc.Proposal(
        initial=lambda mm: mm.initial_distribution(),
        step=lambda mm, xp: mm.transition_distribution(xp))),
        "dsl": ("systematic", 1.0), "metropolis": ("metropolis", 1.0)}[route]
    with smc.disable_graphs():
        ref = _masked_run(0, bank, 64, 1024, y, mask, inner, cuda)
    got = _masked_run(0, bank, 64, 1024, y, mask, inner, cuda)
    (captured,) = graphs._cache.values()
    assert captured.graphed and captured.replays == 39 // graphs.STEPS_PER_GRAPH + 39 % (
        graphs.STEPS_PER_GRAPH)
    for a, b in zip(got[0], ref[0]):
        assert torch.equal(a, b)
    assert got[1] == ref[1] and torch.equal(got[2], ref[2])


def test_host_sync_in_a_captured_step_raises(cuda, monkeypatch):
    """A host read put into the captured step makes the capture raise (it
    is captured with capture_error_mode="global"); nothing runs the eager
    loop in its place, and no graph is kept."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.ops import batched_filter, graphs

    smc.clear_graphs()
    step = batched_filter._pf_step_from_draws

    def synced(*args, **kwargs):
        out = step(*args, **kwargs)
        out.log_mean.sum().item()
        return out

    monkeypatch.setattr(batched_filter, "_pf_step_from_draws", synced)
    with pytest.raises(RuntimeError):
        smc.batched_log_likelihood(torch.Generator(device=cuda).manual_seed(0),
                                   _graph_bank("ucsv", 64, 0, cuda), 1024, 64,
                                   _series_on(cuda, 20), smc.PFConfig())
    assert not graphs._cache
    monkeypatch.undo()
    smc.clear_graphs()
    torch.cuda.synchronize()
