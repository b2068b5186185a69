"""The port's noise stream (mppi_gpu_tpu_torch/ops/philox.py): Philox4x32-10
known answers, normal statistics, stream separation, antithetic mirror, OU.

The stream is the port's own (the TPU's on-chip PRNG cannot be replayed on a
GPU), so it is held to Random123's published answers and to its statistics;
the CUDA kernels are held to it bit for bit on the card (chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from mppi_gpu_tpu_torch.ops import philox  # noqa: E402


@pytest.mark.parametrize(
    "ctr,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox4x32_10_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32_10."""
    out = philox.philox4x32(tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w[0]) for w in out) == want


def test_mulhilo_matches_exact_product():
    rng = np.random.default_rng(0)
    b = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    for m in (0xD2511F53, 0xCD9E8D57):
        hi, lo = philox._mulhilo(m, torch.as_tensor(b.astype(np.int64)))
        full = [m * int(x) for x in b]
        assert hi.tolist() == [f >> 32 for f in full]
        assert lo.tolist() == [f & 0xFFFFFFFF for f in full]


def test_normals_mean_and_variance():
    """K·T = 10⁵ draws of A=4 normals: mean 0, variance 1, no cross-dim
    correlation."""
    n = philox.box_muller(philox.philox_words(3, 0, 0, 100, 1000, "cpu"), 4).reshape(-1, 4)
    n = n.double().numpy()
    assert np.abs(n.mean(0)).max() < 0.01          # 4σ at N = 10⁵
    assert np.abs(n.var(0) - 1.0).max() < 0.02
    c = np.corrcoef(n.T) - np.eye(4)
    assert np.abs(c).max() < 0.015
    assert np.abs(n).max() < np.sqrt(2 * 24 * np.log(2)) + 1e-6  # 24-bit uniform cap


def test_first_normals_do_not_depend_on_A():
    w = philox.philox_words(5, 2, 1, 7, 33, "cpu")
    full = philox.box_muller(w, 4)
    for A in (1, 2, 3):
        assert torch.equal(philox.box_muller(w, A), full[..., :A])


def test_distinct_counters_give_distinct_streams():
    sig = torch.full((3,), 0.25)
    base = philox.sample_eps(9, 4, 0, 10, 64, sig)
    assert torch.equal(base, philox.sample_eps(9, 4, 0, 10, 64, sig))  # replayable
    for other in (
        philox.sample_eps(9, 5, 0, 10, 64, sig),   # next control step
        philox.sample_eps(9, 4, 1, 10, 64, sig),   # next opt-iteration
        philox.sample_eps(10, 4, 0, 10, 64, sig),  # other seed
        philox.sample_eps(9 + 2**32, 4, 0, 10, 64, sig),  # seed high word
    ):
        assert not torch.isclose(base, other).any()


def test_antithetic_mirror_is_exact():
    sig = torch.tensor([0.25, 0.5])
    for ou in (0.0, 0.6):
        eps = philox.sample_eps(1, 2, 0, 12, 100, sig, antithetic=True, ou_beta=ou)
        assert eps.shape == (12, 100, 2)
        assert torch.equal(eps[:, 50:], -eps[:, :50])
        plain = philox.sample_eps(1, 2, 0, 12, 50, sig, ou_beta=ou)
        assert torch.equal(eps[:, :50], plain)  # the drawing half is the K/2 stream
    with pytest.raises(ValueError):
        philox.sample_eps(1, 2, 0, 12, 99, sig, antithetic=True)


def test_ou_noise_keeps_marginals_and_correlates():
    beta = 0.8
    nu = philox.box_muller(philox.philox_words(2, 0, 0, 60, 4000, "cpu"), 1)
    eps = philox.normals_to_eps(nu, torch.ones(1), antithetic=False, ou_beta=beta)
    e = eps[..., 0].double().numpy()
    assert np.abs(e[30:].var() - 1.0) < 0.03       # stationary variance σ²
    lag1 = np.mean(e[31:] * e[30:-1])
    assert abs(lag1 - beta) < 0.03                  # corr(e_t, e_{t-1}) = β
    assert torch.equal(eps[0], nu[0])               # e_0 = ν_0
