"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions.  They need an NVIDIA GPU and ``nvcc``; elsewhere they skip with
the reason.  Run them on the card with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``.

This file imports only the port (no JAX), so it also runs where JAX is
not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.sketch_update import fleet as FK

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or "
                    "interpret mode (their plain versions are tested on the "
                    "CPU in test_torch_fleet_kernel.py)")
    return torch.device("cuda")


def random_csr(seed, n_prow, n_levels, n_sub_choices, widths, blk=256,
               log2_te=16, mean_pkts=3000):
    """A random ragged CSR case: skewed (Zipf) segment lengths with some
    empty rows, random seeds, per-row n_sub and width, random ts words
    (high bits included — the level / single-hop fields)."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.5, n_prow) * (mean_pkts // 4), 20 * mean_pkts)
    lens[rng.random(n_prow) < 0.2] = 0
    nblk = np.maximum(1, -(-lens // blk))
    nb = int(nblk.sum())
    keys = rng.integers(0, 2 ** 32, nb * blk, dtype=np.uint64).astype(np.uint32)
    ts = rng.integers(0, 2 ** 32, nb * blk, dtype=np.uint64).astype(np.uint32)
    vals = np.zeros(nb * blk, np.float32)
    starts = np.concatenate([[0], np.cumsum(nblk)]) * blk
    for r in range(n_prow):
        vals[starts[r]:starts[r] + lens[r]] = rng.integers(1, 4, lens[r])
    block_frag = np.repeat(np.arange(n_prow, dtype=np.int32), nblk)
    params = np.zeros((n_prow * n_levels, FK.N_PARAMS), np.int32)
    params[:, :3] = rng.integers(0, 2 ** 31, (n_prow * n_levels, 3))
    n_sub = np.repeat(rng.choice(n_sub_choices, n_prow), n_levels)
    params[:, FK.PARAM_WIDTH] = np.repeat(rng.choice(widths, n_prow), n_levels)
    params[:, FK.PARAM_N_SUB] = n_sub
    params[:, FK.PARAM_LOG2_N_SUB] = np.log2(n_sub).astype(np.int32)
    params[:, FK.PARAM_LEVEL] = np.tile(np.arange(n_levels), n_prow)
    params[:, FK.PARAM_MIT] = rng.random(n_prow * n_levels) < 0.5
    return dict(keys=keys, vals=vals, ts=ts, params=params,
                block_frag=block_frag, n_sub_max=int(n_sub.max()),
                width_max=int(params[:, FK.PARAM_WIDTH].max()), blk=blk,
                log2_te=log2_te)


CASES = {
    "cs-wide": dict(n_prow=12, n_levels=1, n_sub_choices=[1, 2, 4],
                    widths=[3728, 65536, 70001, 123974, 262144]),
    "cms-nsub64": dict(n_prow=16, n_levels=1, n_sub_choices=[1, 8, 64],
                       widths=[1000, 4096, 20000]),
    "um16-mit": dict(n_prow=6, n_levels=16, n_sub_choices=[1, 2, 16],
                     widths=[500, 7000, 70000]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain_version_on_card(cuda_device, name):
    case = random_csr(sum(map(ord, name)), **CASES[name])
    signed = not name.startswith("cms")
    kw = dict(n_sub_max=case["n_sub_max"], width_max=case["width_max"],
              log2_te=case["log2_te"], signed=signed, blk=case["blk"],
              n_levels=CASES[name]["n_levels"],
              with_mitigation=name.endswith("mit"))
    args = [case[k] for k in ("keys", "vals", "ts", "params", "block_frag")]
    before = FK.fleet_update_ragged.launches
    got = FK.fleet_update_ragged(*args, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert FK.fleet_update_ragged.launches == before + 1
    ref = FK.fleet_update_ragged(*args, device="cpu", **kw)
    assert got.is_cuda and got.shape == ref.shape
    assert torch.equal(got.cpu(), ref)
