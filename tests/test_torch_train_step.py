"""Three steps of the port's ``make_train_step`` against the reference's
jitted step, for every arch at ``reduced``, without ``DisketchCompressor``
(here) and with it (``tests/test_torch_train_step_compress.py``: the
launcher's settings, width D // 64, depth 4, 2 subepochs, 5% recovered a
step).

Both start from the same numpy-seeded f32 weights and take the same
``SyntheticLM`` batches (frontend-stub archs: the same numpy-drawn input
embeddings).  Tolerances:

* loss, aux loss, grad norm and lr of every step: 1e-5 relative;
* the AdamW moments m and v and the compressor's residual: each
  coordinate within 5e-5 of its leaf's largest |value|, the gradients'
  own tolerance in ``tests/test_torch_train.py`` (they are linear in the
  gradients; zamba2's m comes to 1.06e-5);
* the parameters: each coordinate within 1e-5 of the tree's largest
  |value|, and within twice the learning rates summed in any case.
  Adam divides by ``sqrt(v_hat) + eps``: a coordinate whose gradient is a
  near-cancelling sum at the eps (1e-8) scale moves by a
  learning-rate-sized step whose size follows its rounding (seen on
  falcon-mamba's embedding, a token whose one gradient is ~5e-9 and
  differs in sign between the two runs).
* Where a coordinate may fall outside its tolerance for those reasons (the
  parameters; with the compressor everything it feeds, since an estimate
  within rounding of the top-k threshold is kept by one run and left in
  the residual by the other: zamba2 at step 2), at most one coordinate in
  10^4 may.  A wrong update or a wrong selection would move nearly every
  coordinate.  ``tests/test_torch_compress.py`` holds the compressor
  alone to the reference exactly on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_configs as ref_list_configs
from repro.configs import reduced as ref_reduced
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro.train.compress import DisketchCompressor as RC
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.train import make_compressor
from repro_torch.models import convert
from repro_torch.models import model as PM
from repro_torch.train import optimizer as PO
from repro_torch.train import train_step as PT
from repro_torch.tree import leaves
from torch_threads import one_thread  # noqa: F401

ARCHS = ref_list_configs()
B, S, STEPS, LR = 2, 32, 3, 1e-3


def mostly_close(got, want, rtol, lr_sum=None, per_leaf=True, frac=0.0):
    """Coordinates off by more than ``rtol`` of their leaf's (or, with
    ``per_leaf=False``, the tree's) largest |value|: at most ``frac`` of
    them, and with ``lr_sum`` none beyond ``2 * lr_sum``."""
    got = [g.float().numpy() for g in got]
    want = [np.asarray(w, np.float32) for w in want]
    top = max(float(np.abs(w).max()) for w in want)
    off = n = 0
    for g, w in zip(got, want):
        scale = float(np.abs(w).max()) if per_leaf else top
        err = np.abs(g - w)
        off += int((err > rtol * max(scale, 1e-30)).sum())
        n += err.size
        if lr_sum is not None:
            assert float(err.max()) <= 2 * lr_sum, float(err.max())
    assert off <= frac * n, f"{off} of {n} coordinates off"
    return off


def three_steps(name, compress):
    """Run both packages' three steps and hold them to each other by the
    tolerances of the module docstring."""
    cfg, rcfg = reduced(get_config(name)), ref_reduced(ref_get_config(name))
    params = PM.init_params(np.random.default_rng(0), cfg,
                            dtype=torch.float32, device="cpu")
    rparams = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                           convert.to_numpy(params))
    d = sum(p.numel() for p in leaves(params))
    pc = make_compressor(d) if compress else None
    rc = RC(width=pc.width, depth=4, n_sub=2, k_frac=0.05) if compress \
        else None
    pstep = PT.make_train_step(cfg, PO.cosine_schedule(LR, 1, 10),
                               compressor=pc)
    rstep = jax.jit(RT.make_train_step(rcfg, RO.cosine_schedule(LR, 1, 10),
                                       compressor=rc, sp=False))
    pst, rst = PT.init_train_state(params, pc), RT.init_train_state(
        rparams, rc)
    data, lr_sum = SyntheticLM(cfg.vocab, S, B, seed=0), 0.0
    for step in range(STEPS):
        b = data.batch(step)
        if cfg.embed_inputs:
            b["tokens"] = np.random.default_rng(step).standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        pb = {k: torch.from_numpy(v) if v.dtype == np.float32 else
              torch.from_numpy(v).long() for k, v in b.items()}
        pst, pm = pstep(pst, pb)
        rst, rm = rstep(rst, {k: jnp.asarray(v) for k, v in b.items()})
        for k in ("loss", "aux_loss", "grad_norm", "lr"):
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-5,
                                                 abs=1e-9), (step, k)
        lr_sum += float(rm["lr"])
    assert int(pst.step) == int(rst.step) == STEPS
    assert int(pst.opt.step) == int(rst.opt.step) == STEPS
    frac = 1e-4 if compress else 0.0
    for what in ("m", "v"):
        mostly_close(leaves(getattr(pst.opt, what)),
                     jax.tree.leaves(getattr(rst.opt, what)), 5e-5,
                     frac=frac)
    if compress:
        mostly_close(leaves(pst.comp.residual),
                     jax.tree.leaves(rst.comp.residual), 5e-5, frac=frac)
    mostly_close(leaves(pst.params), jax.tree.leaves(rst.params), 1e-5,
                 lr_sum=lr_sum, per_leaf=False, frac=1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_three_steps_match_reference(name):
    three_steps(name, compress=False)
