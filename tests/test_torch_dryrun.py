"""The port's dry-run (``repro_torch.launch.dryrun``).

  * A ``--device meta`` cell of a reduced dense arch (1 layer, d_model
    128, 4 heads, 2 KV heads, d_ff 256, vocab 256) under a fake group of 4
    ranks on a (2, 2) mesh, in a child interpreter (the group is global
    to a process): its per-device FLOPs equal a hand count of rank 0's
    shards, exactly, and its argument bytes the spec tables' count.
  * ``collective_bytes`` of that cell's collectives equals the
    reference's ``collective_bytes`` on HLO lines written from the same
    records, and on a fixed set.
  * ``cells()`` and ``input_specs`` equal the reference's.
  * Without a card, the default (``--device cuda``) raises.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import SHAPES, list_configs
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]

CELL = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from repro_torch.configs import base, get_config, reduced
    from repro_torch.launch import dryrun, make_mesh
    cfg = reduced(get_config("granite-8b"), n_layers=1)
    base._REGISTRY["granite-8b"] = cfg
    base.SHAPES["prefill_32k"] = base.ShapeConfig("prefill_32k", 16, 4,
                                                  "prefill")
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        run, args = dryrun.build_cell("granite-8b", "prefill_32k", mesh,
                                      device="meta")
        counter = dryrun._rank_counter()
        with counter:
            out = run()
        rec = dryrun.analyze(counter, mesh, dryrun._local_bytes(args),
                             dryrun._local_bytes(out), None)
        rec["collectives"] = counter.collectives
    print(json.dumps(rec))
""")


@pytest.fixture(scope="module")
def meta_cell():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", CELL], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-6000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_meta_cell_flops_equal_a_hand_count(meta_cell):
    """Rank 0 of (data 2, model 2): 2 of the 4 sequences of 16 tokens;
    heads, KV heads, d_ff and vocab halved over "model"; its query rows
    halved again by the sequence-parallel attention, against all 16
    cached keys."""
    d, h, kv, dh, f, v = 128, 4, 2, 32, 256, 256
    tokens = (4 // 2) * 16
    proj = d * (h // 2) * dh * 2 + d * (kv // 2) * dh * 2
    ffn = 3 * d * (f // 2)
    head = d * (v // 2)
    attn = 2 * 2 * (4 // 2) * (16 // 2) * h * 16 * dh      # qk and pv
    want = 2 * tokens * (proj + ffn + head) + attn
    assert meta_cell["flops"] == want
    assert meta_cell["n_devices"] == 4
    assert meta_cell["memory_analysis"]["peak_bytes"] == \
        meta_cell["memory_analysis"]["argument_bytes"]


def test_meta_cell_argument_bytes_equal_the_spec_tables(meta_cell):
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import model as PM
    from repro_torch.tree import leaves

    cfg = reduced(get_config("granite-8b"), n_layers=1)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    params = PM.init_params(None, cfg, dtype=torch.bfloat16, device="meta")
    total = 4 * 16 * 4 // 2                           # int32 tokens / data
    for x, spec in zip(leaves(params), leaves(SH.param_specs(
            params, cfg, mesh, fsdp=False))):
        div = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                div *= 2
        total += x.numel() * 2 // div
    assert meta_cell["memory_analysis"]["argument_bytes"] == total


def _hlo(records):
    return "\n".join(
        f"  %c{i} = {dt}{''.join('[' + ','.join(map(str, s)) + ']' for s in sh)}"
        f" {kind}(%p{i}), replica_groups={{}}"
        for i, (kind, dt, sh, _) in enumerate(records))


FIXED = [("all-gather", "bf16", [[32, 2048, 8, 16]], 32 * 2048 * 8 * 16 * 2),
         ("all-reduce", "f32", [[2, 4096, 2304]], 2 * 4096 * 2304 * 4),
         ("all-gather", "bf16", [[32, 2048, 8, 16]], 32 * 2048 * 8 * 16 * 2),
         ("reduce-scatter", "f32", [[4, 16]], 4 * 16 * 4),
         ("all-to-all", "s32", [[8]], 32),
         ("all-reduce", "f32", [[]], 4)]


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dryrun module, imported with XLA_FLAGS restored
    afterwards (the module appends a forced device count to it)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as RD
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return RD


@pytest.mark.parametrize("which", ["fixed", "cell"])
def test_collective_bytes_equal_the_reference(which, meta_cell, ref_dryrun):
    records = FIXED if which == "fixed" else [
        tuple(r) for r in meta_cell["collectives"]]
    assert records
    got = dryrun.collective_bytes(records, top_k=5)
    want = ref_dryrun.collective_bytes(_hlo(records), top_k=5)
    assert got[0] == want[0]
    assert got[1] == want[1]
    if which == "cell":
        assert sum(got[0].values()) == meta_cell["collective_bytes_total"]


def test_cells_equal_the_reference(ref_dryrun):
    for kinds in (["single"], ["multi"], ["single", "multi"]):
        assert dryrun.cells(kinds) == ref_dryrun.cells(kinds)


@pytest.mark.parametrize("arch", list_configs())
def test_input_specs_equal_the_reference(arch, ref_dryrun):
    for name in SHAPES:
        got = dryrun.input_specs(arch, name)
        want = ref_dryrun.input_specs(arch, name)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_h100_constants():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_default_device_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "gemma2-2b", "--shape", "train_4k"])
