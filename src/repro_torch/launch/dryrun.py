"""Multi-pod dry-run: rank 0's program of every (arch x shape x mesh) cell,
the counterpart of ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads the compiled module's cost and memory analyses.  The
port runs **rank 0's own program** under a fake process group of 256
(16 x 16) or 512 (2 x 16 x 16) ranks in one process: the parameters,
optimizer state, batch and decode state are DTensors placed by
``launch/shardings.py``, of which only rank 0's shards exist, and the
cell's train step, prefill or decode step runs once.  For each cell this
shows that the sharding is coherent (every op finds a placement), what
one device holds at its peak, and the roofline terms.

  * On the card (the default): rank 0's shards are CUDA tensors and the
    step runs on the card; the peak is ``torch.cuda.max_memory_allocated``.
  * ``--device meta``: the same step on ``meta`` tensors on the CPU (no
    data, no kernel); memory is then the argument bytes alone.

The fake group completes every collective without moving data, so a
collective's output is left unwritten and the rank's values mean
nothing: the dry-run prints none, and nothing in the program branches on
a value.  Counts are read from the ops rank 0 runs (``_RankCounter``):

  * ``flops``: per-device FLOPs, from ``torch.utils.flop_counter``'s
    formulas applied to the *local* ops (the shapes of rank 0's shards).
    ``FlopCounterMode`` around DTensor code counts the global op, which
    would overstate a device's work by up to the device count;
  * ``collective_bytes``: result bytes of the collectives rank 0 launches,
    by the reference's kind names, with the top ops;
  * ``op_bytes``: input plus output bytes of every local op that is not
    a view.  It stands in for the reference's ``hlo_bytes`` (XLA's
    "bytes accessed" after fusion) and is an **unfused upper bound**:
    eager PyTorch moves each intermediate through memory, which a fused
    program need not.

Roofline constants: one NVIDIA H100 SXM 80GB's data-sheet peaks (dense,
no sparsity, at 700 W), in place of the reference's TPU v5e constants.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k \\
      --mesh single [--device meta] [--out artifacts/dryrun_torch]
  python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs N]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional

# H100 SXM 80GB data-sheet peaks (per card).
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s per direction

# torch.ops._c10d_functional collectives -> the reference's HLO kinds.
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# torch dtype names -> HLO's.
_HLO_DTYPE = {"float64": "f64", "float32": "f32", "bfloat16": "bf16",
              "float16": "f16", "int64": "s64", "int32": "s32",
              "int16": "s16", "int8": "s8", "uint8": "u8", "bool": "pred"}


def collective_bytes(records, top_k: int = 12):
    """Sum result bytes of every collective in ``records``, each
    ``(kind, dtype, shapes, nbytes)`` with ``dtype`` an HLO name and
    ``shapes`` a list of result shapes.

    Returns (per-kind totals, top-k largest individual collectives with
    shapes), as the reference's ``collective_bytes`` reads them from the
    partitioned HLO.
    """
    out: Dict[str, int] = {}
    items = []
    for kind, dtype, shapes, nbytes in records:
        out[kind] = out.get(kind, 0) + nbytes
        desc = "".join("[" + ",".join(str(d) for d in s) + "]"
                       for s in shapes)
        items.append((nbytes, f"{kind} {dtype}{desc}"))
    items.sort(key=lambda t: -t[0])
    agg: Dict[str, Any] = {}
    for nb, desc in items:
        if desc in agg:
            agg[desc]["count"] += 1
            agg[desc]["bytes"] += nb
        else:
            agg[desc] = {"count": 1, "bytes": nb}
    top = sorted(agg.items(), key=lambda kv: -kv[1]["bytes"])[:top_k]
    return out, [{"op": k, **v} for k, v in top]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _rank_counter():
    """A ``TorchDispatchMode`` that counts rank 0's local ops (built here:
    the module imports no torch at load)."""
    import torch
    from torch.distributed.tensor import DTensor
    # Private API: TorchDispatchMode (torch.utils._python_dispatch) and,
    # below, torch._ops.OpOverload; checked on torch 2.11 (the card) and
    # 2.13 (the CPU).  The FLOP and byte counts rest on both.
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _RankCounter(TorchDispatchMode):
        """Counts the ops that run on this rank's local tensors.

        Like ``torch.distributed.tensor.debug.CommDebugMode``, it returns
        ``NotImplemented`` for an op on DTensors, so DTensor runs it
        (redistributing, then calling the op on the local shards) and
        those local calls, collectives included, come back through the
        mode with plain tensors.  Ops on other tensor subclasses (the
        fake tensors of DTensor's shape propagation) are not counted."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.op_bytes = 0
            self.n_ops = 0
            self.collectives = []
            self.largest = (0, "")        # the largest local op output

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            # Only plain tensors are rank 0's work: DTensor's sharding
            # propagation runs ops on fake tensors of the global shapes.
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            if any(t is not torch.Tensor for t in types) or any(
                    isinstance(o, torch.Tensor) and type(o) is not
                    torch.Tensor for o in outs) or \
                    not isinstance(func, torch._ops.OpOverload):  # private
                return out
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if func.namespace == "_c10d_functional":
                kind = _KINDS.get(packet.__name__)
                if kind is not None:
                    outs = out if isinstance(out, (list, tuple)) else [out]
                    self.collectives.append((
                        kind, _HLO_DTYPE.get(str(outs[0].dtype)[6:], "f32"),
                        [list(o.shape) for o in outs],
                        sum(_nbytes(o) for o in outs)))
                return out
            if func.is_view:
                return out
            self.n_ops += 1
            for o in outs:
                if isinstance(o, torch.Tensor) and \
                        _nbytes(o) > self.largest[0]:
                    self.largest = (_nbytes(o), f"{func} {list(o.shape)}")
            flat = list(args) + list(kwargs.values()) + outs
            for a in flat:
                if isinstance(a, torch.Tensor):
                    self.op_bytes += _nbytes(a)
                elif isinstance(a, (list, tuple)):
                    self.op_bytes += sum(_nbytes(x) for x in a
                                         if isinstance(x, torch.Tensor))
            return out

    return _RankCounter()


def input_specs(arch: str, shape_name: str):
    """``meta`` tensors standing in for every model input of the cell."""
    import torch

    from ..configs import SHAPES, get_config
    from ..data.pipeline import batch_specs

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return batch_specs(cfg, shape)
    # decode: one new token against a cache of seq_len
    b = shape.global_batch
    if cfg.embed_inputs:
        tok = torch.empty((b, 1, cfg.d_model), dtype=torch.bfloat16,
                          device="meta")
    else:
        tok = torch.empty((b,), dtype=torch.int32, device="meta")
    return {"tokens": tok}


def _abstract_params(cfg):
    import torch

    from ..models import model as MDL
    return MDL.init_params(None, cfg, dtype=torch.bfloat16, device="meta")


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    from ..tree import leaves
    return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x)
               for x in leaves(tree) if hasattr(x, "element_size"))


def build_cell(arch: str, shape_name: str, mesh, *,
               fsdp: Optional[bool] = None, remat: bool = True,
               sp: bool = True, device="cuda"):
    """Rank 0's program for one (arch, shape) cell on ``mesh`` (a
    ``DeviceMesh`` over the fake group): ``(run, args)``, where ``run()``
    takes one step under the sharding env and returns its outputs, and
    ``args`` is the tree of its placed inputs.  ``fsdp`` default: on for
    train, off for prefill/decode, as in the reference."""
    import torch

    from ..configs import SHAPES, get_config
    from ..models import model as MDL
    from ..models.sharding import sharding_env
    from . import shardings as SH

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if fsdp is None:
        fsdp = shape.kind == "train"
    dev = torch.device(device)
    meta = dev.type == "meta"

    def fill(t):                        # finite weights; nothing reads them
        if not meta:
            t.normal_(0.0, 0.02) if t.is_floating_point() else t.zero_()

    params_ab = _abstract_params(cfg)
    pspecs = SH.param_specs(params_ab, cfg, mesh, fsdp=fsdp)
    params = SH.empty_placed(params_ab, pspecs, mesh, dev, fill)
    batch_ab = input_specs(arch, shape_name)

    def zeros(t):
        if not meta:
            t.zero_()

    batch = SH.empty_placed(batch_ab, SH.batch_specs_of(batch_ab, mesh),
                            mesh, dev, zeros)

    if shape.kind == "train":
        from ..train.optimizer import OptState, cosine_schedule
        from ..train.train_step import TrainState, make_train_step
        from ..tree import tree_map
        ospecs = SH.opt_state_specs(pspecs, mesh)
        moments_ab = tree_map(lambda t: torch.empty(
            t.shape, dtype=torch.float32, device="meta"), params_ab)
        m = SH.empty_placed(moments_ab, ospecs.m, mesh, dev, zeros)
        v = SH.empty_placed(moments_ab, ospecs.v, mesh, dev, zeros)
        step0 = torch.zeros((), dtype=torch.int32, device=dev)
        state = TrainState(params, OptState(m, v, step0), (), step0)
        step_fn = make_train_step(cfg, cosine_schedule(3e-4, 100, 10000),
                                  remat=remat, sp=sp)

        def run():
            with sharding_env(mesh):
                return step_fn(state, batch)

        return run, (state, batch)

    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        from ..serve.decode import make_prefill_step
        st_specs = SH.decode_state_specs(cfg, b, mesh)
        prefill_fn = make_prefill_step(cfg, max_len=s, specs=st_specs)

        def run():
            with sharding_env(mesh), torch.no_grad():
                return prefill_fn(params, batch["tokens"])

        return run, (params, batch)

    from ..serve.decode import make_serve_step
    seq_shard = shape_name.startswith("long")
    st_specs = SH.decode_state_specs(cfg, b, mesh, seq_shard=seq_shard)
    with sharding_env(mesh):
        state = MDL.init_decode_state(params, cfg, b, s, specs=st_specs)
    serve_fn = make_serve_step(cfg)

    def run():
        with sharding_env(mesh), torch.no_grad():
            return serve_fn(params, batch["tokens"], state)

    return run, (params, batch, state)


def analyze(counter, mesh, args_bytes: int, out_bytes: int,
            peak_bytes: Optional[int]) -> Dict[str, Any]:
    """Roofline terms + memory of one counted step."""
    n_dev = 1
    for n in mesh.shape:
        n_dev *= int(n)
    coll, coll_top = collective_bytes(counter.collectives)
    coll_total = sum(coll.values())
    # per device: rank 0's local ops, its shards, its collectives
    compute_s = counter.flops / PEAK_FLOPS
    memory_s = counter.op_bytes / HBM_BW
    collective_s = coll_total / LINK_BW
    return {
        "n_devices": n_dev,
        "flops": float(counter.flops),
        "op_bytes": float(counter.op_bytes),
        "collective_bytes": coll,
        "collective_top_ops": coll_top,
        "collective_bytes_total": coll_total,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": max(
            [("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)], key=lambda kv: kv[1])[0],
        "memory_analysis": {
            "argument_bytes": args_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": (None if peak_bytes is None
                           else peak_bytes - args_bytes),
            "peak_bytes": args_bytes if peak_bytes is None else peak_bytes,
        },
        "n_ops": counter.n_ops,
        "largest_op_output": list(counter.largest),
    }


def fake_world(n: int):
    """A fake default process group of ``n`` ranks in which this process
    is rank 0 (collectives complete at once, moving no data)."""
    import torch.distributed as dist
    # Private API: FakeStore (and the "fake" backend it registers) live in
    # torch.testing._internal.distributed.fake_pg.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .mesh import process_group
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry-run starts its own fake group")
    return process_group("fake", n, 0, store=FakeStore())


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[str] = None, *, fsdp=None, remat=True,
             sp=True, attn_opt=False, moe_impl="gspmd",
             tag: str = "", device: str = "cuda") -> Dict[str, Any]:
    """Build and run one cell under a fake group of the mesh's ranks and
    return its record (``status`` "ok" or "error")."""
    import torch

    from ..configs import SHAPES, get_config
    from ..device import resolve_device
    from ..models import layers as LY
    from ..models import moe as MOE
    from .mesh import MULTI_POD, SINGLE_POD, make_production_mesh

    LY.set_attn_opt(attn_opt)
    MOE.set_impl(moe_impl)
    dev = resolve_device(device)
    t0 = time.time()
    shape_of, _ = MULTI_POD if mesh_kind == "multi" else SINGLE_POD
    n = 1
    for x in shape_of:
        n *= x
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": list(shape_of),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "config": {"fsdp": fsdp, "remat": remat, "sp": sp,
                   "attn_opt": attn_opt, "moe_impl": moe_impl}}
    try:
        with fake_world(n):
            mesh = make_production_mesh(
                multi_pod=(mesh_kind == "multi"),
                device_type="cuda" if dev.type == "cuda" else "cpu")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            run, args = build_cell(arch, shape_name, mesh, fsdp=fsdp,
                                   remat=remat, sp=sp, device=dev)
            args_bytes = _local_bytes(args)
            rec["build_s"] = time.time() - t0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            counter = _rank_counter()
            t1 = time.time()
            with counter:
                out = run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                peak = torch.cuda.max_memory_allocated(dev)
            else:
                peak = None
            rec["run_s"] = time.time() - t1
            rec.update(analyze(counter, mesh, args_bytes,
                               _local_bytes(out), peak))
            del out, run, args
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        n_all = cfg.n_params()
        n_active = cfg.n_active_params()
        if shape.kind == "train":
            tokens = shape.global_batch * shape.seq_len
            rec["model_flops"] = 6.0 * n_active * tokens
        else:
            tokens = shape.global_batch * (
                shape.seq_len if shape.kind == "prefill" else 1)
            rec["model_flops"] = 2.0 * n_active * tokens
        rec["n_params"] = n_all
        rec["n_active_params"] = n_active
        if rec["flops"]:
            # flops is per device; model_flops is global
            rec["useful_flops_frac"] = rec["model_flops"] / (
                rec["flops"] * rec["n_devices"])
        rec["status"] = "ok"
    except Exception as e:                 # the record says what failed
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        LY.set_attn_opt(False)
        MOE.set_impl("gspmd")
    rec["total_s"] = time.time() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = os.path.join(out_dir,
                          f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def cells(mesh_kinds) -> list:
    from ..configs import LONG_CONTEXT_OK, SHAPES, list_configs

    out = []
    for arch in list_configs():
        for shape_name in SHAPES:
            if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
                continue  # pure full-attention archs skip 512k decode
            for mk in mesh_kinds:
                out.append((arch, shape_name, mk))
    return out


SUMMARY = ("arch", "shape", "mesh", "status", "device", "flops", "op_bytes",
           "collective_bytes_total", "compute_s", "memory_s",
           "collective_s", "dominant", "useful_flops_frac", "build_s",
           "run_s", "error")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--attn-opt", action="store_true",
                    help="optimized serve-attention sharding")
    ap.add_argument("--moe-impl", default="gspmd", choices=["gspmd", "ep"])
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"],
                    help="run rank 0's shards on the card, or as meta "
                         "tensors on the CPU")
    args = ap.parse_args(argv)
    fsdp = {"auto": None, "on": True, "off": False}[args.fsdp]
    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        todo = cells(mesh_kinds)
        print(f"dry-run: {len(todo)} cells, {args.jobs} workers")
        procs: list = []
        results = []
        while todo or procs:
            while todo and len(procs) < args.jobs:
                arch, shape, mk = todo.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mk,
                       "--out", args.out, "--device", args.device]
                procs.append(((arch, shape, mk), subprocess.Popen(cmd)))
            for item in list(procs):
                (arch, shape, mk), p = item
                if p.poll() is not None:
                    procs.remove(item)
                    results.append(((arch, shape, mk), p.returncode))
                    print(f"  [{len(results)}] {arch} x {shape} x {mk}: "
                          f"rc={p.returncode}", flush=True)
            time.sleep(0.5)
        bad = [r for r in results if r[1] != 0]
        print(f"done: {len(results) - len(bad)} ok, {len(bad)} failed")
        for (arch, shape, mk), rc in bad:
            print(f"  FAILED: {arch} x {shape} x {mk}")
        sys.exit(1 if bad else 0)

    if not (args.arch and args.shape):
        ap.error("--arch/--shape or --all required")
    for mk in mesh_kinds:
        rec = run_cell(args.arch, args.shape, mk, args.out,
                       fsdp=fsdp, remat=not args.no_remat,
                       sp=not args.no_sp, attn_opt=args.attn_opt,
                       moe_impl=args.moe_impl, tag=args.tag,
                       device=args.device)
        print(json.dumps({k: rec.get(k) for k in SUMMARY}, indent=1))
        if rec["status"] != "ok":
            print(rec.get("traceback", ""), file=sys.stderr)
            sys.exit(1)


if __name__ == "__main__":
    main()
