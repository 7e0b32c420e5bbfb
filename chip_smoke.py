#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the sources in this checkout
(B1 ragged fleet update, B2 single-fragment update, B3 dense fleet
update, and the CSR scatter that lays out B1's stream on the card), holds
each against its plain PyTorch version on the card, also
on timed stress cases (a heavy hitter beside uniform keys, a 10^6-packet
row, fractional values; an n = 256 group for B1 and B3; a UnivMon level
row and a §4.4 row of 2^20 packets for B2), then
drives these paths through the user entry points at the paper's §6.1
full-scale setting:

* the fleet window path, cs and cms: ``DiSketchSystem`` +
  ``Replayer.run(system, window=8)`` + ``query_flows(merge="fragment")``
  on the device (B1, its streams laid out by the CSR scatter, whose
  launches are counted too; window 8's staging and scatter held group by
  group to the plain scatter and to ``pack_csr``, and timed); then one
  record of window 8 is touched, which copies that window to the host as
  its row groups, and queried with the default subepoch merge;
* the per-epoch path, cs and cms: ``calibrate_rho_target``, then
  ``DiSketchSystem`` + ``Replayer.run(system)`` epoch by epoch with the
  default ragged layout (B1) and with ``layout="dense"`` (B3), the
  loop-of-kernels baseline ``fleet_update_loop`` on one epoch (B2), and
  ``query_flows`` with the default subepoch merge for DiSketch and DISCO;
* UnivMon (16 levels, 320 level rows) on both: the window-8 replay (B1)
  and ``query_entropy(merge="fragment")`` on the device (the all-levels
  gather/merge and the G-sum); the per-epoch replay (B1), the B2 loop over
  one epoch's level rows, and ``query_entropy`` with both merges for
  DiSketch and the subepoch merge for DISCO;
* ``AggregatedSystem`` for cs, cms and um on the core switches;
* churn and failure recovery: ``Replayer.run(system, window=8,
  failures=...)`` with a quarter of the switches dying at window offset 1
  and returning a window later, beside seeded resource pressure, XOR
  parity groups of 5, dead segments masked to value 0 in B1 and the
  queries under "oblivious", "mask" and "recover" on the device; and the
  per-epoch path under the same schedule (ragged B1, dense B3,
  subepoch-merge queries);
* the versioned control plane (``runtime.control.VersionedControlPlane``):
  ``Replayer.run(plane, window=8)`` for cs over lossless channels, held to
  the window path's plane-free run group by group, and for cs and cms
  over lossy channels (drops, duplicates, reorders), held to twins run at
  the applied configs; then ``Replayer.run(plane, failures=...)`` per
  epoch for cs under the churn schedule over the lossy channels, where
  the resource pressure reaches the switch agents (NACKs, clamps);
* the durable export plane (``runtime.export.DurableExportPlane``):
  ``Replayer.run(plane, window=8)`` for cs over lossy export channels with
  checkpoints and a collector crash after the second window, drained and
  held to the plane-free window run group by group; and for cms with every
  message of one switch dropped, its cells lost and masked exactly;
* the chaos harness (``runtime.chaos.ChaosHarness``) around the control
  plane around the export plane, window 8: for cs over lossless channels,
  held to the plane-free window run group by group; for cs and cms with
  every failure plane armed at once (churn inside a window, resource
  pressure, lossy export with collector crashes, lossy control), its
  invariants machine-checked, every applied cell equal to a twin run at
  the applied configs, B1's churn window held to the plain version;
* the sharded fleet (``DiSketchSystem(..., mesh=make_switch_mesh(4,
  devices=[card] * 4))``, 4 shards of 5 fragments on this card): window 8
  for cs, cms, UnivMon and cs under churn with parity groups of 5, each
  beside its single-device twin, every cell and every query bit for bit
  equal to the twin's, one window's per-shard B1 groups held to the
  plain version, and the bytes of the estimate slices the query gather
  hands to the merge device;
* the sanitizer (``repro_torch.sanitize``, armed by ``REPRO_SANITIZE=1``):
  the cs window-8 query of all 5-hop flows, the UnivMon entropy with the
  device G-sum and the 4-shard cs query, each run once more on its
  resident system under the armed transfer guard (the CUDA sync debug
  mode at "error" and the host-sync dispatch mode) and equal to its
  disarmed answer bit for bit; a host read, an upload and a boolean-mask
  index raising under the guard; and the library-load counter (one load
  of B1's library after ``build.load.cache_clear()``, none in a second
  replay of one window with its query);
* the model serving path (``repro_torch.launch.serve``; torch ops, no
  kernel of its own): every model family at its ``reduced`` size on the
  card held to the port on the CPU with the same weights; gemma2-2b at
  full width and depth (3.2 G f32 parameters drawn on the card) served by
  the continuous-batching server at the reference server's defaults, then
  teacher forcing with an 8192-token prompt past the local window (prefill
  and 32 decode steps == forward); and a 2-layer full-width gemma2-2b held
  to the reference's logits (``SERVE_PIN``);
* the training path (``repro_torch.launch.train``; torch ops and
  autograd, no kernel of its own): that 2-layer model's two f32 train
  steps held to the reference's (``TRAIN_PIN``); every model family at
  ``reduced`` trained on the card, each step held to the same step on the
  CPU, the DiSketch gradient compressor on for a dense and an MoE arch;
  gemma2-2b at full width and depth in bf16 (f32 AdamW moments) for ten
  steps at the reference launcher's defaults, three steps with the
  compressor (D = 3 204 165 888), and a run killed after its step-2
  checkpoint and restarted from it to the uninterrupted run's loss;
* model sharding (``repro_torch.models.sharding``, ``launch/shardings.py``,
  ``launch/dryrun.py``; DTensor, no kernel of its own): the spec tables
  of every arch on both production meshes held to the reference's
  (``SHARDING_PIN``); gemma2-2b at full width on a world-size-1 NCCL
  group and a (1, 1) mesh of this card, serving and a train step held to
  the unsharded runs; and the dry-run of four gemma2-2b cells, rank 0 of
  a fake group of 256 or 512 ranks running its shards on this card.

Each path runs with the kernels' launch counters set to 0 just before it
and read just after, and the script checks that it went through its
kernels, that the dense, ragged and loop counters are bit-identical, and
that the answers are right: the RMSEs and entropies are pinned to the JAX
reference's values at this setting, and so are the control plane's
applied configs, stale epochs and protocol counters, the export
plane's protocol counters and crash report, the chaos harness's
report, crash log and n trajectory, the serving path's logits, the
training path's losses, grad norms and updated weights, and the spec
tables' digests.

It imports nothing of JAX or of the JAX package.  It exits non-zero, and
prints no result, when CUDA is unavailable or the port's sources are
missing.  The last line of its output is the JSON result.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# §6.1 full-scale scenario (benchmarks/common.py::fat_tree_scenario with
# quick=False, memories_for at 128 KB and Gini 0.4).
N_FLOWS, N_PACKETS, N_EPOCHS, LOG2_TE, SEED = 200_000, 2_000_000, 32, 16, 1
BASE_MEM, GINI, WINDOW = 128 * 1024, 0.4, 8
# rho_target per kind: the JAX reference's calibrate_rho_target (median
# probe-epoch PEB at n = 1 on the epoch n_epochs // 2 streams) evaluated
# once on a CPU at exactly this setting (UnivMon with n_levels=16 and the
# network-wide level_seed 7777: 63.30671088217913).
RHO = {"cs": 15.67, "cms": 1.0, "um": 63.31}
N_LEVELS, LEVEL_SEED = 16, 7777
# Answers pinned at this setting, each computed once on a CPU by the JAX
# reference's numpy paths (no Pallas) with the RHO above and the same
# workload, by scripts/reference_pins.py (which also gives RHO["um"]); the
# smoke holds the port to them within PIN_RTOL, and the UnivMon entropies
# of the device plane (f32 merge and G-sum) within PIN_RTOL_F32.
PIN_RTOL, PIN_RTOL_F32 = 1e-6, 1e-5
# RMSE of all 5-hop flows.  Per-epoch: the reference's loop backend
# (DiSketchSystem and DiscoSystem, Replayer.run, query_flows with the
# subepoch and the fragment merge).  Window 8: the reference's
# process_epoch with ns frozen for each window of 8 and Eq. 6 replayed in
# order at its end, then query_window(merge="fragment") per path group.
RMSE_PIN = {
    ("cs", "window 8"): 0.5982554646551216,
    ("cs", "subepoch"): 0.7363271811200329,
    ("cs", "fragment"): 0.5977069010872829,
    ("cs", "disco"): 0.6668421139659481,
    ("cms", "window 8"): 19.071132705491884,
    ("cms", "subepoch"): 1.1747041468698007,
    ("cms", "fragment"): 2.348328296754005,
    ("cms", "disco"): 0.07074468967211545,
}
# The reference's AggregatedSystem (depth 4, each core switch's memory;
# UnivMon with 16 levels), Replayer.run, then query_flows of the 5-hop
# flows at their core switch over the 32 epochs: RMSE.
AGG_RMSE_PIN = {"cs": 22.397749911646983, "cms": 2.0436255854263385,
                "um": 294.4489068656193}
# UnivMon entropy in bits of all 200 000 flows (n_levels 16).  Per-epoch
# control, over the first ENTROPY_EPOCHS epochs: the reference's loop
# backend's query_entropy, subepoch merge with k_heavy 1024 for DiSketch
# and DISCO, and the fragment merge with k_heavy = every key (a cutoff that
# does not bind, so no tie among equal estimates can select other keys
# than the device's stable order).  Window 8: the emulation above for
# UnivMon, um_gsum_window's per-level estimates (merge="fragment") over the
# 32 epochs, combined by um_gsum_combine with k_heavy = every key, and by
# the reference's device G-sum (_um_gsum_jit: lax.top_k, ties to the lower
# index) with the default k_heavy 1024, the cutoff query_entropy uses.
ENTROPY_EPOCHS = 8
ENTROPY_PIN = {
    "disketch subepoch": 10.810002453514972,
    "disco subepoch": 10.884638574135062,
    "disketch fragment": 10.880950946975236,
    "window 8 fragment": 11.471188325072735,
    "window 8 fragment k_heavy 1024": 11.503352649492847,
}
# Churn (scripts/reference_pins.py churn): churn_schedule() below, parity
# groups of PARITY_GROUP switches in fleet order.  Window 8 (cs, cms): the
# reference's parts emulating its fleet window path (process_epoch at the
# frozen ns and widths, dead cells empty, lost cells zeroed after their
# PEBs, its apply_event for the control, query_window(merge="fragment")),
# RMSE of all 5-hop flows over the 32 epochs under each policy.  Per-epoch
# cs: the reference's loop backend under the same schedule, subepoch-merge
# RMSE of the 5-hop flows over CHURN_EPOCHS (their packets there).  The n
# trajectories are pinned as n_log_digest()s.
CHURN_EPOCHS, PARITY_GROUP = range(16, 24), 5
CHURN_PIN = {
    ("cs", "oblivious"): 37.43235679684199,
    ("cs", "mask"): 11.66974402178167,
    ("cs", "recover"): 10.94064944676658,
    ("cms", "oblivious"): 103.1156095381902,
    ("cms", "mask"): 16.18123888670383,
    ("cms", "recover"): 16.180349005444622,
    ("cs", "epoch mask"): 12.36910451608781,
    ("cs", "epoch oblivious"): 12.36910451608781,
    ("cs", "records mask"): 10.976916944787426,
    ("cs", "records oblivious"): 22.212454599080143,
}
CHURN_N_LOG_PIN = {"window cs": "c14bdbb7a67aabb1",
                   "window cms": "862325a8be1631df",
                   "epoch cs": "ec9b915777a938a0"}
# the victims (dead in epochs 17 to 24), the cells lost at the death and
# those parity can rebuild (one victim alone in its group)
CHURN_DEAD = (17, 25, [1, 3, 4, 12, 19])
CHURN_LOST = {16: [1, 3, 4, 12, 19]}
CHURN_RECOVERABLE = {16: [12, 19]}
# The sharded phase: the window-8 runs on a mesh of N_SHARDS shards of
# 5 fragments, all on this card (launch.mesh.make_switch_mesh(devices=)),
# each held bit for bit to its single-device twin.
N_SHARDS = 4
# The versioned control plane (scripts/reference_pins.py control): the
# reference's VersionedControlPlane around its loop backend over the lossy
# channels of lossy_ctrl() below, with run_window called on it directly for
# the windows of 8 (its loop backend then runs a window's epochs at frozen
# ns and the plane walks the window's PEBs once, as the fleet window does),
# and its Replayer.run per epoch under churn_schedule().  "applied" is the
# n_log_digest() of applied_log, "clamps" the json_digest() of clamp_log,
# "stats" the plane's stats() after the replay (it holds no times),
# "stale" stale_epochs(), "stale_config" the last_observability stamp of
# the query, "rmse" the RMSE of all 5-hop flows: over the 32 epochs with
# merge="fragment" for the windows, over CHURN_EPOCHS with the subepoch
# merge under failures="mask" per epoch.  "window cs lossless" runs over
# the default (lossless) channels.
CONTROL_PIN = {
    "window cs lossless": dict(
        applied="6528876c9888783e", stale=[],
        stats={"now": 8, "n_directives": 8, "n_acks_rx": 12,
               "n_stale_acks": 0, "n_nacks_tx": 0, "n_outstanding": 2,
               "n_stale_epochs": 0, "n_clamps": 0, "max_version_lag": 1,
               "channel": {"n_sent": 16, "n_dropped": 0, "n_dup": 0,
                           "n_delivered": 14, "pending": 2},
               "ack_channel": {"n_sent": 14, "n_dropped": 0, "n_dup": 0,
                               "n_delivered": 12, "pending": 2}},
        rmse=0.5982554646551216),
    "window cs": dict(
        applied="00c00434313f5533", stale=list(range(8, 32)),
        stats={"now": 8, "n_directives": 5, "n_acks_rx": 6,
               "n_stale_acks": 1, "n_nacks_tx": 0, "n_outstanding": 2,
               "n_stale_epochs": 24, "n_clamps": 0, "max_version_lag": 1,
               "channel": {"n_sent": 13, "n_dropped": 3, "n_dup": 3,
                           "n_delivered": 10, "pending": 3},
               "ack_channel": {"n_sent": 10, "n_dropped": 3, "n_dup": 1,
                               "n_delivered": 6, "pending": 2}},
        rmse=0.5927259015359663),
    "window cms": dict(
        applied="ec5aa5f81658095e",
        stale=list(range(8, 16)) + list(range(24, 32)),
        stats={"now": 8, "n_directives": 2, "n_acks_rx": 2,
               "n_stale_acks": 1, "n_nacks_tx": 0, "n_outstanding": 1,
               "n_stale_epochs": 16, "n_clamps": 0, "max_version_lag": 1,
               "channel": {"n_sent": 6, "n_dropped": 1, "n_dup": 1,
                           "n_delivered": 5, "pending": 1},
               "ack_channel": {"n_sent": 5, "n_dropped": 2, "n_dup": 1,
                               "n_delivered": 2, "pending": 2}},
        rmse=18.615486215943204),
    "epoch cs": dict(
        applied="2d671fd55f5be7d8", clamps="9cf958636110fcc1", n_clamps=41,
        stale=list(range(1, 18)) + list(range(19, 32)),
        stale_config=[16, 17, 19, 20, 21, 22, 23],
        stats={"now": 64, "n_directives": 184, "n_acks_rx": 619,
               "n_stale_acks": 136, "n_nacks_tx": 335, "n_outstanding": 14,
               "n_stale_epochs": 30, "n_clamps": 41, "max_version_lag": 2,
               "channel": {"n_sent": 433, "n_dropped": 173, "n_dup": 52,
                           "n_delivered": 304, "pending": 8},
               "ack_channel": {"n_sent": 639, "n_dropped": 126,
                               "n_dup": 113, "n_delivered": 619,
                               "pending": 7}},
        rmse=14.060080943950874),
}
# The durable export plane (scripts/reference_pins.py export): the
# reference's DurableExportPlane around its loop backend, run_window called
# on it window by window, over lossy_export()'s channels.  cs: max_retries
# 12, a checkpoint every EXPORT_CKPT_EVERY rounds (2 kept), EXPORT_STEPS
# rounds after each window dispatch, a collector crash after the window
# from EXPORT_CRASH_AFTER, then drain(); "crash" is the crash() report
# with its "restaged" cells as their json_digest() and count, "stats" the
# plane's stats() after the drain, "checkpoints" the checkpoints taken.
# cms: every message of switch EXPORT_VICTIM dropped, max_retries 2;
# "drop stats" its stats() after the drain.  The protocol depends only on
# which cells were staged and when, so the fleet's plane must match.
EXPORT_STEPS, EXPORT_CKPT_EVERY, EXPORT_CRASH_AFTER = 8, 10, 8
EXPORT_VICTIM = 16
EXPORT_PIN = {
    "crash": {"restored_step": 1, "lost_inflight": 76, "dropped_cells": 316,
              "restored_cells": 185, "n_restaged": 135,
              "restaged": "6a55b35e98ec4a8e"},
    "stats": {"now": 52, "n_tx": 2370, "n_rx": 1926, "n_dup_rx": 319,
              "n_applied": 640, "n_pending": 0, "n_lost": 0, "n_crashes": 1,
              "channel": {"n_sent": 2370, "n_dropped": 737, "n_dup": 326,
                          "n_delivered": 1926, "pending": 0},
              "ack_channel": {"n_sent": 1926, "n_dropped": 290,
                              "n_dup": 315, "n_delivered": 1908,
                              "pending": 0}},
    "checkpoints": 5,
    "drop stats": {"now": 32, "n_tx": 1312, "n_rx": 1216, "n_dup_rx": 0,
                   "n_applied": 608, "n_pending": 0, "n_lost": 32,
                   "n_crashes": 0,
                   "channel": {"n_sent": 1312, "n_dropped": 96, "n_dup": 0,
                               "n_delivered": 1216, "pending": 0},
                   "ack_channel": {"n_sent": 1216, "n_dropped": 0,
                                   "n_dup": 0, "n_delivered": 1216,
                                   "pending": 0}},
}
# The chaos harness (scripts/reference_pins.py chaos): the reference's
# ChaosHarness around its VersionedControlPlane around its
# DurableExportPlane (max_retries CHAOS_MAX_RETRIES, no checkpoints) around
# ChurnWindowEmulation(export=True), the reference's fleet window path
# rebuilt from its parts, with its dead and lost cells kept out of the
# staging as the fleet keeps them; driven window by window (windows of 8).
# "lossless cs": lossless channels, no schedule, 4 export rounds after each
# dispatch.  "cs", "cms": churn_schedule(), lossy_ctrl() and lossy_export(),
# CHAOS_STEPS rounds after each dispatch and a collector crash every
# CHAOS_CRASH_EVERY dispatches.  "report" is finish()'s (JSON), "crash_log"
# the json_digest() of the crash() reports, "n_log" the n_log_digest() of
# the system's n trajectory, "rmse" the RMSE of all 5-hop flows over the
# 32 epochs, merge="fragment", failures="mask".
CHAOS_STEPS, CHAOS_CRASH_EVERY, CHAOS_MAX_RETRIES = 6, 2, 12
_CHAOS_LOSSY_EXPORT = {
    "now": 87, "n_tx": 4639, "n_rx": 3652, "n_dup_rx": 601,
    "n_applied": 595, "n_pending": 0, "n_lost": 0, "n_crashes": 2,
    "channel": {"n_sent": 4639, "n_dropped": 1466, "n_dup": 642,
                "n_delivered": 3652, "pending": 0},
    "ack_channel": {"n_sent": 3652, "n_dropped": 556, "n_dup": 597,
                    "n_delivered": 3479, "pending": 0}}
CHAOS_PIN = {
    "lossless cs": dict(
        report={"dispatches": 4, "staged": 640, "crashes": 0,
                "applied": 640, "lost": [],
                "export": {"now": 16, "n_tx": 1280, "n_rx": 1280,
                           "n_dup_rx": 0, "n_applied": 640, "n_pending": 0,
                           "n_lost": 0, "n_crashes": 0,
                           "channel": {"n_sent": 1280, "n_dropped": 0,
                                       "n_dup": 0, "n_delivered": 1280,
                                       "pending": 0},
                           "ack_channel": {"n_sent": 1280, "n_dropped": 0,
                                           "n_dup": 0, "n_delivered": 1280,
                                           "pending": 0}},
                "stale_epochs": [], "n_stale_epochs": 0, "n_directives": 8,
                "n_clamps": 0, "max_version_lag": 0},
        crash_log="4f53cda18c2baa0c", n_log="c9e56bf890338dab",
        rmse=0.5982554646551216),
    "cs": dict(
        report={"dispatches": 4, "staged": 595, "crashes": 2,
                "applied": 595, "lost": [], "export": _CHAOS_LOSSY_EXPORT,
                "stale_epochs": list(range(8, 32)), "n_stale_epochs": 24,
                "n_directives": 36, "n_clamps": 8, "max_version_lag": 0},
        crash_log="4cc4ac0a3908e1ec", n_log="e84d04b74f78e1db",
        rmse=8.221146033576748),
    "cms": dict(
        report={"dispatches": 4, "staged": 595, "crashes": 2,
                "applied": 595, "lost": [], "export": _CHAOS_LOSSY_EXPORT,
                "stale_epochs": list(range(8, 32)), "n_stale_epochs": 24,
                "n_directives": 35, "n_clamps": 10, "max_version_lag": 0},
        crash_log="4cc4ac0a3908e1ec", n_log="a0d93445e27d0ab8",
        rmse=14.368594442549064),
}
# The serve phase: the model serving path (repro_torch.launch.serve) at
# the full width of gemma2-2b (26 layers, d_model 2304, vocab 256 000,
# ~3.2 G f32 parameters, 12.8 GB), at the reference server's defaults
# (launch/serve.py: 16 requests, a batch of 4, prompts of 32, 32 new
# tokens, caches of 128); then teacher forcing with a prompt longer than
# the local window (4096), so the band mask cuts: prefill of SERVE_TF
# tokens == forward, SERVE_TF_STEPS decode steps == forward at their
# positions, within tests/test_models.py's 2e-4 and 3e-4.
SERVE_ARCH, SERVE_REQUESTS, SERVE_BATCH = "gemma2-2b", 16, 4
TRAIN_ARCH = SERVE_ARCH
SERVE_PROMPT_LEN, SERVE_MAX_NEW, SERVE_MAX_LEN = 32, 32, 128
SERVE_TF, SERVE_TF_STEPS = 8192, 32
# SERVE_PIN (scripts/reference_pins.py serve): the reference's prefill of a
# SERVE_PROMPT-token prompt (numpy default_rng(SERVE_SEED + 1)) through
# gemma2-2b at full width cut to SERVE_LAYERS layers, f32 weights drawn by
# init_params from numpy default_rng(SERVE_SEED); the last position's top-8
# ids, and their logits to SERVE_PIN_RTOL.
SERVE_LAYERS, SERVE_SEED, SERVE_PROMPT = 2, 11, 16
SERVE_PIN = {"ids": [120291, 195470, 74226, 183713, 68896, 99161, 243920,
                     1679],
             "logits": [4.926590919494629, 4.651458263397217,
                        4.583889484405518, 4.520737648010254,
                        4.445533752441406, 4.242554187774658,
                        4.128481864929199, 4.020838737487793]}
SERVE_PIN_RTOL = 1e-4
# The training path (the train phase).  (a) every arch at ``reduced``,
# TRAIN_A_STEPS steps at batch 2 x 32, card == CPU, the compressor on for
# TRAIN_A_COMPRESS; (b) full-width gemma2-2b through launch/train.py::train
# at the reference launcher's defaults (TRAIN_FULL; its last step
# profiled), then TRAIN_COMPRESS (batch cut to 2 x 512: the residual and
# the sketch need 13.6 GB more; two steps, one a subepoch), then a run
# killed after step TRAIN_RESTART_AT, checkpointed there by its cadence
# (one 32 GB checkpoint: the card's machine takes ~45 GiB of disk writes
# a run), and its restart.
TRAIN_A_STEPS, TRAIN_A_COMPRESS = 3, ("granite-8b", "olmoe-1b-7b")
TRAIN_FULL = dict(steps=10, batch=8, seq=512, lr=3e-4, schedule="cosine")
TRAIN_COMPRESS = dict(TRAIN_FULL, steps=2, batch=2, compress=True)
TRAIN_RESTART_AT = 2
# H100 SXM dense bf16 tensor-core peak, FLOP/s (NVIDIA data sheet, at
# 700 W): the share of it is 6 N tokens / time, N every parameter.
BF16_PEAK = 989e12
# TRAIN_PIN (scripts/reference_pins.py train): SERVE_PIN's 2-layer
# full-width gemma2-2b and f32 weights, TRAIN_STEPS steps of the
# reference's jitted train step (remat on, no compressor) on
# SyntheticLM(seed=TRAIN_SEED) batches of TRAIN_BATCH x TRAIN_SEQ, cosine
# schedule over TRAIN_STEPS steps at TRAIN_LR; each step's loss and grad
# norm, and final_norm after the steps at TRAIN_NORM_AT, its L2 norm and
# its AdamW moment m at TRAIN_NORM_AT.  Losses, grad norms and final_norm
# are held to TRAIN_PIN_RTOL; m, linear in the gradients, to
# TRAIN_PIN_M_RTOL (L2 over the sampled entries), which must also fail
# the same steps run with TF32 matmuls (the control).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED, TRAIN_LR = 2, 1, 64, 5, 3e-4
TRAIN_NORM_AT = tuple(range(0, 2304, 144))
TRAIN_PIN = {"loss": [12.95075798034668, 12.204660415649414],
             "grad_norm": [20.976839065551758, 20.607784271240234],
             "final_norm": [
                 -0.00046202001976780593, -0.00022345576144289225,
                 -0.00035227692569606006, -0.0004262249276507646,
                 0.0004495115135796368, -0.00042992038652300835,
                 0.000463123491499573, -0.00044377363519743085,
                 -0.0004610978940036148, 0.0004349738883320242,
                 -0.0004623459535650909, 0.0004649473412428051,
                 -0.0004126355051994324, 0.00032589028705842793,
                 0.0004567954165395349, 0.00042517040856182575],
             "final_norm_l2": 0.018617669760620122,
             "m": [
                 6.383368599927053e-05, -1.1554468983376864e-05,
                 1.3327062333701178e-05, 8.235851964855101e-06,
                 -1.7222491806023754e-05, 1.632757266634144e-05,
                 -2.504756957932841e-05, 1.4792236470384523e-05,
                 3.3765496482374147e-05, -1.709364732960239e-05,
                 2.2258634999161586e-05, -1.305070509260986e-05,
                 1.3489181583281606e-05, -3.3777016597014153e-06,
                 -3.686601485242136e-05, -4.029227056889795e-05]}
TRAIN_PIN_RTOL = 1e-5
# m's limit lies between the f32 steps' reading on an H100 (1.18e-5) and
# the TF32 control's (1.04e-3).
TRAIN_PIN_M_RTOL = 1e-4
# The sharding phase: (a) the port's spec tables of every arch on both
# production meshes (launch/shardings.py::spec_tables) held to
# SHARDING_PIN, the reference's own tables' digests (scripts/
# reference_pins.py sharding, from AbstractMesh); (b) full-width gemma2-2b
# on a world-size-1 NCCL group and a (1, 1) ("data", "model") mesh of the
# card, sharded against unsharded from the same weights: a prefill of
# SHARD_SERVE (f32, FSDP off) and SHARD_DECODE greedy decode steps (the
# tokens equal, the logits within the serve phase's 2e-4), one bf16
# train step at SHARD_TRAIN (remat, sp, FSDP on; loss and grad norm
# SHARD_TRAIN_RTOL, the parameters by the train phase's rule); (c) the
# dry-run (launch/dryrun.py::run_cell) of SHARD_CELLS on the card, each
# cell's useful_flops_frac inside the band PERF.md predicted from a
# --device meta run before the first chip call.
SHARDING_PIN = {
    "codeqwen1.5-7b single": "cc2e14a220dbfee8",
    "codeqwen1.5-7b multi": "50c15afc577a9291",
    "deepseek-moe-16b single": "124838248af0b6d9",
    "deepseek-moe-16b multi": "0b4bf3a2b71a0d4e",
    "falcon-mamba-7b single": "03dad54dac8aeb82",
    "falcon-mamba-7b multi": "4f80afbed1fb84c7",
    "gemma2-2b single": "2cdb8888d32e8021",
    "gemma2-2b multi": "23b953c881c071c7",
    "granite-8b single": "5813714c27e09df0",
    "granite-8b multi": "7d107ecaf44b6170",
    "internvl2-76b single": "8cad8352cdcd8b06",
    "internvl2-76b multi": "6d882b2dad939d7a",
    "minicpm-2b single": "b4d43a2fe0dfd6a9",
    "minicpm-2b multi": "7802efd7e5debba4",
    "musicgen-medium single": "06b794d8e7223407",
    "musicgen-medium multi": "5bbf82412249b246",
    "olmoe-1b-7b single": "24bbe48949d63cfd",
    "olmoe-1b-7b multi": "50dffccac0741b07",
    "zamba2-2.7b single": "5ea4b8cdc4aab6a2",
    "zamba2-2.7b multi": "8bbc52445ab446a9"}
SHARD_SERVE, SHARD_DECODE = (4, 32), 8
SHARD_TRAIN = (8, 512)
SHARD_TRAIN_RTOL = 1e-5
# (shape, mesh) -> the useful_flops_frac band predicted in PERF.md
SHARD_CELLS = {("train_4k", "single"): (0.90, 0.96),
               ("prefill_32k", "single"): (0.50, 0.55),
               ("decode_32k", "single"): (0.05, 0.06),
               ("train_4k", "multi"): (0.90, 0.96)}
HBM_CARD = 80e9
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor-core
# 32-bit operations/s (the kernel's hashing is uint32 integer work).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# uint32 operations per (packet, level) pair the kernel cannot avoid:
# column hash (avalanche + seeding + limb product, 17), subepoch hash
# (11), sign hash (11), packet subepoch and compare (4), level test (3).
OPS_PER_PAIR = 46


def _log(msg: str) -> None:
    print(msg, flush=True)


def _pinned(what: str, got: float, want: float, rtol: float) -> None:
    """Fail unless ``got`` is the pinned reference value to ``rtol``."""
    rel = abs(got - want) / abs(want)
    if not rel <= rtol:
        raise AssertionError(f"{what}: {got!r} against the reference's "
                             f"{want!r} (relative {rel:.3g} > {rtol})")


def _phase(fn, *args):
    """Run one phase of the smoke and log its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    _log(f"phase   {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: its launches (a kernel's zero fill
    and kernel) captured once in a CUDA graph and the graph replayed
    between CUDA events, so the host's launch path (Python, ctypes, the
    allocator) is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = _time_ms(graph.replay, reps=reps)
    del graph
    return ms


def _packet_bytes(n_slots: int, n_live: int) -> int:
    """Bytes an update kernel must read from a packet array: every slot's
    value (4 B), and the key and timestamp (8 B) of live packets only, as
    the kernels skip value-0 padding once its value is read."""
    return 4 * n_slots + 8 * n_live


def _profiled(fn, name: str):
    """One call of ``fn`` (after one warm-up call) under torch.profiler:
    ``(wall ms, device ms of the kernels whose name holds name, their
    launches)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3
    ks = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    return (wall_ms, sum(e.self_device_time_total for e in ks) / 1e3,
            sum(e.count for e in ks))


def _counters():
    """The launch counters of the port's three kernel wrappers."""
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.kernels.sketch_update import ops

    return {"fleet_ragged": FK.fleet_update_ragged,
            "sketch_update": ops.sketch_update,
            "fleet_dense": FK.fleet_update}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _random_csr(rng, n_prow, n_levels, n_sub_choices, widths, blk=256,
                log2_te=LOG2_TE, mean_pkts=20_000):
    """A random ragged CSR case: Zipf segment lengths with empty rows,
    random seeds, per-row n_sub/width, random full 32-bit ts words."""
    from repro_torch.kernels.sketch_update import fleet as FK

    lens = np.minimum(rng.zipf(1.5, n_prow) * (mean_pkts // 4),
                      20 * mean_pkts)
    lens[rng.random(n_prow) < 0.2] = 0
    nblk = np.maximum(1, -(-lens // blk))
    nb = int(nblk.sum())
    keys = rng.integers(0, 2 ** 32, nb * blk, dtype=np.uint64
                        ).astype(np.uint32)
    ts = rng.integers(0, 2 ** 32, nb * blk, dtype=np.uint64).astype(np.uint32)
    vals = np.zeros(nb * blk, np.float32)
    starts = np.concatenate([[0], np.cumsum(nblk)]) * blk
    for r in range(n_prow):
        vals[starts[r]:starts[r] + lens[r]] = rng.integers(1, 4, lens[r])
    block_frag = np.repeat(np.arange(n_prow, dtype=np.int32), nblk)
    rows = n_prow * n_levels
    params = np.zeros((rows, FK.N_PARAMS), np.int32)
    params[:, :3] = rng.integers(0, 2 ** 31, (rows, 3))
    n_sub = np.repeat(rng.choice(n_sub_choices, n_prow), n_levels)
    params[:, FK.PARAM_WIDTH] = np.repeat(rng.choice(widths, n_prow),
                                          n_levels)
    params[:, FK.PARAM_N_SUB] = n_sub
    params[:, FK.PARAM_LOG2_N_SUB] = np.log2(n_sub).astype(np.int32)
    params[:, FK.PARAM_LEVEL] = np.tile(np.arange(n_levels), n_prow)
    params[:, FK.PARAM_MIT] = rng.random(rows) < 0.5
    return (keys, vals, ts, params, block_frag), dict(
        n_sub_max=int(n_sub.max()),
        width_max=int(params[:, FK.PARAM_WIDTH].max()), blk=blk,
        log2_te=log2_te, n_levels=n_levels)


def _to_device(args, dev):
    """Kernel inputs as the wrapper's device tensors (uint32 words as
    int32 bit patterns)."""
    import torch

    keys, vals, ts, params, block_frag = args
    return (torch.from_numpy(keys.view(np.int32).copy()).to(dev),
            torch.from_numpy(vals).to(dev),
            torch.from_numpy(ts.view(np.int32).copy()).to(dev),
            torch.from_numpy(params).to(dev),
            torch.from_numpy(block_frag).to(dev))


def _stress_rows(rng):
    """The stress cases of B1 and B3 (B2 takes the single-row ones), as
    ``{name: (per-row key arrays, widths, n_sub)}``.  A heavy hitter (one
    key on half of a 2^20-packet row: its counter is an exact integer near
    10^6, below 2^24) and a row of uniform keys of the same size, timed
    side by side for the atomics' same-address contention; a single row
    of ~10^6 Zipf(1.1) keys as in the trace (the old one-CTA-per-row
    grid's worst case); a window-shaped n = 256 group (16 narrow rows of ~15 000 packets); and
    a row of 2^16 packets on 16 keys with fractional values
    (``_stress_values``), whose adds to one counter are not integers."""
    n = 1 << 20

    def uniform(m):
        return rng.integers(0, 2 ** 32, m, dtype=np.uint64).astype(np.uint32)

    heavy = uniform(n)
    heavy[rng.random(n) < 0.5] = np.uint32(0x9E3779B9)
    zipf = ((rng.zipf(1.1, 1_000_003) % N_FLOWS).astype(np.uint32)
            * np.uint32(2654435761))
    return {
        "heavy hitter": ([heavy], [123974], 1),
        "uniform keys": ([uniform(n)], [123974], 1),
        "long row 1e6": ([zipf], [123974], 1),
        "n=256 group": ([uniform(int(m)) for m in
                         rng.integers(10_000, 20_000, 16)],
                        [3728, 7748] * 8, 256),
        "fractional values": ([uniform(16)[rng.integers(0, 16, 1 << 16)]],
                              [3728], 1),
    }


def _stress_values(rng, name, m):
    """A stress row's packet values: 1 to 3, or for the fractional case
    multiples of 1/4 up to 7/4 (dyadic, so every sum is exact in f32 in any
    order and the kernels must still equal their plain versions)."""
    if name == "fractional values":
        return rng.integers(1, 8, m) / 4
    return rng.integers(1, 4, m)


def _stress_params(rng, widths, n_sub):
    from repro_torch.kernels.sketch_update import fleet as FK

    params = np.zeros((len(widths), FK.N_PARAMS), np.int32)
    params[:, :3] = rng.integers(0, 2 ** 31, (len(widths), 3))
    params[:, FK.PARAM_WIDTH] = widths
    params[:, FK.PARAM_N_SUB] = n_sub
    params[:, FK.PARAM_LOG2_N_SUB] = int(n_sub).bit_length() - 1
    return params


def _stress_timing(name, kernel, plain, targs, kw, times):
    """Hold a stress case to its plain version (``torch.equal``) and time
    the kernel's device work on it (``_graph_ms``)."""
    import torch

    got, want = kernel(*targs, **kw), plain(*targs, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{kernel.__name__} differs from its plain "
                             f"version on case {name!r}")
    times[name] = _graph_ms(lambda: kernel(*targs, **kw))
    peak = float(want.abs().max())
    del got, want
    return err, peak


def kernel_phase(dev) -> float:
    """The update kernel against its plain version on the card: skewed and
    empty rows, widths up to 262144, n_sub 1..64, UnivMon with 16 levels,
    §4.4 mitigation, and the stress cases of ``_stress_rows``, which are
    also timed.  Returns the largest absolute difference (0 when
    equal)."""
    import torch

    from repro_torch.kernels.sketch_update import fleet as FK

    rng = np.random.default_rng(7)
    cases = [
        ("cs wide", True, False, dict(
            n_prow=24, n_levels=1, n_sub_choices=[1, 2, 4, 8],
            widths=[3728, 65536, 65537, 123974, 262144])),
        ("cms n_sub<=64", False, False, dict(
            n_prow=32, n_levels=1, n_sub_choices=[1, 2, 16, 32, 64],
            widths=[1000, 8335, 33815])),
        ("cs mitigation", True, True, dict(
            n_prow=20, n_levels=1, n_sub_choices=[1, 2, 4, 16],
            widths=[3728, 26102, 72248])),
        ("um 16 levels + mitigation", True, True, dict(
            n_prow=10, n_levels=16, n_sub_choices=[1, 2, 4, 8],
            widths=[233, 1638, 7748])),
    ]
    worst = 0.0
    for name, signed, mit, spec in cases:
        args, kw = _random_csr(rng, **spec)
        targs = _to_device(args, dev)
        got = FK.fleet_update_ragged(*targs, signed=signed,
                                     with_mitigation=mit, **kw)
        plain = FK.fleet_update_ragged_ref(*targs, signed=signed,
                                           with_mitigation=mit, **kw)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max()) if got.numel() else 0.0
        worst = max(worst, err)
        ok = torch.equal(got, plain)
        _log(f"kernel  fleet_ragged  {name:28s} rows={args[3].shape[0]:4d} "
             f"packets={int((args[1] != 0).sum()):8d} "
             f"out={tuple(got.shape)} equal={ok} max_abs_err={err}")
        if not ok:
            raise AssertionError(f"fleet_ragged differs from its plain "
                                 f"version on case {name!r}")
    times = {}
    for name, (row_keys, widths, n_sub) in _stress_rows(rng).items():
        blk = 256
        nblk = [-(-len(k) // blk) for k in row_keys]
        keys = np.zeros(sum(nblk) * blk, np.uint32)
        vals = np.zeros(len(keys), np.float32)
        offs = np.concatenate([[0], np.cumsum(nblk)]) * blk
        for r, k in enumerate(row_keys):
            keys[offs[r]:offs[r] + len(k)] = k
            vals[offs[r]:offs[r] + len(k)] = _stress_values(rng, name,
                                                            len(k))
        ts = rng.integers(0, 2 ** 32, len(keys), dtype=np.uint64
                          ).astype(np.uint32)
        block_frag = np.repeat(np.arange(len(row_keys), dtype=np.int32),
                               nblk)
        params = _stress_params(rng, widths, n_sub)
        kw = dict(n_sub_max=n_sub, width_max=max(widths), log2_te=LOG2_TE,
                  signed=True, blk=blk, n_levels=1, with_mitigation=False)
        err, peak = _stress_timing(
            name, FK._launch, FK.fleet_update_ragged_ref,
            _to_device((keys, vals, ts, params, block_frag), dev), kw, times)
        worst = max(worst, err)
        _log(f"kernel  fleet_ragged  {name:28s} rows={len(row_keys):4d} "
             f"packets={int((vals != 0).sum()):8d} largest |counter| "
             f"{peak} equal=True max_abs_err={err} kernel "
             f"{times[name]:.4f} ms")
    _log(f"kernel  fleet_ragged  heavy hitter / uniform keys: "
         f"{times['heavy hitter'] / times['uniform keys']:.3f}")
    return worst


def _b2_stress_rows(rng, dev):
    """B2's stress rows on the card, ``{name: ((keys, vals, ts), ops._launch
    keywords)}``: the single-row cases of ``_stress_rows``, a UnivMon
    level-3 row and a §4.4 row of 2^20 uniform keys; each padded with
    value-0 packets to a multiple of 256, random full 32-bit ts words."""
    rows = {name: (row_keys[0], widths[0], 1, 0, False)
            for name, (row_keys, widths, _) in _stress_rows(rng).items()
            if len(row_keys) == 1}
    n = 1 << 20
    uniform = rng.integers(0, 2 ** 32, (2, n), dtype=np.uint64
                           ).astype(np.uint32)
    rows["um level 3 row"] = (uniform[0], 7748, 4, 3, False)
    rows["§4.4 row"] = (uniform[1], 26102, 16, 0, True)
    out = {}
    for name, (keys, width, n_sub, level, mit) in rows.items():
        p = -(-len(keys) // 256) * 256
        vals = np.zeros(p, np.float32)
        vals[:len(keys)] = _stress_values(rng, name, len(keys))
        ts = rng.integers(0, 2 ** 32, p, dtype=np.uint64).astype(np.uint32)
        targs = _to_device((np.pad(keys, (0, p - len(keys))), vals, ts,
                            np.zeros(0, np.int32), np.zeros(0, np.int32)),
                           dev)[:3]
        out[name] = targs, dict(width=width, n_sub=n_sub, log2_te=LOG2_TE,
                                col_seed=int(rng.integers(2 ** 31)),
                                sign_seed=int(rng.integers(2 ** 31)),
                                sub_seed=int(rng.integers(2 ** 31)),
                                signed=True, level=level, mitigation=mit)
    return out


def kernel_phase_single(dev) -> float:
    """B2 against its plain version on the card: widths up to 262144
    (above the 65536 hash wrap), n_sub 1..256, cs and cms, a UnivMon level
    row and a §4.4 row, packet counts that are not blk multiples; then
    the single-row stress cases of ``_stress_rows`` and a level row and a
    §4.4 row of 2^20 packets, each also timed."""
    import torch

    from repro_torch.kernels.sketch_update import ops
    from repro_torch.kernels.sketch_update.ref import sketch_update_ref

    rng = np.random.default_rng(11)
    cases = [  # width, n_sub, level, mitigation, signed, packets
        (123974, 1, 0, False, True, 300_001),
        (262144, 8, 0, False, True, 200_003),
        (65537, 32, 0, False, False, 100_019),
        (3728, 256, 0, False, False, 150_000),
        (7748, 4, 3, False, True, 90_007),
        (26102, 16, 0, True, True, 120_011),
        (1000, 2, 0, False, True, 777),
    ]
    worst = 0.0
    for width, n_sub, level, mit, signed, n in cases:
        keys = (rng.zipf(1.3, n) % 50_000).astype(np.uint32) \
            * np.uint32(2654435761)
        ts = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
        vals = rng.integers(1, 4, n).astype(np.float32)
        kw = dict(width=width, n_sub=n_sub, log2_te=LOG2_TE,
                  col_seed=int(rng.integers(2 ** 31)),
                  sign_seed=int(rng.integers(2 ** 31)),
                  sub_seed=int(rng.integers(2 ** 31)), level=level,
                  mitigation=mit, signed=signed, device=dev)
        got = ops.sketch_update(keys, vals, ts, **kw)
        plain = ops.sketch_update(keys, vals, ts, backend="ref", **kw)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        worst = max(worst, err)
        ok = torch.equal(got, plain)
        _log(f"kernel  sketch_update width={width:6d} n_sub={n_sub:3d} "
             f"level={level} mit={int(mit)} signed={int(signed)} "
             f"packets={n:6d} equal={ok} max_abs_err={err}")
        if not ok:
            raise AssertionError(f"sketch_update differs from its plain "
                                 f"version at width={width} n_sub={n_sub}")
    times = {}
    for name, (targs, kw) in _b2_stress_rows(rng, dev).items():
        err, peak = _stress_timing(name, ops._launch, sketch_update_ref,
                                   targs, kw, times)
        worst = max(worst, err)
        _log(f"kernel  sketch_update {name:28s} width={kw['width']:6d} "
             f"n_sub={kw['n_sub']:3d} packets="
             f"{int((targs[1] != 0).sum()):8d} "
             f"largest |counter| {peak} equal=True max_abs_err={err} "
             f"kernel {times[name]:.4f} ms")
    _log(f"kernel  sketch_update heavy hitter / uniform keys: "
         f"{times['heavy hitter'] / times['uniform keys']:.3f}")
    return worst


def kernel_phase_dense(dev) -> float:
    """B3 against its plain version on the card: random rectangles with
    heterogeneous widths (one above 65536) and n_sub, empty rows, and the
    stress cases of ``_stress_rows``, which are also timed."""
    import torch

    from repro_torch.kernels.sketch_update import fleet as FK

    rng = np.random.default_rng(13)
    worst = 0.0
    for signed, n_frags, p_max, n_choices in ((True, 20, 32768, [1, 2, 8]),
                                              (False, 16, 8192,
                                               [1, 4, 64, 256])):
        keys = rng.integers(0, 2 ** 32, (n_frags, p_max),
                            dtype=np.uint64).astype(np.uint32)
        ts = rng.integers(0, 2 ** 32, (n_frags, p_max),
                          dtype=np.uint64).astype(np.uint32)
        lens = rng.integers(0, p_max, n_frags)
        lens[0] = 0
        vals = ((np.arange(p_max)[None, :] < lens[:, None])
                * rng.integers(1, 4, (n_frags, p_max))).astype(np.float32)
        params = np.zeros((n_frags, FK.N_PARAMS), np.int32)
        params[:, :3] = rng.integers(0, 2 ** 31, (n_frags, 3))
        n_sub = rng.choice(n_choices, n_frags)
        params[:, FK.PARAM_WIDTH] = rng.choice(
            [233, 3728, 33815, 70001, 123974], n_frags)
        params[:, FK.PARAM_N_SUB] = n_sub
        params[:, FK.PARAM_LOG2_N_SUB] = np.log2(n_sub).astype(np.int32)
        kw = dict(n_sub_max=int(n_sub.max()),
                  width_max=int(params[:, FK.PARAM_WIDTH].max()),
                  log2_te=LOG2_TE, signed=signed)
        targs = _to_device((keys, vals, ts, params,
                            np.zeros(0, np.int32)), dev)[:4]
        got = FK.fleet_update(*targs, **kw)
        plain = FK.fleet_update_ref(*targs, **kw)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        worst = max(worst, err)
        ok = torch.equal(got, plain)
        _log(f"kernel  fleet_dense   {'cs' if signed else 'cms':3s} "
             f"{n_frags}x{p_max} n_sub {sorted(set(n_sub.tolist()))} "
             f"out={tuple(got.shape)} equal={ok} max_abs_err={err}")
        if not ok:
            raise AssertionError("fleet_dense differs from its plain version")
        del got, plain
    times = {}
    for name, (row_keys, widths, n_sub) in _stress_rows(rng).items():
        p_max = -(-max(len(k) for k in row_keys) // 256) * 256
        keys = np.zeros((len(row_keys), p_max), np.uint32)
        vals = np.zeros(keys.shape, np.float32)
        for r, k in enumerate(row_keys):
            keys[r, :len(k)] = k
            vals[r, :len(k)] = _stress_values(rng, name, len(k))
        ts = rng.integers(0, 2 ** 32, keys.shape, dtype=np.uint64
                          ).astype(np.uint32)
        params = _stress_params(rng, widths, n_sub)
        kw = dict(n_sub_max=n_sub, width_max=max(widths), log2_te=LOG2_TE,
                  signed=True)
        err, peak = _stress_timing(
            name, FK._launch_dense, FK.fleet_update_ref,
            _to_device((keys, vals, ts, params, np.zeros(0, np.int32)),
                       dev)[:4], kw, times)
        worst = max(worst, err)
        _log(f"kernel  fleet_dense   {name:28s} {len(row_keys)}x{p_max} "
             f"packets={int((vals != 0).sum()):8d} largest |counter| "
             f"{peak} equal=True max_abs_err={err} kernel "
             f"{times[name]:.4f} ms")
    _log(f"kernel  fleet_dense   heavy hitter / uniform keys: "
         f"{times['heavy hitter'] / times['uniform keys']:.3f}")
    return worst


def _window_packets(fleet, rep, e0, n_epochs=WINDOW, dead_at=None,
                    fold=True):
    """The epochs of the window from ``e0``, their parameter rows and their
    ``FleetPacket``s (the segments of the switches dead in an epoch masked
    to value 0): folded by the host (``fold_packet_flags``), or, without
    ``fold``, raw, as the fleet runner stages them for a card's scatter."""
    from repro_torch.core.fleet import fold_packet_flags, mask_fragment_values

    es = [e for e in range(e0, e0 + n_epochs) if e in fleet._params_log]
    params = np.concatenate([fleet._params_log[e] for e in es])
    pos = {sw: i for i, sw in enumerate(fleet.frag_order)}
    packets = [mask_fragment_values(
        rep.epoch_packet(e, fleet.frag_order),
        sorted(pos[sw] for sw in (dead_at or {}).get(e, ()))) for e in es]
    if fold:
        packets = [fold_packet_flags(
            p, fleet.log2_te, n_levels=fleet.n_levels,
            level_seed=fleet.level_seed, mitigation=fleet.mitigation)
            for p in packets]
    return es, params, packets


def csr_scatter_window(fleet, rep, e0, dev, groups, timed=False):
    """The CSR scatter at window ``e0``'s row groups (a fleet on one card),
    staged as ``core.fleet.csr_streams`` stages them: the window's raw
    packets (``stage_packets``, page-locked) and each n_sub group's tables
    (``csr_row_tables``) uploaded, then each group's stream from
    ``FK.csr_scatter`` and from its plain version ``FK.csr_scatter_ref``
    on the same device tensors, with the fleet's fold (``log2_te``,
    ``n_levels``, ``level_seed``: a UnivMon fleet's scatter folds each
    key's level into its ts), equal (``torch.equal``), and equal to the
    ``pack_csr`` stream of the host-folded packets of the same group in
    ``groups`` (``_window_groups``).

    Returns ``(max_abs_err, timing)``; ``timing`` (None unless ``timed``)
    as ``kernel_timing``'s: the eager ``ms`` and the ``device_ms`` of the
    window's scatter launches, the plain version's ``plain_ms``, and
    ``bound_ms`` for the bytes the scatter must move at HBM bandwidth (12 B
    read per live packet, 12 B written per slot, and its tables; the fold
    moves no byte more); besides, ``upload_ms``, the page-locked copy of
    the staging to the card (CUDA events), its ``upload_mb``, and
    ``folded``, the live packets whose level the scatter folded."""
    import torch

    from repro_torch.core.fleet import csr_row_tables, stage_packets
    from repro_torch.kernels.sketch_update import fleet as FK

    assert fleet._shard_frag_bounds is None, "one card's groups only"
    assert not fleet.mitigation, "§4.4's flag is folded on the host"
    _, params, packets = _window_packets(fleet, rep, e0, fold=False)
    n_frags, L, blk = len(fleet.frag_order), fleet.n_levels, fleet.blk
    fold = dict(log2_te=fleet.log2_te, n_levels=L,
                level_seed=fleet.level_seed)
    nsub_f = params[:n_frags * L:L, FK.PARAM_N_SUB]
    idxs = [np.flatnonzero(nsub_f == n) for n in np.unique(nsub_f)]
    assert len(idxs) == len(groups), (len(idxs), len(groups))
    staged = stage_packets(packets, pin=True)
    d = staged.to(dev, non_blocking=True)
    keys, vals, ts = d[0], d[1].view(torch.float32), d[2]
    tables, err, n_bytes, n_live = [], 0.0, 0, 0
    for idx, (args, _) in zip(idxs, groups):
        rows, bf = csr_row_tables(packets, idx, blk)
        np.testing.assert_array_equal(bf, args[4])
        tab = (torch.from_numpy(rows).to(dev),
               torch.from_numpy(bf.astype(np.int64)).to(dev))
        got = FK.csr_scatter(keys, vals, ts, *tab, blk=blk, **fold)
        plain = FK.csr_scatter_ref(keys, vals, ts, *tab, blk=blk, **fold)
        packed = _to_device(args, dev)[:3]
        for g, want, host in zip(got, plain, packed):
            err = max(err, float((g.double() - want.double()).abs().max()))
            assert torch.equal(g, want), "csr_scatter != its plain version"
            assert torch.equal(g, host), "csr_scatter != pack_csr"
        tables.append(tab)
        n_live += int(rows[1].sum())
        n_bytes += (12 * int(rows[1].sum()) + 12 * len(bf) * blk
                    + rows.nbytes + 8 * len(bf))
        del got, plain, packed
    if not timed:
        return err, None

    def scatter(tab):
        return FK.csr_scatter(keys, vals, ts, *tab, blk=blk, **fold)

    def run():
        for tab in tables:
            scatter(tab)

    timing = dict(
        ms=sum(_time_ms(lambda t=t: scatter(t)) for t in tables),
        device_ms=_graph_ms(run),
        plain_ms=sum(_time_ms(lambda t=t: FK.csr_scatter_ref(
            keys, vals, ts, *t, blk=blk, **fold), reps=3, warmup=1)
            for t in tables),
        bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S, bound_by="bytes",
        groups=len(tables),
        upload_ms=_time_ms(lambda: staged.to(dev, non_blocking=True)),
        upload_mb=staged.nbytes / 1e6, folded=n_live if L > 1 else 0)
    return err, timing


def _window_groups(fleet, rep, e0, n_epochs=WINDOW, dead_at=None):
    """The grouped launches of the ``n_epochs`` epochs from ``e0`` (a
    window, or one epoch of the per-epoch path) exactly as the fleet
    runner makes them: ``[(args, kw)]`` per distinct n_sub (of each shard,
    shard by shard, on a mesh), the segments of the switches dead in an
    epoch (``dead_at``: {epoch: switches}) masked to value 0."""
    from repro_torch.core.fleet import pack_csr
    from repro_torch.kernels.sketch_update import fleet as FK

    es, params, packets = _window_packets(fleet, rep, e0, n_epochs, dead_at)
    n_frags, L = len(fleet.frag_order), fleet.n_levels
    nsub_f = params[:n_frags * L:L, FK.PARAM_N_SUB]
    width_f = params[:n_frags * L:L, FK.PARAM_WIDTH]
    groups = []
    for lo, hi in fleet._shard_frag_bounds or [(0, n_frags)]:
        for n in np.unique(nsub_f[lo:hi]):
            idx = lo + np.flatnonzero(nsub_f[lo:hi] == n)
            rows = ((np.arange(len(es))[:, None] * n_frags + idx[None, :])
                    .ravel()[:, None] * L + np.arange(L)[None, :]).ravel()
            keys, vals, ts, bf = pack_csr([p.select(idx) for p in packets],
                                          fleet.blk)
            groups.append(((keys, vals, ts, params[rows], bf), dict(
                n_sub_max=int(n), width_max=int(width_f[idx].max()),
                log2_te=fleet.log2_te, signed=fleet.kind in ("cs", "um"),
                blk=fleet.blk, n_levels=L,
                with_mitigation=fleet.mitigation)))
    return groups


def _smallest_path(fleet, e0, paths):
    """The path whose rows span the least ``n_sub x width`` in window
    ``e0``, and a host copy of just its rows (every level's, for UnivMon,
    fragment-major): ``(path, (E, len, S, W) array, row indices)``."""
    groups = fleet._window_bufs[e0][0].device()
    where = {int(r): (c, j) for rows, c in groups for j, r in enumerate(rows)}
    L = fleet.n_levels
    pos = {sw: i * L for i, sw in enumerate(fleet.frag_order)}

    def span(path):
        cs = [where[pos[sw]][0] for sw in path]
        return max(c.shape[2] for c in cs) * max(c.shape[3] for c in cs)

    path = min(sorted(set(paths)), key=span)
    rows = np.array([pos[sw] + l for sw in path for l in range(L)])
    parts = [where[r][0][:, where[r][1]] for r in rows]
    dense = np.zeros((parts[0].shape[0], len(rows),
                      max(p.shape[1] for p in parts),
                      max(p.shape[2] for p in parts)), np.float32)
    for i, p in enumerate(parts):
        dense[:, i, :p.shape[1], :p.shape[2]] = p.cpu().numpy()
    return path, dense, rows


def build_scenario() -> dict:
    """The §6.1 workload, its replayer and the per-switch memories, shared
    by both paths (data made anew from the seeds in every run)."""
    from repro_torch.net.simulator import Replayer
    from repro_torch.net.topology import FatTree
    from repro_torch.net.traffic import gen_workload, gini_memories

    t0 = time.perf_counter()
    topo = FatTree(4)
    wl = gen_workload(topo, n_flows=N_FLOWS, total_packets=N_PACKETS,
                      n_epochs=N_EPOCHS, log2_te=LOG2_TE, burstiness=0.2,
                      seed=SEED)
    rep = Replayer(wl, topo.n_switches)
    mems = gini_memories(topo.n_switches, BASE_MEM, GINI,
                         np.random.RandomState(SEED + 100))
    mems = {sw: int(m) for sw, m in enumerate(mems)}
    widths = [m // 4 for m in mems.values()]
    events = sum(len(st.keys) for e in range(N_EPOCHS)
                 for st in rep.epoch_stream(e).values())
    _log(f"main    workload: FatTree(4) {topo.n_switches} switches, "
         f"{len(wl.keys)} flows, {len(wl.pkt_ts)} packets, {N_EPOCHS} "
         f"epochs, {events} packet-switch events ({events / N_EPOCHS:.0f} "
         f"per epoch), widths {min(widths)}..{max(widths)}; built in "
         f"{time.perf_counter() - t0:.1f} s")
    sel = wl.path_len == 5
    return dict(wl=wl, rep=rep, mems=mems, events=events,
                keys=wl.keys[sel], truth=wl.sizes[sel],
                paths=[p for p, s in zip(wl.paths, sel) if s], guarded=[])


def main_path(dev, sc):
    """The fleet window path at the §6.1 setting, cs then cms.  Returns a
    dict of what the kernel line needs."""
    import torch

    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.core.query import fleet_query_window, path_groups
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.net.simulator import rmse

    rep, mems, events = sc["rep"], sc["mems"], sc["events"]
    keys, truth, paths = sc["keys"], sc["truth"], sc["paths"]
    epochs = list(range(N_EPOCHS))
    n_windows = -(-N_EPOCHS // WINDOW)
    result = {"launches": 0, "max_abs_err": 0.0, "scatter_launches": 0,
              "scatter_err": 0.0}
    for kind in ("cs", "cms"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        system = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                                log2_te=LOG2_TE)
        fleet = system.fleet
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_counts()
        FK.csr_scatter.launches = 0
        h0 = time.perf_counter()
        start.record()
        rep.run(system, window=WINDOW)          # <- the window path
        end.record()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - h0
        counts = read_counts()
        launches = counts["fleet_ragged"]
        scatters = FK.csr_scatter.launches
        assert counts["sketch_update"] == counts["fleet_dense"] == 0, counts
        # one card: each B1 launch's stream laid out by one scatter
        assert scatters == launches, (scatters, launches)
        result["launches"] += launches
        result["scatter_launches"] += scatters
        window_ms = start.elapsed_time(end) / n_windows
        expected = sum(len(np.unique(fleet._params_log[e0][:, FK.PARAM_N_SUB]))
                       for e0 in range(0, N_EPOCHS, WINDOW))
        assert launches > 0, "the main path launched no kernel"
        assert launches == expected, (launches, expected)
        bufs = list({id(b): b for b, _ in fleet._window_bufs.values()
                     }.values())
        assert all(b.resident and b._host is None
                   and all(c.is_cuda for _, c in b.device())
                   for b in bufs), "a window stack left the device"
        stack_bytes = sum(c.numel() * 4 for b in bufs for _, c in b.device())
        shapes = [[tuple(c.shape) for _, c in b.device()] for b in bufs]

        # one window's counters against the plain version on the card,
        # group by group (the runner keeps them as these groups)
        e0 = WINDOW
        buf = fleet._window_bufs[e0][0]
        groups = _window_groups(fleet, rep, e0)
        err = 0.0
        plain_host = []
        for (args, kw), (_, got) in zip(groups, buf.device()):
            plain = FK.fleet_update_ragged_ref(*_to_device(args, dev), **kw)
            got = got.reshape(plain.shape)
            err = max(err, float((got - plain).abs().max()))
            assert torch.equal(got, plain), f"{kind}: window stack != plain"
            if kind == "cs":            # for the host copy's check below
                plain_host.append(plain.cpu().numpy())
            del plain
        result["max_abs_err"] = max(result["max_abs_err"], err)
        # ... and window 8's CSR scatter against its plain version and
        # pack_csr, on the same staging (timed for cs)
        s_err, s_timing = csr_scatter_window(fleet, rep, e0, dev, groups,
                                             timed=kind == "cs")
        result["scatter_err"] = max(result["scatter_err"], s_err)
        if s_timing:
            result["scatter_timing"] = s_timing

        # queries: all 5-hop flows over the 32 epochs, on the device
        q0 = time.perf_counter()
        est = system.query_flows(keys, paths, epochs, merge="fragment")
        torch.cuda.synchronize()
        q_s = time.perf_counter() - q0
        assert est.shape == keys.shape and np.isfinite(est).all()
        err_rmse = rmse(est, truth)
        _pinned(f"{kind} window 8 RMSE", err_rmse, RMSE_PIN[(kind, "window 8")],
                PIN_RTOL)
        if kind == "cs":
            _guarded(sc, f"cs window {WINDOW}: query_flows(merge='fragment') "
                     f"of {len(keys)} 5-hop flows", est, q_s,
                     lambda: system.query_flows(keys, paths, epochs,
                                                merge="fragment"),
                     lambda e: _pinned("guarded cs window 8 RMSE",
                                       rmse(e, truth),
                                       RMSE_PIN[("cs", "window 8")],
                                       PIN_RTOL))
        # ... and, per window, the path group whose rows are the smallest
        # against the numpy oracle on a host copy of just those rows (the
        # buffers themselves stay resident)
        for w0 in range(0, N_EPOCHS, WINDOW):
            es = list(range(w0, min(w0 + WINDOW, N_EPOCHS)))
            path, dense, rows = _smallest_path(fleet, w0, paths)
            kk = keys[[p == path for p in paths]]
            host_est = fleet_query_window(
                list(dense), [fleet._params_log[e][rows] for e in es], None,
                kk, kind)
            np.testing.assert_allclose(fleet.window_query(es, kk, path=path),
                                       host_est, rtol=1e-6, atol=1e-6)
        assert all(b._host is None for b in bufs)
        peak = torch.cuda.max_memory_allocated()
        n_by_window = [sorted(set(fleet._params_log[w0][:, FK.PARAM_N_SUB]
                                  .tolist()))
                       for w0 in range(0, N_EPOCHS, WINDOW)]
        _log(f"main    {kind}: rho_target={RHO[kind]} launches={launches} "
             f"(grouped launches expected {expected}; CSR scatter "
             f"launches {scatters}, window {e0}'s == plain version and "
             f"pack_csr, max_abs_err {s_err}) window={WINDOW} "
             f"update {window_ms:.2f} ms/window (CUDA events; "
             f"{events / (window_ms * n_windows / 1e3):.4g} packet-switch "
             f"events/s; host {run_s:.2f} s total) stack {stack_bytes} B "
             f"on device in {len(bufs)} windows, peak device memory "
             f"{peak} B; n_sub per window {n_by_window}; group shapes "
             f"{shapes}; window {e0} counters == plain version (max_abs_err "
             f"{err}); query of {len(keys)} 5-hop flows {q_s:.2f} s, RMSE "
             f"{err_rmse!r} (the reference's, pinned); device == host "
             f"oracle in every window; window stacks never copied to the "
             f"host")
        if kind == "cs":
            result["timing"] = kernel_timing(
                _window_groups(system.fleet, rep, WINDOW), dev)
            # for the control and export phases: this plane-free run's
            # groups, before the host copy below releases window 8's
            result["cs_groups"] = [
                [(rows, c.cpu()) for rows, c in
                 fleet._window_bufs[w0][0].device()]
                for w0 in range(0, N_EPOCHS, WINDOW)]
            result["cs_n_log"] = list(system.n_log)
            host_copy(system, keys, paths, plain_host)
        del system, fleet, bufs, buf, plain_host
    profile_replay(mems, rep)
    return result


def host_copy(system, keys, paths, plain_host):
    """The record plane on a replayed window: touch one record
    of window 8, which copies that window to the host as its row groups;
    check the copy against the plain version's counters (``plain_host``,
    one array per group) and that every record is a view of its group;
    query the window with the default subepoch merge; and hold the fleet's
    host query branch, which reads the groups, to the device answer it
    gave before the copy."""
    fleet = system.fleet
    buf = fleet._window_bufs[WINDOW][0]
    es = list(range(WINDOW, 2 * WINDOW))
    path, _, _ = _smallest_path(fleet, WINDOW, paths)
    kk = keys[[p == path for p in paths]]
    before = fleet.window_query(es, kk, path=path)
    group_bytes = sum(c.numel() * 8 for _, c in buf.device())
    padded_bytes = int(np.prod(buf._shape)) * 8
    h0 = time.perf_counter()
    system.records[WINDOW][fleet.frag_order[0]]   # <- touches one record
    copy_s = time.perf_counter() - h0
    assert not buf.resident and buf.host_bytes == group_bytes
    for (_, c), p in zip(buf.host(), plain_host):
        assert np.array_equal(c, p.reshape(c.shape).astype(np.int64)), \
            "host copy != plain version"
    for e in es:
        for sw in fleet.frag_order:
            assert any(np.shares_memory(system.records[e][sw].counters, c)
                       for _, c in buf.host()), "a record is not a view"
    n_q = min(4096, len(keys))
    q0 = time.perf_counter()
    est = system.query_flows(keys[:n_q], paths[:n_q], es)   # subepoch merge
    q_s = time.perf_counter() - q0
    assert est.shape == (n_q,) and np.isfinite(est).all()
    np.testing.assert_allclose(fleet.window_query(es, kk, path=path), before,
                               rtol=1e-6, atol=1e-6)
    _log(f"c5      cs window {WINDOW}: touching one record copied the window "
         f"to the host as {len(buf.host())} row groups, {buf.host_bytes} B "
         f"int64 (the padded (E, R, n_sub_max, width_max) copy "
         f"{buf._shape}: {padded_bytes} B) in {copy_s:.3f} s; copy == the "
         f"plain version; records are views of their groups; subepoch-merge "
         f"query of {n_q} 5-hop flows over epochs {es[0]}-{es[-1]} "
         f"{q_s:.2f} s; host window_query == the device's before the copy")


def _n_trajectory(n_log):
    """How many fragments run at each subepoch count, epoch by epoch, with
    runs of equal epochs merged: ``e0-e1 {n: fragments}``."""
    runs = []
    for e, ns in enumerate(n_log):
        hist = dict(sorted(zip(*np.unique(list(ns.values()),
                                          return_counts=True))))
        hist = {int(k): int(v) for k, v in hist.items()}
        if runs and runs[-1][2] == hist:
            runs[-1][1] = e
        else:
            runs.append([e, e, hist])
    return "; ".join(f"{a}-{b} {h}" for a, b, h in runs)


def _epoch_ns(system, e):
    """The ``ns`` that epoch ``e`` ran at (Eq. 6 after epoch e - 1)."""
    return system.n_log[e - 1] if e else {sw: 1 for sw in system.ns}


def _replay(rep, system, window=1, failures=None):
    """``Replayer.run(system)`` with the launch counters reset just
    before and read just after; returns (counts, host s, device ms)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    h0 = time.perf_counter()
    start.record()
    rep.run(system, window=window, failures=failures)   # <- the path
    end.record()
    torch.cuda.synchronize()
    return read_counts(), time.perf_counter() - h0, start.elapsed_time(end)


def _sampled_epoch(system, rep, dev):
    """The epoch of a per-epoch replay of ``system`` that ran the most
    subepochs (the earliest on a tie), as the B2 loop and B3 take it:
    ``(epoch, packet, dense rectangle, parameter table, kernel keywords,
    rectangle and table on the card)``."""
    from repro_torch.core.fleet import build_params

    fleet = system.fleet
    e = max(range(N_EPOCHS),
            key=lambda e: (max(_epoch_ns(system, e).values()), -e))
    ns = _epoch_ns(system, e)
    params = build_params(fleet.fragments, e, ns, fleet.frag_order)
    packet = rep.epoch_packet(e, fleet.frag_order)
    rect = packet.densify(fleet.blk)
    kw = dict(n_sub_max=max(ns.values()), width_max=int(fleet.widths.max()),
              log2_te=LOG2_TE, signed=fleet.kind == "cs")
    trect = _to_device(rect + (params, np.zeros(0, np.int32)), dev)[:4]
    return e, packet, rect, params, kw, trect


def epoch_path(dev, sc):
    """The per-epoch path at the §6.1 setting, cs then cms: calibration,
    the ragged (B1) and dense (B3) replays, the B2 loop on the epoch with
    the most subepochs, and subepoch-merge queries for DiSketch and
    DISCO.  Returns what the kernel line needs."""
    import torch

    from repro_torch.core.disketch import (DiscoSystem, DiSketchSystem,
                                           calibrate_rho_target)
    from repro_torch.core.fleet import dispatch_ragged_grouped
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.net.simulator import rmse

    rep, mems, events = sc["rep"], sc["mems"], sc["events"]
    keys, truth, paths = sc["keys"], sc["truth"], sc["paths"]
    epochs = list(range(N_EPOCHS))
    res = {"ragged": 0, "dense": 0, "loop": 0, "max_abs_err": 0.0}
    for kind in ("cs", "cms"):
        c0 = time.perf_counter()
        rho = calibrate_rho_target(mems, kind,
                                   rep.epoch_stream(N_EPOCHS // 2), LOG2_TE)
        assert abs(rho - RHO[kind]) <= 0.005, (kind, rho, RHO[kind])
        _log(f"epoch   {kind}: calibrate_rho_target = {rho!r} (the "
             f"reference's {RHO[kind]} to its rounding) in "
             f"{time.perf_counter() - c0:.2f} s")

        # ragged (B1); keep_stacked keeps each epoch's groups on the card
        # so the device query plane can be held to the record plane below
        torch.cuda.reset_peak_memory_stats()
        system = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                                log2_te=LOG2_TE,
                                fleet_kwargs={"keep_stacked": True})
        counts, host_s, dev_ms = _replay(rep, system)
        peak = torch.cuda.max_memory_allocated()
        expected = sum(len(set(_epoch_ns(system, e).values()))
                       for e in epochs)
        assert counts["fleet_ragged"] == expected > 0, (counts, expected)
        assert counts["fleet_dense"] == counts["sketch_update"] == 0, counts
        res["ragged"] += counts["fleet_ragged"]
        _log(f"epoch   {kind} ragged: launches {counts} (expected "
             f"{expected}: one per distinct n per epoch); update "
             f"{dev_ms / N_EPOCHS:.3f} ms/epoch on the device timeline "
             f"(CUDA events; {events / (dev_ms / 1e3):.4g} packet-switch "
             f"events/s), host {host_s:.2f} s for {N_EPOCHS} epochs; peak "
             f"device memory {peak} B")
        _log(f"epoch   {kind} n after each epoch (epochs: {{n: "
             f"fragments}}): {_n_trajectory(system.n_log)}")

        # dense (B3): records and n trajectory bit-identical to ragged
        torch.cuda.reset_peak_memory_stats()
        dense = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                               log2_te=LOG2_TE,
                               fleet_kwargs={"layout": "dense"})
        counts_d, host_d, dev_ms_d = _replay(rep, dense)
        peak_d = torch.cuda.max_memory_allocated()
        assert counts_d["fleet_dense"] == N_EPOCHS, counts_d
        assert counts_d["fleet_ragged"] == counts_d["sketch_update"] == 0
        res["dense"] += counts_d["fleet_dense"]
        assert dense.n_log == system.n_log, "dense n trajectory != ragged"
        for e in epochs:
            for sw in mems:
                a, b = dense.records[e][sw], system.records[e][sw]
                assert a.n == b.n and np.array_equal(a.counters, b.counters), \
                    f"{kind}: dense record ({e}, {sw}) != ragged"
        assert not dense.fleet._window_bufs
        _log(f"epoch   {kind} dense: launches {counts_d}; update "
             f"{dev_ms_d / N_EPOCHS:.3f} ms/epoch on the device timeline, "
             f"host {host_d:.2f} s; peak device memory {peak_d} B; records "
             f"and n trajectory == ragged in all {N_EPOCHS} epochs")

        # B2 loop on the epoch with the most subepochs
        e_star, packet, rect, params, kw, trect = _sampled_epoch(
            system, rep, dev)
        fleet = system.fleet
        reset_counts()
        loop = FK.fleet_update_loop(*trect, device=dev, **kw)  # <- B2 path
        torch.cuda.synchronize()
        counts_l = read_counts()
        assert counts_l["sketch_update"] == len(params) > 0, counts_l
        assert counts_l["fleet_ragged"] == counts_l["fleet_dense"] == 0
        res["loop"] += counts_l["sketch_update"]
        b3 = FK.fleet_update(*trect, **kw)
        plain = FK.fleet_update_ref(*trect, **kw)
        loop_plain = FK.fleet_update_loop(*trect, backend="ref", device=dev,
                                          **kw)
        torch.cuda.synchronize()
        err = max(float((loop - loop_plain).abs().max()),
                  float((b3 - plain).abs().max()))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        assert torch.equal(loop, loop_plain), "B2 loop != its plain version"
        assert torch.equal(b3, plain), "B3 != its plain version"
        assert torch.equal(loop, b3), "B2 loop != B3 on the sampled epoch"
        groups = dispatch_ragged_grouped(params, [packet], log2_te=LOG2_TE,
                                         signed=kind == "cs", blk=fleet.blk,
                                         device=dev)
        for rows, c in groups:
            idx = torch.as_tensor(rows, device=dev)
            part = b3[idx, :c.shape[2], :c.shape[3]]
            assert torch.equal(c[0], part), "B1 groups != B3 on the epoch"
        for i, sw in enumerate(fleet.frag_order):
            rec = system.records[e_star][sw]
            assert np.array_equal(
                rec.counters, loop[i, :rec.n, :rec.counters.shape[1]]
                .cpu().numpy().astype(np.int64)), "record != B2 loop"
        res.setdefault("timing", {})[kind] = dict(
            epoch=e_star, trect=trect, kw=kw, params=params,
            live=int((rect[1] != 0).sum()),
            ragged=_window_groups(fleet, rep, e_star, n_epochs=1))
        _log(f"epoch   {kind} B2 loop on epoch {e_star} (n_sub_max "
             f"{kw['n_sub_max']}, {len(params)} rows, rectangle "
             f"{rect[0].shape}): launches {counts_l}; == its plain version, "
             f"== B3 (== its plain version), == the {len(groups)} grouped "
             f"B1 launches, == the ragged run's records")
        del loop, loop_plain, b3, plain, groups

        # queries: the subepoch merge on the records, for DiSketch and DISCO
        q0 = time.perf_counter()
        est = system.query_flows(keys, paths, epochs)
        q_s = time.perf_counter() - q0
        assert est.shape == keys.shape and np.isfinite(est).all()
        # the fragment merge on the device (each epoch is a one-epoch
        # window there), held to the record plane
        q1 = time.perf_counter()
        frag_dev = system.query_flows(keys, paths, epochs, merge="fragment")
        q_dev = time.perf_counter() - q1
        assert system.fleet.has_device_window(epochs)
        frag_rec = dense.query_flows(keys, paths, epochs, merge="fragment")
        np.testing.assert_allclose(frag_dev, frag_rec, rtol=1e-6, atol=1e-6)
        disco = DiscoSystem(mems, kind, rho_target=RHO[kind],
                            log2_te=LOG2_TE)
        counts_o, host_o, _ = _replay(rep, disco)
        assert counts_o["fleet_ragged"] == N_EPOCHS, counts_o
        res["ragged"] += counts_o["fleet_ragged"]
        q1 = time.perf_counter()
        est_o = disco.query_flows(keys, paths, epochs)
        q_o = time.perf_counter() - q1
        assert est_o.shape == keys.shape and np.isfinite(est_o).all()
        for merge, got in (("subepoch", est), ("fragment", frag_dev),
                           ("disco", est_o)):
            _pinned(f"{kind} per-epoch {merge} RMSE", rmse(got, truth),
                    RMSE_PIN[(kind, merge)], PIN_RTOL)
        _log(f"epoch   {kind} queries (all {len(keys)} 5-hop flows, "
             f"{N_EPOCHS} epochs, subepoch merge): DiSketch RMSE {rmse(est, truth):.4f} in "
             f"{q_s:.2f} s; DISCO RMSE {rmse(est_o, truth):.4f} in "
             f"{q_o:.2f} s (DISCO replay {host_o:.2f} s, launches "
             f"{counts_o}); fragment merge: RMSE {rmse(frag_dev, truth):.4f}"
             f" on the device in {q_dev:.2f} s == the record plane (1e-6); "
             f"all three RMSEs the reference's (pinned)")
        del system, dense, disco, fleet
        torch.cuda.empty_cache()
    profile_replay(mems, rep, window=1)
    return res


def _gsum_stable_f64(ests, lvl, k_heavy=1024):
    """The top-down G-sum of ``core.query.um_gsum_combine`` for the entropy
    ``g``, in float64, selecting as the device does: the ``k_heavy``
    largest estimates with ties broken by the lower index (the host
    combine's ``np.argsort`` is not stable)."""
    y = 0.0
    top = ests.shape[0] - 1
    for l in range(top, -1, -1):
        idx = np.flatnonzero(lvl >= l)
        est = np.maximum(ests[l, idx], 1.0)
        order = np.argsort(-est, kind="stable")[:k_heavy]
        gv = est[order] * np.log2(est[order])
        in_next = (lvl[idx][order] >= l + 1).astype(np.float64)
        y = float(gv.sum()) if l == top else \
            2.0 * y + float(((1.0 - 2.0 * in_next) * gv).sum())
    return y


def univmon_window(dev, sc):
    """UnivMon on the fleet window path at the §6.1 setting (16 levels: 320
    level rows): the replay (B1 over every level row), one window's level
    groups against the plain version, ``query_entropy(merge="fragment")``
    of all flows over the 32 epochs on the device, its per-level estimates
    against the host per-level query on a few path groups, and the device
    G-sum against the float64 combine.  Returns what the kernel line
    needs."""
    import torch

    from repro_torch import obs
    from repro_torch.core.disketch import DiSketchSystem, _g_entropy
    from repro_torch.core.hashing import level_of
    from repro_torch.core.query import fleet_query_window, path_groups
    from repro_torch.core.sketches import true_entropy
    from repro_torch.kernels.sketch_query import um_gsum_device
    from repro_torch.kernels.sketch_update import fleet as FK

    wl, rep, mems, events = sc["wl"], sc["rep"], sc["mems"], sc["events"]
    epochs = list(range(N_EPOCHS))
    n_windows = -(-N_EPOCHS // WINDOW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    system = DiSketchSystem(mems, "um", rho_target=RHO["um"],
                            log2_te=LOG2_TE, n_levels=N_LEVELS)
    fleet = system.fleet
    assert fleet.level_seed == LEVEL_SEED
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    FK.csr_scatter.launches = 0
    obs.clear()
    h0 = time.perf_counter()
    start.record()
    rep.run(system, window=WINDOW)          # <- the UnivMon window path
    end.record()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - h0
    counts = read_counts()
    launches = counts["fleet_ragged"]
    scatters = FK.csr_scatter.launches
    expected = sum(len(np.unique(fleet._params_log[e0][:, FK.PARAM_N_SUB]))
                   for e0 in range(0, N_EPOCHS, WINDOW))
    assert launches == expected > 0, (counts, expected)
    assert counts["sketch_update"] == counts["fleet_dense"] == 0, counts
    # one card: each B1 launch's stream laid out by one scatter, which
    # folded the level of every staged packet of every window
    assert scatters == launches, (scatters, launches)
    folded = sum((s.counts or {}).get("folded", 0) for s in obs.spans()
                 if s.name == "fleet.pack_csr")
    staged = sum(len(rep.epoch_packet(e, fleet.frag_order).keys)
                 for e in range(N_EPOCHS))
    assert obs.dropped() == 0 and folded == staged > 0, (folded, staged)
    window_ms = start.elapsed_time(end) / n_windows
    bufs = list({id(b): b for b, _ in fleet._window_bufs.values()}.values())
    assert all(b.resident and b._host is None
               and all(c.is_cuda for _, c in b.device()) for b in bufs)
    stack_bytes = sum(c.numel() * 4 for b in bufs for _, c in b.device())
    rows = len(fleet.frag_order) * N_LEVELS
    peak_replay = torch.cuda.max_memory_allocated()

    # window 8's level-row groups against the plain version
    err = 0.0
    groups = _window_groups(fleet, rep, WINDOW)
    for (args, kw), (_, got) in zip(groups,
                                    fleet._window_bufs[WINDOW][0].device()):
        plain = FK.fleet_update_ragged_ref(*_to_device(args, dev), **kw)
        got = got.reshape(plain.shape)
        err = max(err, float((got - plain).abs().max()))
        assert torch.equal(got, plain), "um window groups != plain version"
        del plain
    # ... and window 8's CSR scatter, folding the levels of its raw
    # packets, against its plain version and pack_csr of the host-folded
    # packets, on the same staging (timed)
    s_err, s_timing = csr_scatter_window(fleet, rep, WINDOW, dev, groups,
                                         timed=True)

    # entropy of all flows over the 32 epochs, on the device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = float(len(wl.pkt_ts))
    truth = true_entropy(wl.sizes)
    q0 = time.perf_counter()
    ent = system.query_entropy(wl.keys, wl.paths, epochs, total,
                               n_levels=N_LEVELS, level_seed=LEVEL_SEED,
                               merge="fragment")
    q_s = time.perf_counter() - q0
    _pinned("um window 8 entropy (fragment merge)", ent,
            ENTROPY_PIN["window 8 fragment k_heavy 1024"], PIN_RTOL_F32)
    _guarded(sc, f"um window {WINDOW}: query_entropy(merge='fragment') of "
             f"{len(wl.keys)} flows, device G-sum", ent, q_s,
             lambda: system.query_entropy(
                 wl.keys, wl.paths, epochs, total, n_levels=N_LEVELS,
                 level_seed=LEVEL_SEED, merge="fragment"),
             lambda e: _pinned("guarded um window 8 entropy", e,
                               ENTROPY_PIN["window 8 fragment k_heavy 1024"],
                               PIN_RTOL_F32))
    # the same per-level estimates, whose G-sum gave ``ent``; the device
    # G-sum against the float64 combine with the device's selection
    by_path = path_groups(wl.paths)
    q1 = time.perf_counter()
    ests = np.concatenate([fleet.um_level_window_query(
        epochs, wl.keys[i], path=p) for p, i in by_path.items()], axis=1)
    ests_s = time.perf_counter() - q1
    lvl = np.concatenate([level_of(wl.keys[i], LEVEL_SEED, N_LEVELS)
                          for i in by_path.values()])
    assert ests.shape == (N_LEVELS, len(wl.keys))
    s_dev = um_gsum_device(ests, lvl, _g_entropy, device=dev)
    assert np.log2(total) - s_dev / total == ent
    s_host = _gsum_stable_f64(ests, lvl)
    gsum_rel = abs(s_dev - s_host) / abs(s_host)
    assert gsum_rel <= 1e-5, (s_dev, s_host)
    s_all = um_gsum_device(ests, lvl, _g_entropy, k_heavy=len(wl.keys),
                           device=dev)
    ent_all = float(np.log2(total) - s_all / total)
    _pinned("um window 8 entropy (fragment merge, k_heavy = every key)",
            ent_all, ENTROPY_PIN["window 8 fragment"], PIN_RTOL_F32)
    # per window, a 5-, a 3- and a 1-hop path group: the device (L, K)
    # estimates against the host per-level query on a copy of those rows
    checked = 0
    for w0 in range(0, N_EPOCHS, WINDOW):
        es = list(range(w0, min(w0 + WINDOW, N_EPOCHS)))
        for hops in (5, 3, 1):
            path, dense, prow = _smallest_path(
                fleet, w0, [p for p in by_path if len(p) == hops])
            kk = wl.keys[by_path[path]]
            got = fleet.um_level_window_query(es, kk, path=path)
            params = [fleet._params_log[e][prow] for e in es]
            for l in range(N_LEVELS):
                host = fleet_query_window(
                    list(dense), params, None, kk, "um",
                    frag_sel=np.arange(len(prow)) % N_LEVELS == l)
                np.testing.assert_allclose(got[l], host, rtol=1e-6,
                                           atol=1e-6)
            checked += len(kk)
    assert all(b.resident and b._host is None for b in bufs), \
        "a UnivMon window left the device"
    peak_query = torch.cuda.max_memory_allocated()
    timing = kernel_timing(groups, dev)
    n_by_window = [sorted(set(fleet._params_log[w0][:, FK.PARAM_N_SUB]
                              .tolist()))
                   for w0 in range(0, N_EPOCHS, WINDOW)]
    _log(f"univmon window {WINDOW}: rho_target={RHO['um']} n_levels="
         f"{N_LEVELS} ({rows} level rows) launches={launches} (expected "
         f"{expected}; CSR scatter launches {scatters}, levels folded on "
         f"the card for {folded} staged packets, every one; window "
         f"{WINDOW}'s folded scatter == plain version and pack_csr of the "
         f"host-folded packets, max_abs_err {s_err}); update "
         f"{window_ms:.2f} ms/window (CUDA events; "
         f"{events / (window_ms * n_windows / 1e3):.4g} packet-switch "
         f"events/s; host {run_s:.2f} s total); resident {stack_bytes} B "
         f"in {len(bufs)} windows, peak device memory {peak_replay} B in the "
         f"replay, {peak_query} B in the queries; n_sub per "
         f"window {n_by_window}; window {WINDOW} level groups == plain "
         f"version (max_abs_err {err})")
    _log(f"univmon entropy of {len(wl.keys)} flows over {N_EPOCHS} epochs, "
         f"fragment merge on the device: {ent!r} bits (true "
         f"{truth!r}; |error| {abs(ent - truth):.4f}; the reference's, "
         f"pinned) in {q_s:.2f} s "
         f"(per-level estimates {ests_s:.2f} s); k_heavy = every key: "
         f"{ent_all!r} (the reference's, pinned); device G-sum {s_dev!r} "
         f"against the float64 combine {s_host!r} (relative {gsum_rel:.3g});"
         f" device (L, K) == host per-level query for {checked} keys of "
         f"12 path groups; windows stayed on the device")
    _timing_line(f"fleet_ragged one um window ({timing['groups']} launches, "
                 f"{N_LEVELS} levels)", timing)
    _timing_line(f"csr_scatter one um window, level fold "
                 f"({s_timing['groups']} launches, {s_timing['folded']} "
                 f"levels folded; its page-locked staging of "
                 f"{s_timing['upload_mb']:.2f} MB uploads in "
                 f"{s_timing['upload_ms']:.4f} ms)", s_timing)
    del system, fleet, bufs, groups
    profile_replay(mems, rep, kind="um")
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=err, scatter_launches=scatters,
                scatter_err=s_err, scatter_timing=s_timing)


def univmon_epoch(dev, sc):
    """UnivMon on the per-epoch path at the §6.1 setting: calibration, the
    ragged replay (B1, groups kept on the card), the B2 loop over the 320
    level rows of the epoch with the most subepochs against B1, the
    records and the plain version, and ``query_entropy`` with both merges
    for DiSketch and the subepoch merge for DISCO.  Returns what the
    kernel line needs."""
    import torch

    from repro_torch.core.disketch import (DiscoSystem, DiSketchSystem,
                                           calibrate_rho_target)
    from repro_torch.core.fleet import build_params, fold_packet_flags
    from repro_torch.core.sketches import true_entropy
    from repro_torch.kernels.sketch_update import fleet as FK

    wl, rep, mems, events = sc["wl"], sc["rep"], sc["mems"], sc["events"]
    c0 = time.perf_counter()
    rho = calibrate_rho_target(mems, "um", rep.epoch_stream(N_EPOCHS // 2),
                               LOG2_TE, n_levels=N_LEVELS)
    assert abs(rho - RHO["um"]) <= 0.005, (rho, RHO["um"])
    cal_s = time.perf_counter() - c0
    torch.cuda.reset_peak_memory_stats()
    system = DiSketchSystem(mems, "um", rho_target=RHO["um"],
                            log2_te=LOG2_TE, n_levels=N_LEVELS,
                            fleet_kwargs={"keep_stacked": True})
    counts, host_s, dev_ms = _replay(rep, system)
    peak = torch.cuda.max_memory_allocated()
    expected = sum(len(set(_epoch_ns(system, e).values()))
                   for e in range(N_EPOCHS))
    assert counts["fleet_ragged"] == expected > 0, (counts, expected)
    assert counts["fleet_dense"] == counts["sketch_update"] == 0, counts
    fleet = system.fleet
    L = N_LEVELS

    # B2 loop over the level rows of the epoch with the most subepochs
    e_star = max(range(N_EPOCHS),
                 key=lambda e: (max(_epoch_ns(system, e).values()), -e))
    ns = _epoch_ns(system, e_star)
    params = build_params(fleet.fragments, e_star, ns, fleet.frag_order)
    assert np.array_equal(params, fleet._params_log[e_star])
    packet = fold_packet_flags(rep.epoch_packet(e_star, fleet.frag_order),
                               LOG2_TE, n_levels=L, level_seed=LEVEL_SEED)
    rect = packet.densify(fleet.blk)
    kw = dict(n_sub_max=max(ns.values()), width_max=int(fleet.widths.max()),
              log2_te=LOG2_TE, signed=True)
    trect = _to_device(rect + (params, np.zeros(0, np.int32)), dev)[:4]
    reset_counts()
    loop = FK.fleet_update_loop(*trect, device=dev, **kw)   # <- B2 path
    torch.cuda.synchronize()
    counts_l = read_counts()
    assert counts_l["sketch_update"] == len(params) == len(
        fleet.frag_order) * L, counts_l
    loop_plain = FK.fleet_update_loop(*trect, backend="ref", device=dev,
                                      **kw)
    torch.cuda.synchronize()
    err = float((loop - loop_plain).abs().max())
    assert torch.equal(loop, loop_plain), "um B2 loop != its plain version"
    for rows, c in fleet._window_bufs[e_star][0].device():
        part = loop[torch.as_tensor(rows, device=dev), :c.shape[2],
                    :c.shape[3]]
        assert torch.equal(c[0], part), "um B1 groups != the B2 loop"
    for i, sw in enumerate(fleet.frag_order):
        rec = system.records[e_star][sw]
        assert np.array_equal(rec.counters, loop[i * L:(i + 1) * L, :rec.n,
                              :rec.counters.shape[2]].cpu().numpy()
                              .astype(np.int64)), "um record != B2 loop"
    del loop, loop_plain

    # entropy: the subepoch merge on the records and the fragment merge on
    # the device, over the first ENTROPY_EPOCHS epochs
    es = list(range(ENTROPY_EPOCHS))
    in_es = (wl.pkt_ts >> LOG2_TE) < ENTROPY_EPOCHS
    total = float(in_es.sum())
    truth = true_entropy(np.bincount(wl.pkt_flow[in_es],
                                     minlength=len(wl.keys)))
    q0 = time.perf_counter()
    ent_sub = system.query_entropy(wl.keys, wl.paths, es, total,
                                   n_levels=L, level_seed=LEVEL_SEED)
    q_sub = time.perf_counter() - q0
    _pinned("um per-epoch entropy (subepoch merge)", ent_sub,
            ENTROPY_PIN["disketch subepoch"], PIN_RTOL)
    assert fleet.has_device_window(es)
    q1 = time.perf_counter()
    ent_frag = system.query_entropy(wl.keys, wl.paths, es, total,
                                    n_levels=L, level_seed=LEVEL_SEED,
                                    merge="fragment", k_heavy=len(wl.keys))
    q_frag = time.perf_counter() - q1
    _pinned("um per-epoch entropy (fragment merge on the device, k_heavy = "
            "every key)", ent_frag, ENTROPY_PIN["disketch fragment"],
            PIN_RTOL_F32)
    disco = DiscoSystem(mems, "um", rho_target=RHO["um"], log2_te=LOG2_TE,
                        n_levels=L)
    counts_o, host_o, _ = _replay(rep, disco)
    assert counts_o["fleet_ragged"] == N_EPOCHS, counts_o
    q2 = time.perf_counter()
    ent_disco = disco.query_entropy(wl.keys, wl.paths, es, total,
                                    n_levels=L, level_seed=LEVEL_SEED)
    q_disco = time.perf_counter() - q2
    _pinned("um DISCO entropy (subepoch merge)", ent_disco,
            ENTROPY_PIN["disco subepoch"], PIN_RTOL)
    _log(f"univmon per-epoch: calibrate_rho_target = {rho!r} in "
         f"{cal_s:.2f} s; launches {counts} (expected {expected}); update "
         f"{dev_ms / N_EPOCHS:.3f} ms/epoch on the device timeline, host "
         f"{host_s:.2f} s; peak device memory {peak} B; n after each epoch "
         f"{_n_trajectory(system.n_log)}")
    _log(f"univmon per-epoch B2 loop on epoch {e_star} ({len(params)} level "
         f"rows, rectangle {rect[0].shape}): launches {counts_l}; == its "
         f"plain version, == the replay's B1 groups, == the records")
    _log(f"univmon per-epoch entropy of {len(wl.keys)} flows over epochs "
         f"0-{ENTROPY_EPOCHS - 1} (true {truth!r}): subepoch merge "
         f"{ent_sub!r} in {q_sub:.2f} s; fragment merge on the device "
         f"(k_heavy = every key) {ent_frag!r} in {q_frag:.2f} s; DISCO "
         f"{ent_disco!r} in {q_disco:.2f} s (replay {host_o:.2f} s, "
         f"launches {counts_o}); all three the reference's (pinned)")
    del system, disco, fleet
    torch.cuda.empty_cache()
    return dict(ragged=counts["fleet_ragged"] + counts_o["fleet_ragged"],
                loop=counts_l["sketch_update"], max_abs_err=err)


def aggregated_phase(dev, sc):
    """The aggregated baselines (``AggregatedSystem``: a depth-4 sketch on
    each core switch, int64 counters on the card) for cs, cms and um,
    replayed epoch by epoch and queried for the 5-hop flows at their core
    switch, as the comparison the disaggregated systems are held to."""
    import torch

    from repro_torch.core.disketch import AggregatedSystem
    from repro_torch.net.simulator import rmse
    from repro_torch.net.topology import FatTree, core_on_path

    wl, rep, mems = sc["wl"], sc["rep"], sc["mems"]
    topo = FatTree(4)
    sel = wl.path_len == 5
    core = core_on_path(wl.path_mat[sel], topo.core_ids)
    epochs = list(range(N_EPOCHS))
    for kind in ("cs", "cms", "um"):
        agg = AggregatedSystem({sw: mems[sw] for sw in topo.core_ids}, kind,
                               depth=4, n_levels=N_LEVELS, device=dev)
        h0 = time.perf_counter()
        rep.run(agg)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - h0
        assert all(c.is_cuda for cs in agg.counters.values()
                   for c in cs.values())
        q0 = time.perf_counter()
        est = agg.query_flows(sc["keys"], core, epochs)
        q_s = time.perf_counter() - q0
        err = rmse(est, sc["truth"])
        _pinned(f"aggregated {kind} RMSE", err, AGG_RMSE_PIN[kind], PIN_RTOL)
        _log(f"aggregated {kind}: depth 4 on {len(topo.core_ids)} core "
             f"switches, replay {run_s:.2f} s, query of {len(core)} 5-hop "
             f"flows {q_s:.2f} s, RMSE {err!r} (the reference's, pinned)")


def churn_schedule():
    """A quarter of the 20 switches die at epoch 17 (window offset 1) and
    return at 25, beside seeded resource pressure: the schedule of
    ``scripts/reference_pins.py``'s churn section, made anew each call."""
    from repro_torch.net.simulator import (ComposedSchedule, FailureSchedule,
                                           ResourcePressure)

    return ComposedSchedule([
        FailureSchedule.random(20, 0.25, down_epoch=17, up_epoch=25, seed=3),
        ResourcePressure(20, horizon=N_EPOCHS, seed=5)])


def n_log_digest(n_log):
    """A short digest of an n trajectory (one {switch: n} per epoch), as
    ``scripts/reference_pins.py`` computes it."""
    rows = [[[int(sw), int(n)] for sw, n in sorted(d.items())]
            for d in n_log]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:16]


class _Timed:
    """A callable wrapped to keep each call's seconds (the device
    synchronized after it) and result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        import torch

        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.calls.append((time.perf_counter() - t0, out))
        return out


def _zero_rows(buf, positions, e_idx=0):
    """The full rows (padding included) of ``positions`` in epoch
    ``e_idx`` of a resident window, each exactly zero: their count."""
    import torch

    for i in positions:
        g, j = buf._where[i]
        row = buf.device()[g][1][e_idx, j]
        assert row.is_cuda and torch.equal(row, torch.zeros_like(row)), \
            f"row {i} of a dead or lost cell is not zero"
    return len(positions)


def _churn_window(dev, sc, kind, groups):
    """Window 8 under churn for one kind: the replay (B1, dead segments
    value 0, parity, lost rows zeroed), B1's groups of the churn window
    against the plain version, a twin of that window without the loss,
    and the queries under each policy."""
    import torch

    from repro_torch.core import fleet as F
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.net.simulator import rmse

    rep, mems = sc["rep"], sc["mems"]
    keys, truth, paths = sc["keys"], sc["truth"], sc["paths"]
    epochs = list(range(N_EPOCHS))
    system = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                            log2_te=LOG2_TE,
                            fleet_kwargs={"parity_groups": groups})
    fleet = system.fleet
    masking, parity = _Timed(F.mask_fragment_values), \
        _Timed(fleet._window_parity)
    F.mask_fragment_values, fleet._window_parity = masking, parity
    try:
        counts, host_s, dev_ms = _replay(rep, system, window=WINDOW,
                                         failures=churn_schedule())
    finally:
        F.mask_fragment_values = masking.fn
        del fleet._window_parity
    expected = sum(len(np.unique(fleet._params_log[e0][:, FK.PARAM_N_SUB]))
                   for e0 in range(0, N_EPOCHS, WINDOW))
    assert counts["fleet_ragged"] == expected > 0, (counts, expected)
    assert counts["fleet_dense"] == counts["sketch_update"] == 0, counts
    # the control: n trajectory, dead epochs, lost and recoverable cells
    _pinned_digest(f"window {kind} n trajectory", system.n_log,
                   CHURN_N_LOG_PIN[f"window {kind}"])
    d0, d1, victims = CHURN_DEAD
    assert system._dead_at == {e: frozenset(victims)
                               for e in range(d0, d1)}, system._dead_at
    lost = {e: sorted(fleet.frag_order[i] for i in v)
            for e, v in fleet._lost.items() if v}
    assert lost == CHURN_LOST, lost
    assert fleet.recoverable() == CHURN_RECOVERABLE, fleet.recoverable()

    # B1's groups of the churn window against the plain version on the
    # same masked packets; the lost rows, which B1 computed, were zeroed
    # after the parity was taken
    e0 = CHURN_EPOCHS[0]
    buf = fleet._window_bufs[e0][0]
    pos = {sw: i for i, sw in enumerate(fleet.frag_order)}
    lost_rows = {(e - e0, pos[sw]) for e, sws in CHURN_LOST.items()
                 for sw in sws}
    err, dead_rows = 0.0, 0
    for (args, kw), (rows, got) in zip(
            _window_groups(fleet, rep, e0, dead_at=system._dead_at),
            buf.device()):
        plain = FK.fleet_update_ragged_ref(*_to_device(args, dev),
                                           **kw).reshape(got.shape)
        for e in range(got.shape[0]):
            dead = system._dead_at.get(e0 + e, ())
            for j, r in enumerate(rows):
                if (e, int(r)) in lost_rows:
                    assert plain[e, j].any(), "a lost cell sketched nothing"
                    plain[e, j] = 0
            dead_rows += _zero_rows(buf, [pos[sw] for sw in dead
                                          if pos[sw] in set(rows.tolist())],
                                    e)
        err = max(err, float((got - plain).abs().max()))
        assert torch.equal(got, plain), f"{kind}: churn window != plain"
        del plain
    assert dead_rows == 7 * len(victims), dead_rows
    _zero_rows(buf, [pos[sw] for sw in CHURN_LOST[e0]])
    if kind == "cs":
        _timing_line(f"fleet_ragged cs churn window {e0} (dead segments "
                     f"value 0)", kernel_timing(_window_groups(
                         fleet, rep, e0, dead_at=system._dead_at), dev))

    # the twin: the same window dispatched with nothing lost
    ns = {sw: int(fleet._params_log[e0][i, FK.PARAM_N_SUB])
          for i, sw in enumerate(fleet.frag_order)}
    twin = F.FleetEpochRunner(dict(system.records[e0]._fragments), LOG2_TE,
                              device=dev)
    twin.run_window(e0, ns, [rep.epoch_packet(e, fleet.frag_order)
                             for e in CHURN_EPOCHS],
                    dead_by_epoch=[system._dead_at.get(e, ())
                                   for e in CHURN_EPOCHS])
    for e in CHURN_EPOCHS:
        assert np.array_equal(twin._params_log[e], fleet._params_log[e])

    # queries on the device, in this order: "recover" patches in place
    recover = _Timed(fleet.recover)
    fleet.recover = recover
    rmses, q_s = {}, {}
    try:
        for failures in ("oblivious", "mask", "recover"):
            q0 = time.perf_counter()
            est = system.query_flows(keys, paths, epochs, merge="fragment",
                                     failures=failures)
            torch.cuda.synchronize()
            q_s[failures] = time.perf_counter() - q0
            assert est.shape == keys.shape and np.isfinite(est).all()
            rmses[failures] = rmse(est, truth)
            _pinned(f"churn {kind} window {WINDOW} {failures} RMSE",
                    rmses[failures], CHURN_PIN[(kind, failures)], PIN_RTOL)
    finally:
        del fleet.recover
    assert rmses["mask"] < rmses["oblivious"], rmses
    assert rmses["recover"] <= rmses["mask"], rmses
    assert fleet.has_device_window(epochs) and buf._host is None
    recovered = {}
    for _, out in recover.calls:
        for e, sws in out.items():
            recovered.setdefault(e, []).extend(sws)
    assert recovered == CHURN_RECOVERABLE, recovered
    tbuf = twin._window_bufs[e0][0]
    for e, sws in recovered.items():
        for sw in sws:
            n, w = ns[sw], int(fleet._params_log[e][pos[sw],
                                                    FK.PARAM_WIDTH])
            a = buf.block(e - e0, pos[sw], 1, n, w)
            b = tbuf.block(e - e0, pos[sw], 1, n, w)
            assert torch.equal(a, b) and a.any(), \
                f"recovered cell ({e}, {sw}) != the twin's"
    unrecoverable = {e: sorted(set(sws) - set(recovered.get(e, ())))
                     for e, sws in CHURN_LOST.items()}
    for e, sws in unrecoverable.items():
        assert not fleet.frag_live(e)[[pos[sw] for sw in sws]].any()
        _zero_rows(buf, [pos[sw] for sw in sws], e - e0)
    storages = {p.untyped_storage().data_ptr(): p.untyped_storage().nbytes()
                for e in epochs for p in fleet._parity[e]}
    parity_bytes = sum(storages.values())
    obs = system.last_observability
    rec_line = ""
    if kind == "cs":
        # the record plane of the churn window (its host copy, subepoch
        # merge), where a dead cell's zero record enters an "oblivious"
        # merge; the recovered cells were patched on the device above
        es, truth_es = list(CHURN_EPOCHS), _churn_truth(sc)
        rec = {}
        for failures in ("mask", "oblivious"):
            q0 = time.perf_counter()
            est = system.query_flows(keys, paths, es, failures=failures)
            rec[failures] = (rmse(est, truth_es), time.perf_counter() - q0)
            assert est.shape == keys.shape and np.isfinite(est).all()
            _pinned(f"churn cs window {e0} records {failures} RMSE",
                    rec[failures][0], CHURN_PIN[("cs", f"records {failures}")],
                    PIN_RTOL)
        assert rec["mask"][0] < rec["oblivious"][0], rec
        assert buf._host is not None and not buf.resident
        rec_line = (f"; record plane of window {e0} (host copy, subepoch "
                    f"merge over epochs {es[0]}-{es[-1]}): RMSE mask "
                    f"{rec['mask'][0]!r} ({rec['mask'][1]:.2f} s), oblivious"
                    f" {rec['oblivious'][0]!r} ({rec['oblivious'][1]:.2f} s;"
                    f" the reference's, pinned)")
    _log(f"churn   {kind} window {WINDOW}: replay launches {counts} "
         f"(expected {expected}), update {dev_ms / 4:.2f} ms/window on the "
         f"device timeline, host {host_s:.2f} s; masking {len(masking.calls)}"
         f" calls {1e3 * sum(t for t, _ in masking.calls):.2f} ms; parity "
         f"capture {len(parity.calls)} windows "
         f"{1e3 * sum(t for t, _ in parity.calls):.2f} ms, "
         f"{parity_bytes} B on the device ({len(storages)} group tensors); "
         f"dead switches {victims} in epochs {d0}-{d1 - 1}; window {e0} "
         f"groups == plain (max_abs_err {err}), {dead_rows} dead rows and "
         f"the lost rows exactly zero; twin window == plain params")
    _log(f"churn   {kind} queries of {len(keys)} 5-hop flows over "
         f"{N_EPOCHS} epochs on the device: RMSE oblivious "
         f"{rmses['oblivious']!r} ({q_s['oblivious']:.2f} s), mask "
         f"{rmses['mask']!r} ({q_s['mask']:.2f} s), recover "
         f"{rmses['recover']!r} ({q_s['recover']:.2f} s; the reference's, "
         f"pinned); recovered {recovered}, unrecoverable {unrecoverable} "
         f"(a double loss in the group: still masked and zero); recover "
         f"{1e3 * recover.calls[0][0]:.2f} ms (first call; "
         f"{len(recover.calls)} calls "
         f"{1e3 * sum(t for t, _ in recover.calls):.2f} ms), recovered cells == the twin's bit for bit; "
         f"last_observability: system {obs['observable_cells']} of "
         f"{obs['total_cells']} cells, {obs['observable_epochs']} of "
         f"{obs['epochs']} epochs observable, scale {obs['scale']}, "
         f"{len(obs['config_clamps'])} clamps; fleet "
         f"{fleet.last_observability}{rec_line}")
    return counts["fleet_ragged"], err


def _churn_truth(sc):
    """The 5-hop flows' true sizes over CHURN_EPOCHS."""
    wl = sc["wl"]
    in_es = np.isin(wl.pkt_ts >> LOG2_TE, list(CHURN_EPOCHS))
    return np.bincount(wl.pkt_flow[in_es],
                       minlength=len(wl.keys))[wl.path_len == 5]


def _pinned_digest(what, n_log, want):
    """Fail unless the n trajectory ``n_log`` has the pinned digest."""
    got = n_log_digest(n_log)
    assert got == want, f"{what} {got} != the reference's {want}"


def _churn_epoch(dev, sc):
    """Per-epoch cs under the same schedule: the ragged run (B1) and a
    dense twin (B3), both keeping their counters on the card, held to
    each other and to the plain versions on a churn epoch; subepoch-merge
    queries over the churn window under "mask" and "oblivious"."""
    import torch

    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.core.fleet import mask_fragment_values
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.net.simulator import rmse

    rep, mems = sc["rep"], sc["mems"]
    keys, paths = sc["keys"], sc["paths"]
    runs = {}
    for layout, name in (("ragged", "fleet_ragged"), ("dense", "fleet_dense")):
        system = DiSketchSystem(mems, "cs", rho_target=RHO["cs"],
                                log2_te=LOG2_TE, fleet_kwargs={
                                    "layout": layout, "keep_stacked": True})
        counts, host_s, dev_ms = _replay(rep, system,
                                         failures=churn_schedule())
        assert counts[name] >= N_EPOCHS and sum(counts.values()) == \
            counts[name], counts
        runs[layout] = (system, counts, host_s, dev_ms)
    ragged, dense = runs["ragged"][0], runs["dense"][0]
    _pinned_digest("epoch cs n trajectory", ragged.n_log,
                   CHURN_N_LOG_PIN["epoch cs"])
    d0, d1, victims = CHURN_DEAD
    assert ragged._dead_at == {e: frozenset(victims) for e in range(d0, d1)}
    assert dense.n_log == ragged.n_log and dense._dead_at == ragged._dead_at
    for e in range(N_EPOCHS):
        assert sorted(dense.records[e]) == sorted(ragged.records[e])
        for sw, rec in ragged.records[e].items():
            assert np.array_equal(dense.records[e][sw].counters,
                                  rec.counters), f"dense ({e}, {sw})"
    dead_rows = 0
    for e, dead in ragged._dead_at.items():
        for s in (ragged, dense):
            dead_rows += _zero_rows(s.fleet._window_bufs[e][0],
                                    [s.fleet._frag_pos[sw] for sw in dead])
    # B1 and B3 against their plain versions on the first churn epoch
    e = d0
    fleet = ragged.fleet
    err = 0.0
    for (args, kw), (_, got) in zip(
            _window_groups(fleet, rep, e, n_epochs=1,
                           dead_at=ragged._dead_at),
            fleet._window_bufs[e][0].device()):
        plain = FK.fleet_update_ragged_ref(*_to_device(args, dev),
                                           **kw).reshape(got.shape)
        err = max(err, float((got - plain).abs().max()))
        assert torch.equal(got, plain), "per-epoch churn B1 != plain"
    params = dense.fleet._params_log[e]
    packet = mask_fragment_values(
        rep.epoch_packet(e, fleet.frag_order),
        [fleet._frag_pos[sw] for sw in victims])
    rect = _to_device(packet.densify(fleet.blk)
                      + (params, np.zeros(0, np.int32)), dev)[:4]
    plain = FK.fleet_update_ref(
        *rect, n_sub_max=int(params[:, FK.PARAM_N_SUB].max()),
        width_max=int(params[:, FK.PARAM_WIDTH].max()), log2_te=LOG2_TE,
        signed=True)
    for rows, c in dense.fleet._window_bufs[e][0].device():
        part = plain[torch.as_tensor(rows, device=dev), :c.shape[2],
                     :c.shape[3]]
        err = max(err, float((c[0] - part).abs().max()))
        assert torch.equal(c[0], part), "per-epoch churn B3 != plain"
    del plain
    es, truth_es = list(CHURN_EPOCHS), _churn_truth(sc)
    got = {}
    for failures in ("mask", "oblivious"):
        q0 = time.perf_counter()
        est = ragged.query_flows(keys, paths, es, failures=failures)
        q_s = time.perf_counter() - q0
        assert est.shape == keys.shape and np.isfinite(est).all()
        got[failures] = (rmse(est, truth_es), q_s)
        _pinned(f"churn cs per-epoch {failures} RMSE", got[failures][0],
                CHURN_PIN[("cs", f"epoch {failures}")], PIN_RTOL)
    for layout, (s, counts, host_s, dev_ms) in runs.items():
        _log(f"churn   cs per-epoch {layout}: launches {counts}, update "
             f"{dev_ms / N_EPOCHS:.3f} ms/epoch on the device timeline, "
             f"host {host_s:.2f} s")
    _log(f"churn   cs per-epoch: n trajectory the reference's (pinned); "
         f"dense records == ragged in all {N_EPOCHS} epochs; {dead_rows} "
         f"dead rows exactly zero (B1 and B3); epoch {e} B1 groups and B3 "
         f"== plain (max_abs_err {err}); subepoch merge over epochs "
         f"{es[0]}-{es[-1]}: RMSE mask {got['mask'][0]!r} "
         f"({got['mask'][1]:.2f} s), oblivious {got['oblivious'][0]!r} "
         f"({got['oblivious'][1]:.2f} s; the reference's, pinned)")
    return (runs["ragged"][1]["fleet_ragged"],
            runs["dense"][1]["fleet_dense"], err)


def churn_phase(dev, sc):
    """Churn and failure recovery at the §6.1 setting: window 8 for cs and
    cms with parity groups, then the per-epoch path.  Returns what the
    kernel line needs."""
    import torch

    from repro_torch.core.fleet import parity_groups_chunked

    groups = parity_groups_chunked(range(len(sc["mems"])), PARITY_GROUP)
    res = {"ragged": 0, "dense": 0, "max_abs_err": 0.0}
    for kind in ("cs", "cms"):
        launches, err = _churn_window(dev, sc, kind, groups)
        res["ragged"] += launches
        res["max_abs_err"] = max(res["max_abs_err"], err)
        torch.cuda.empty_cache()
    ragged, dense, err = _churn_epoch(dev, sc)
    res["ragged"] += ragged
    res["dense"] += dense
    res["max_abs_err"] = max(res["max_abs_err"], err)
    torch.cuda.empty_cache()
    return res


def lossy_ctrl():
    """The control phase's lossy channels (the reference tests'
    ``lossy_ctrl(seed=17, p_drop=0.4)``): directives lose 40%, duplicate
    20% and reorder 30% of copies; ACKs lose 20% and duplicate 20%; both
    add 0 or 1 round of delay."""
    from repro_torch.net.channel import LossyChannel

    return (LossyChannel(p_drop=0.4, p_dup=0.2, p_reorder=0.3, delay=(0, 1),
                         seed=17),
            LossyChannel(p_drop=0.2, p_dup=0.2, delay=(0, 1), seed=18))


def json_digest(obj):
    """A short digest of a JSON-able object, as ``scripts/reference_pins.py``
    computes it (the control plane's ``clamp_log``)."""
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()[:16]


def _planed(sc, kind, channels, window=WINDOW, failures=None, **fleet_kw):
    """A replay of ``kind`` under a ``VersionedControlPlane`` with the
    launch counters reset just before and read just after, and each
    ``_post_dispatch`` (the controller with its protocol rounds) timed:
    ``(system, plane, counts, host s, timed calls)``."""
    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.runtime import VersionedControlPlane

    system = DiSketchSystem(sc["mems"], kind, rho_target=RHO[kind],
                            log2_te=LOG2_TE, fleet_kwargs=fleet_kw or None)
    plane = VersionedControlPlane(system, *channels)
    post = _Timed(plane._post_dispatch)
    plane._post_dispatch = post
    counts, host_s, _ = _replay(sc["rep"], plane, window=window,
                                failures=failures)
    assert counts["fleet_ragged"] > 0 and sum(counts.values()) == \
        counts["fleet_ragged"], counts
    assert len(post.calls) == len(plane.applied_log) == -(-N_EPOCHS // window)
    return system, plane, counts["fleet_ragged"], host_s, post


def _resident_groups(fleet):
    """The row groups of every window of a window-8 replay."""
    return [fleet._window_bufs[w0][0].device()
            for w0 in range(0, N_EPOCHS, WINDOW)]


def _groups_equal(what, got, want):
    """Every row group of every window ``torch.equal``; ``got`` on the
    card, ``want`` on the card or the host.  Returns the groups' count."""
    import torch

    n = 0
    for w, (gw, ww) in enumerate(zip(got, want, strict=True)):
        assert len(gw) == len(ww), f"{what}: window {w} group count"
        for (rows, c), (rows_w, c_w) in zip(gw, ww):
            assert c.is_cuda and np.array_equal(rows, rows_w), \
                f"{what}: window {w} rows"
            assert torch.equal(c, c_w.to(c.device)), \
                f"{what}: window {w} counters differ"
            n += 1
    return n


def _held_to_pin(what, plane, pin, err):
    """The plane's applied configs, stale epochs, ``stats()`` and RMSE
    against the reference's (``CONTROL_PIN``)."""
    _pinned_digest(f"{what} applied_log", plane.applied_log, pin["applied"])
    assert plane.stale_epochs() == pin["stale"], \
        f"{what} stale epochs {plane.stale_epochs()} != {pin['stale']}"
    assert plane.stats() == pin["stats"], \
        f"{what} stats {plane.stats()} != the reference's {pin['stats']}"
    _pinned(f"{what} RMSE", err, pin["rmse"], PIN_RTOL)


def _plane_line(what, plane, post, host_s, launches, st, extra=""):
    """The control lines of the log: host times, and the rounds and
    messages of the replay (``st``, its ``stats()``)."""
    ms = [1e3 * t for t, _ in post.calls]
    _log(f"control {what}: replay host {host_s:.2f} s, B1 launches "
         f"{launches}; controller (_post_dispatch with its "
         f"{plane.steps_per_dispatch} protocol rounds) {np.mean(ms):.3f} ms "
         f"a dispatch (max {max(ms):.3f}, {len(ms)} dispatches, "
         f"{sum(ms):.2f} ms a replay); {st['now']} rounds, "
         f"{st['channel']['n_sent'] + st['ack_channel']['n_sent']} messages "
         f"({st['channel']['n_sent']} directive copies sent, "
         f"{st['ack_channel']['n_sent']} ACKs and NACKs), "
         f"{st['n_directives']} directives issued, "
         f"{st['n_stale_epochs']} stale epochs, {st['n_clamps']} clamps"
         f"{extra}")


def control_phase(dev, sc, main):
    """The versioned control plane at the §6.1 setting: cs window 8 over
    lossless channels against the window phase's plane-free run (``main``),
    cs and cms window 8 over the lossy channels against twins pinned to
    the applied configs, and cs per epoch under ``churn_schedule()`` over
    the lossy channels, each held to the reference's plane
    (``CONTROL_PIN``).  Returns what the kernel line needs."""
    import torch

    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.net.simulator import rmse

    rep, mems = sc["rep"], sc["mems"]
    keys, truth, paths = sc["keys"], sc["truth"], sc["paths"]
    epochs = list(range(N_EPOCHS))
    res = {"ragged": 0, "max_abs_err": 0.0}

    # 1. lossless: the plane is the oracle loop, one dispatch late
    system, plane, launches, host_s, post = _planed(sc, "cs", ())
    res["ragged"] += launches
    assert plane.n_directives > 0 and plane.stale_epochs() == []
    n_groups = _groups_equal("lossless cs window 8",
                             _resident_groups(system.fleet),
                             main["cs_groups"])
    free = main["cs_n_log"]
    for d in range(N_EPOCHS // WINDOW):
        start = free[d * WINDOW - 1] if d else {sw: 1 for sw in mems}
        assert plane.applied_log[d] == start, d
        assert plane.intent_log[d] == free[(d + 1) * WINDOW - 1], d
    assert system.n_log == [plane.applied_log[e // WINDOW] for e in epochs]
    q0 = time.perf_counter()
    err = rmse(plane.query_flows(keys, paths, epochs, merge="fragment"),
               truth)
    q_s = time.perf_counter() - q0
    _pinned("control lossless cs window 8 RMSE", err,
            RMSE_PIN[("cs", "window 8")], PIN_RTOL)
    _held_to_pin("control window cs lossless", plane,
                 CONTROL_PIN["window cs lossless"], err)
    _plane_line("cs window 8 lossless", plane, post, host_s, launches,
                plane.stats(), f"; {n_groups} resident groups of the 4 "
                f"windows == the plane-free run's, n at every window "
                f"boundary == its n_log, query {q_s:.2f} s, RMSE {err!r} "
                f"(RMSE_PIN's, and the reference plane's)")
    del system, plane

    # 2. lossy windows: stale configs, counters of the applied configs
    for kind in ("cs", "cms"):
        system, plane, launches, host_s, post = _planed(sc, kind,
                                                        lossy_ctrl())
        res["ragged"] += launches
        assert plane.stale_epochs(), f"{kind}: nothing ran stale"
        twin = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                              log2_te=LOG2_TE)
        twin.control_external = True
        order = twin.fleet.frag_order
        for d, e0 in enumerate(range(0, N_EPOCHS, WINDOW)):
            twin.ns.update(plane.applied_log[d])
            es = range(e0, min(e0 + WINDOW, N_EPOCHS))
            twin.run_window(e0, [rep.epoch_stream(e) for e in es],
                            packets=[rep.epoch_packet(e, order) for e in es])
        n_groups = _groups_equal(f"lossy {kind} window 8",
                                 _resident_groups(system.fleet),
                                 _resident_groups(twin.fleet))
        assert system.n_log == twin.n_log
        del twin
        q0 = time.perf_counter()
        err = rmse(plane.query_flows(keys, paths, epochs, merge="fragment"),
                   truth)
        q_s = time.perf_counter() - q0
        assert plane.last_observability["stale_config"] == \
            plane.stale_epochs()
        _held_to_pin(f"control window {kind}", plane,
                     CONTROL_PIN[f"window {kind}"], err)
        st = plane.stats()
        d0 = time.perf_counter()
        rounds = plane.drain()
        drain_ms = 1e3 * (time.perf_counter() - d0)
        lag = plane.version_lag()
        assert set(lag.values()) == {0}, lag
        _plane_line(f"{kind} window 8 lossy", plane, post, host_s, launches,
                    st, f"; stale epochs {plane.stale_epochs()}; "
                    f"{n_groups} resident groups == a twin run at the "
                    f"applied configs; query {q_s:.2f} s, RMSE {err!r}; "
                    f"applied_log, stale epochs, stats() and RMSE the "
                    f"reference plane's (pinned); drained at round {rounds} "
                    f"in {drain_ms:.2f} ms, every version lag 0")
        del system, plane
        torch.cuda.empty_cache()

    # 3. per epoch under churn: the pressure reaches the agents
    system, plane, launches, host_s, post = _planed(
        sc, "cs", lossy_ctrl(), window=1, failures=churn_schedule(),
        keep_stacked=True)
    res["ragged"] += launches
    pin = CONTROL_PIN["epoch cs"]
    st = plane.stats()
    assert st["n_nacks_tx"] > 0 and plane.clamp_log, st
    assert json_digest(plane.clamp_log) == pin["clamps"] and \
        len(plane.clamp_log) == pin["n_clamps"], \
        f"clamp_log {json_digest(plane.clamp_log)} != the reference's"
    d0, d1, victims = CHURN_DEAD
    assert system._dead_at == {e: frozenset(victims) for e in range(d0, d1)}
    es, truth_es = list(CHURN_EPOCHS), _churn_truth(sc)
    q0 = time.perf_counter()
    est = plane.query_flows(keys, paths, es, failures="mask")
    q_s = time.perf_counter() - q0
    assert est.shape == keys.shape and np.isfinite(est).all()
    stale_config = plane.last_observability["stale_config"]
    assert stale_config == pin["stale_config"], stale_config
    err = rmse(est, truth_es)
    _held_to_pin("control epoch cs", plane, pin, err)
    # B1 against its plain version on the first stale epoch, and on the
    # first stale epoch with dead switches
    fleet = system.fleet
    checked = sorted({plane.stale_epochs()[0],
                      next(e for e in plane.stale_epochs() if e >= d0)})
    for e in checked:
        for (args, kw), (_, got) in zip(
                _window_groups(fleet, rep, e, n_epochs=1,
                               dead_at=system._dead_at),
                fleet._window_bufs[e][0].device(), strict=True):
            plain = FK.fleet_update_ragged_ref(*_to_device(args, dev),
                                               **kw).reshape(got.shape)
            res["max_abs_err"] = max(res["max_abs_err"],
                                     float((got - plain).abs().max()))
            assert torch.equal(got, plain), f"epoch {e}: B1 != plain"
    _plane_line("cs per-epoch lossy under churn_schedule()", plane, post,
                host_s, launches, st,
                f" ({st['n_nacks_tx']} NACKs beaconed, "
                f"{st['n_stale_acks']} stale ACKs dropped); stale_config of "
                f"epochs {es[0]}-{es[-1]} {stale_config}; subepoch-merge "
                f"query under mask {q_s:.2f} s, RMSE {err!r}; applied_log, "
                f"clamp_log, stats(), stale epochs and RMSE the reference "
                f"plane's (pinned); B1 == plain on epochs {checked} "
                f"(max_abs_err {res['max_abs_err']})")
    del system, plane
    torch.cuda.empty_cache()
    return res


def lossy_export():
    """The export phase's channels (the reference tests' ``lossy()``):
    data messages lose 30%, duplicate 20% and reorder 30% of copies and
    take 0 to 2 extra rounds; ACKs lose 15%, duplicate 20% and take 0 or
    1 extra round."""
    from repro_torch.net.channel import LossyChannel

    return (LossyChannel(p_drop=0.3, p_dup=0.2, p_reorder=0.3, delay=(0, 2),
                         seed=9),
            LossyChannel(p_drop=0.15, p_dup=0.2, delay=(0, 1), seed=10))


def _drop_switch(victim, seed):
    """A lossless channel that drops every message of switch ``victim``."""
    from repro_torch.net.channel import LossyChannel

    class DropSwitch(LossyChannel):
        def send(self, msg, now):
            if msg.frag == victim:
                self.n_sent += 1
                self.n_dropped += 1
                return
            super().send(msg, now)

    return DropSwitch(seed=seed)


def _live_block_bytes(fleet, es):
    """Bytes of the int32 live ``(L, n, width)`` blocks of every cell of
    the epochs ``es``: what staging them copies to the host."""
    L = fleet.n_levels
    return sum(4 * L * int(np.prod(fleet._block_shape(fleet._params_log[e],
                                                      i)))
               for e in es for i in range(len(fleet.frag_order)))


def _export_crash_run(sc, main):
    """cs window 8 under the export plane with checkpoints and a collector
    crash after the second window, drained: held to the plane-free run
    (``main``) and to ``EXPORT_PIN``.  Returns B1's launches."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.net.simulator import rmse
    from repro_torch.runtime import DurableExportPlane

    rep, keys, truth, paths = sc["rep"], sc["keys"], sc["truth"], sc["paths"]
    d = tempfile.mkdtemp(prefix="export_ckpt_")
    try:
        system = DiSketchSystem(sc["mems"], "cs", rho_target=RHO["cs"],
                                log2_te=LOG2_TE)
        fleet = system.fleet
        plane = DurableExportPlane(
            system, *lossy_export(), max_retries=12, ckpt_dir=d,
            ckpt_every=EXPORT_CKPT_EVERY, ckpt_keep=2,
            steps_per_dispatch=EXPORT_STEPS)
        # timed hooks on the instance: staging, delivery, checkpoints,
        # the crash after window EXPORT_CRASH_AFTER, the bytes retained on
        # the switches before each round
        stage = plane._stage_epoch = _Timed(plane._stage_epoch)
        deliver = fleet.deliver_cell = _Timed(fleet.deliver_cell)
        crash = _Timed(plane.crash)
        ckpt_fn, ckpts = plane.checkpoint, []
        step_fn, retained = plane.step, [0]
        window_fn = plane.run_window

        def checkpoint():
            t0 = time.perf_counter()
            s = ckpt_fn()
            path = os.path.join(d, f"step_{s:09d}")
            ckpts.append((sum(os.path.getsize(os.path.join(path, f))
                              for f in os.listdir(path)),
                          time.perf_counter() - t0))
            return s

        def step():
            retained[0] = max(retained[0], sum(
                ent.payload.nbytes for exp in plane.exporters.values()
                for ent in exp.entries.values()))
            step_fn()

        def run_window(e0, streams_list, **kw):
            window_fn(e0, streams_list, **kw)
            if e0 == EXPORT_CRASH_AFTER:
                crash()

        plane.checkpoint, plane.step = checkpoint, step
        plane.run_window = run_window
        counts, host_s, _ = _replay(rep, plane, window=WINDOW)
        assert counts["fleet_ragged"] > 0 and sum(counts.values()) == \
            counts["fleet_ragged"], counts
        n_deliver_replay = len(deliver.calls)
        d0 = time.perf_counter()
        plane.drain()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - d0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    assert not fleet._unexported and not fleet._row_live
    assert plane.lost_cells() == set() and plane.pending_cells() == set()
    assert len(crash.calls) == 1
    n_groups = _groups_equal("export crash run", _resident_groups(fleet),
                             main["cs_groups"])
    assert system.n_log == main["cs_n_log"], "n_log != the plane-free run's"
    report = dict(crash.calls[0][1])
    restaged = report.pop("restaged")
    report.update(n_restaged=len(restaged), restaged=json_digest(restaged))
    assert report == EXPORT_PIN["crash"], \
        f"crash() {report} != the reference's {EXPORT_PIN['crash']}"
    st = plane.stats()
    assert st == EXPORT_PIN["stats"], \
        f"stats {st} != the reference's {EXPORT_PIN['stats']}"
    assert plane._ckpt_step == len(ckpts) == EXPORT_PIN["checkpoints"]
    q0 = time.perf_counter()
    err = rmse(plane.query_flows(keys, paths, list(range(N_EPOCHS)),
                                 merge="fragment"), truth)
    q_s = time.perf_counter() - q0
    _pinned("export crash run cs window 8 RMSE", err,
            RMSE_PIN[("cs", "window 8")], PIN_RTOL)
    windows = range(0, N_EPOCHS, WINDOW)
    stage_ms = [1e3 * sum(t for t, _ in stage.calls[i:i + WINDOW])
                for i in range(0, len(stage.calls), WINDOW)]
    staged = [_live_block_bytes(fleet, range(w0, w0 + WINDOW))
              for w0 in windows]
    bufs = [fleet._window_bufs[w0][0] for w0 in windows]
    host_copy = [sum(c.numel() * 8 for _, c in b.device()) for b in bufs]
    padded = [int(np.prod(b._shape)) * 8 for b in bufs]
    deliver_ms = [1e3 * t for t, _ in deliver.calls]
    _log(f"export  cs window {WINDOW} crash run: replay host {host_s:.2f} s, "
         f"B1 launches {counts['fleet_ragged']} (CUDA); staging a window "
         f"(cell_counters device-to-host + mark_unexported, 160 cells) "
         f"{', '.join(f'{m:.2f}' for m in stage_ms)} ms; delivering a cell "
         f"{np.mean(deliver_ms):.3f} ms (max {max(deliver_ms):.3f}, "
         f"{n_deliver_replay} in the replay, {len(deliver_ms)} in all)")
    _log(f"export  bytes staged a window (int32 live blocks) {staged}; the "
         f"window's int64 host copy {host_copy}, padded {padded}; peak "
         f"retained on the switches {retained[0]} B")
    _log(f"export  checkpoints (B, s): "
         f"{', '.join(f'({b}, {t:.3f})' for b, t in ckpts)}; crash after "
         f"window {EXPORT_CRASH_AFTER}: recovered in {crash.calls[0][0]:.3f} "
         f"s, report {report}; drain {drain_s:.3f} s; {st['now']} rounds, "
         f"{st['channel']['n_sent']} data messages and "
         f"{st['ack_channel']['n_sent']} ACKs sent, "
         f"{st['n_dup_rx']} duplicates received")
    _log(f"export  {n_groups} resident groups of the 4 windows == the "
         f"plane-free run's, n_log == its n_log; query {q_s:.2f} s, RMSE "
         f"{err!r} (RMSE_PIN's); crash(), stats() and checkpoints the "
         f"reference plane's (EXPORT_PIN)")
    return counts["fleet_ragged"]


def _export_drop_run(sc):
    """cms window 8 with every message of switch ``EXPORT_VICTIM`` dropped:
    its 32 cells lost; the mask query of the flows through it equals the
    plane-free run's with the switch taken out of their paths, exactly;
    oblivious <= mask.  Returns B1's launches."""
    import torch

    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.runtime import DurableExportPlane

    rep, mems, keys, paths = sc["rep"], sc["mems"], sc["keys"], sc["paths"]
    epochs = list(range(N_EPOCHS))
    system = DiSketchSystem(mems, "cms", rho_target=RHO["cms"],
                            log2_te=LOG2_TE)
    plane = DurableExportPlane(system, _drop_switch(EXPORT_VICTIM, seed=4),
                               max_retries=2, steps_per_dispatch=EXPORT_STEPS)
    counts, host_s, _ = _replay(rep, plane, window=WINDOW)
    assert counts["fleet_ragged"] > 0 and sum(counts.values()) == \
        counts["fleet_ragged"], counts
    plane.drain()
    assert plane.lost_cells() == {(EXPORT_VICTIM, e) for e in epochs}
    st = plane.stats()
    assert st == EXPORT_PIN["drop stats"], \
        f"drop stats {st} != the reference's {EXPORT_PIN['drop stats']}"
    twin = DiSketchSystem(mems, "cms", rho_target=RHO["cms"],
                          log2_te=LOG2_TE)
    rep.run(twin, window=WINDOW)
    assert twin.n_log == system.n_log
    sel = [i for i, p in enumerate(paths) if EXPORT_VICTIM in p]
    kv, pv = keys[sel], [paths[i] for i in sel]
    q0 = time.perf_counter()
    mask = plane.query_flows(kv, pv, epochs, merge="fragment",
                             failures="mask")
    torch.cuda.synchronize()
    q_s = time.perf_counter() - q0
    assert plane.last_observability["lost"] == sorted(plane.lost_cells())
    survivors = twin.query_flows(
        kv, [tuple(s for s in p if s != EXPORT_VICTIM) for p in pv], epochs,
        merge="fragment", failures="mask")
    assert np.array_equal(mask, survivors), \
        "mask query != the survivors-only query"
    obl = plane.query_flows(kv, pv, epochs, merge="fragment",
                            failures="oblivious")
    assert (obl <= mask).all() and (obl < mask).any()
    assert all(b.resident for b, _ in system.fleet._window_bufs.values())
    _log(f"export  cms window {WINDOW} drop run (every message of switch "
         f"{EXPORT_VICTIM} dropped, max_retries 2): replay host "
         f"{host_s:.2f} s, B1 launches {counts['fleet_ragged']}; lost cells "
         f"== its {N_EPOCHS} epochs; {st['now']} rounds, "
         f"{st['channel']['n_sent']} data messages and "
         f"{st['ack_channel']['n_sent']} ACKs sent (stats() the reference "
         f"plane's); mask query of its {len(kv)} 5-hop flows {q_s:.2f} s == "
         f"the plane-free run's with it taken out of their paths, exactly; "
         f"oblivious <= mask (< on {int((obl < mask).sum())} flows)")
    return counts["fleet_ragged"]


def export_phase(sc, main):
    """The durable export plane at the §6.1 setting: the cs crash run and
    the cms drop run.  Returns B1's launches."""
    import torch

    launches = _export_crash_run(sc, main) + _export_drop_run(sc)
    torch.cuda.empty_cache()
    return launches


def _device_events(prof):
    """The device's own events in a torch.profiler trace (kernels, copies,
    fills): a host op's device time repeats what its kernels took, and the
    profiler's activity-buffer bookkeeping is not the program's."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Activity Buffer")]


def _chaos_run(dev, sc, name, main, profiled=False):
    """One run of the chaos phase, held to ``CHAOS_PIN[name]``: the replay
    (B1 on the fleet window of 8) with each dispatch's harness work timed,
    ``finish()``, the twin at the applied configs (lossy runs), B1 of the
    churn window against the plain version (lossy cs), the mask query on
    the device.  ``profiled`` runs the replay under torch.profiler for the
    device's busy share.  Returns (B1 launches, max_abs_err)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.disketch import DiSketchSystem
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.net.simulator import rmse
    from repro_torch.runtime import (ChaosHarness, DurableExportPlane,
                                     VersionedControlPlane)

    rep, keys, truth, paths = sc["rep"], sc["keys"], sc["truth"], sc["paths"]
    kind = name.split()[-1]
    lossy = name != "lossless cs"
    pin = CHAOS_PIN[name]
    system = DiSketchSystem(sc["mems"], kind, rho_target=RHO[kind],
                            log2_te=LOG2_TE)
    fleet = system.fleet
    export_ch, ctrl_ch = (lossy_export(), lossy_ctrl()) if lossy else \
        ((), ())
    h = ChaosHarness(VersionedControlPlane(DurableExportPlane(
        system, *export_ch, max_retries=CHAOS_MAX_RETRIES,
        steps_per_dispatch=0), *ctrl_ch),
        steps_per_dispatch=CHAOS_STEPS if lossy else 4,
        crash_every=CHAOS_CRASH_EVERY if lossy else 0)
    after = h._after_dispatch = _Timed(h._after_dispatch)
    failures = churn_schedule() if lossy else None
    busy = ""
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            counts, host_s, _ = _replay(rep, h, window=WINDOW,
                                        failures=failures)
        on_dev = _device_events(prof)
        busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
        top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:3]
        busy = (f"; under torch.profiler, device busy {busy_ms:.3f} ms "
                f"({100 * busy_ms / (host_s * 1e3):.2f}% of the replay's "
                f"wall), led by " + ", ".join(
                    f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} "
                    f"{e.key[:48]}" for e in top))
    else:
        counts, host_s, _ = _replay(rep, h, window=WINDOW, failures=failures)
    assert counts["fleet_ragged"] > 0 and sum(counts.values()) == \
        counts["fleet_ragged"], counts
    launches = counts["fleet_ragged"]
    f0 = time.perf_counter()
    report = h.finish()                 # the partition and the ledger
    finish_s = time.perf_counter() - f0
    assert json.loads(json.dumps(report)) == pin["report"], \
        f"chaos {name} report {report} != the reference's {pin['report']}"
    assert json_digest(h.crash_log) == pin["crash_log"], \
        f"chaos {name} crash log {json_digest(h.crash_log)} != the reference's"
    _pinned_digest(f"chaos {name} n trajectory", system.n_log, pin["n_log"])
    err, extra = 0.0, ""
    if not lossy:
        assert report["staged"] == N_EPOCHS * len(sc["mems"])
        n_groups = _groups_equal("chaos lossless cs",
                                 _resident_groups(fleet),
                                 main.pop("cs_groups"))
        # the plane is the oracle loop one dispatch late: each window ran
        # at the plane-free run's n after the window before
        free, ctl = main.pop("cs_n_log"), h.control
        for d in range(N_EPOCHS // WINDOW):
            start = free[d * WINDOW - 1] if d else {sw: 1 for sw in free[0]}
            assert ctl.applied_log[d] == start, d
            assert ctl.intent_log[d] == free[(d + 1) * WINDOW - 1], d
        assert system.n_log == [ctl.applied_log[e // WINDOW]
                                for e in range(N_EPOCHS)]
        extra = (f"; {n_groups} resident groups of the 4 windows == the "
                 f"plane-free run's, n at every window boundary == its "
                 f"n_log")
    else:
        d0, d1, victims = CHURN_DEAD
        assert system._dead_at == {e: frozenset(victims)
                                   for e in range(d0, d1)}
        lost = {e: sorted(fleet.frag_order[i] for i in v)
                for e, v in fleet._lost.items() if v}
        assert lost == CHURN_LOST, lost
        reset_counts()
        t0 = time.perf_counter()
        n_cells = h.verify_config_twin(lambda: DiSketchSystem(
            sc["mems"], kind, rho_target=RHO[kind], log2_te=LOG2_TE))
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        twin_launches = read_counts()["fleet_ragged"]
        assert n_cells == report["applied"] and twin_launches > 0
        launches += twin_launches
        extra = (f"; twin at the applied configs {twin_s:.2f} s (B1 "
                 f"launches {twin_launches}), its {n_cells} applied cells "
                 f"== the run's bit for bit")
        if kind == "cs":
            # B1 of the churn window against the plain version: its lost
            # rows were zeroed after B1, its dead rows are value 0, every
            # other cell was held back and delivered exactly
            e0 = CHURN_EPOCHS[0]
            pos = {sw: i for i, sw in enumerate(fleet.frag_order)}
            gone = {(e - e0, pos[sw]) for e, sws in CHURN_LOST.items()
                    for sw in sws}
            gone |= {(e - e0, pos[sw]) for sw, e in h.export.lost_cells()
                     if e in CHURN_EPOCHS}
            for (args, kw), (rows, got) in zip(
                    _window_groups(fleet, rep, e0, dead_at=system._dead_at),
                    fleet._window_bufs[e0][0].device(), strict=True):
                plain = FK.fleet_update_ragged_ref(
                    *_to_device(args, dev), **kw).reshape(got.shape)
                for e in range(got.shape[0]):
                    for j, r in enumerate(rows):
                        if (e, int(r)) in gone:
                            plain[e, j] = 0
                err = max(err, float((got - plain).abs().max()))
                assert torch.equal(got, plain), "chaos window != plain"
                del plain
            extra += (f"; B1's churn window {e0} == plain (max_abs_err "
                      f"{err})")
    q0 = time.perf_counter()
    est = h.query_flows(keys, paths, list(range(N_EPOCHS)), merge="fragment",
                        failures="mask")
    torch.cuda.synchronize()
    q_s = time.perf_counter() - q0
    assert est.shape == keys.shape and np.isfinite(est).all()
    assert fleet.has_device_window(list(range(N_EPOCHS)))
    err_rmse = rmse(est, truth)
    _pinned(f"chaos {name} RMSE", err_rmse, pin["rmse"], PIN_RTOL)
    if not lossy:
        _pinned("chaos lossless cs RMSE", err_rmse,
                RMSE_PIN[("cs", "window 8")], PIN_RTOL)
    ms = [1e3 * t for t, _ in after.calls]
    st = report["export"]
    _log(f"chaos   {name} window {WINDOW}: replay wall {host_s:.2f} s, B1 "
         f"launches {counts['fleet_ragged']}; harness (snapshot, "
         f"{h.steps_per_dispatch} export rounds, crash, partition check) "
         f"{', '.join(f'{m:.2f}' for m in ms)} ms a dispatch; finish() "
         f"{1e3 * finish_s:.1f} ms{busy}; {report['staged']} staged, "
         f"{report['applied']} applied, {len(report['lost'])} lost, "
         f"{report['crashes']} crashes, stale epochs "
         f"{report['n_stale_epochs']}, {report['n_directives']} directives, "
         f"{report['n_clamps']} clamps; {st['now']} export rounds, "
         f"{st['n_tx']} data messages{extra}; mask query {q_s:.2f} s, RMSE "
         f"{err_rmse!r}; report, crash log, n_log and RMSE the reference's "
         f"(CHAOS_PIN)")
    return launches, err


def chaos_phase(dev, sc, main):
    """The chaos harness at the §6.1 setting on the fleet window of 8: the
    loss-free cs stack against the plane-free window run (``main``), then
    cs and cms with every failure plane armed, each held to the
    reference's harness (``CHAOS_PIN``); cms runs under the profiler.
    Returns what the kernel line needs."""
    import torch

    res = {"ragged": 0, "max_abs_err": 0.0}
    for name in ("lossless cs", "cs", "cms"):
        launches, err = _chaos_run(dev, sc, name, main,
                                   profiled=name == "cms")
        res["ragged"] += launches
        res["max_abs_err"] = max(res["max_abs_err"], err)
        torch.cuda.empty_cache()
    _log(f"chaos   B1 launches added by the phase: {res['ragged']}")
    return res


def _shard_launches(fleet):
    """B1 launches of a sharded window-8 replay: one per distinct n_sub of
    each non-empty shard in each window."""
    from repro_torch.kernels.sketch_update import fleet as FK

    L = fleet.n_levels
    return sum(len(np.unique(fleet._params_log[e0][lo * L:hi * L,
                                                   FK.PARAM_N_SUB]))
               for e0 in range(0, N_EPOCHS, WINDOW)
               for lo, hi in fleet._shard_frag_bounds if lo < hi)


class _GatherMeter:
    """Counts the bytes of the f32 estimate slices (the flow plane's
    ``(E, R_g, K)`` rows, UnivMon's ``(E', L, pairs)`` on-path slots) that
    ``engine._all_gather_rows`` hands to the merge device while it is
    installed (``with``; the counts add up over several ``with``s).  On
    one card the copy is a no-op; across cards these bytes would cross."""

    def __init__(self):
        self.bytes = self.calls = 0

    def __enter__(self):
        from repro_torch.kernels.sketch_query import engine

        self.engine, self.copy = engine, engine._all_gather_rows

        def meter(part, dev):
            self.bytes += part.numel() * part.element_size()
            self.calls += 1
            return self.copy(part, dev)

        engine._all_gather_rows = meter
        return self

    def __exit__(self, *exc):
        self.engine._all_gather_rows = self.copy


def _cells_equal(sharded, twin, what):
    """Every retained (epoch, switch) cell's live block of the sharded
    fleet ``torch.equal`` to the twin's, on the card; each sharded group
    holds one shard's rows.  Returns the cells' count."""
    import torch

    L = sharded.n_levels
    owner = np.concatenate([[s] * (hi - lo) for s, (lo, hi) in
                            enumerate(sharded._shard_frag_bounds)
                            if lo < hi])
    for buf in {id(b): b for b, _ in sharded._window_bufs.values()}.values():
        for rows, c in buf.device():
            assert c.is_cuda and len(set(owner[rows // L])) == 1, \
                f"{what}: a group spans shards"
    n = 0
    for e in sorted(twin._window_bufs):
        (bs, i_s), (bt, i_t) = sharded._window_bufs[e], twin._window_bufs[e]
        for i in range(len(twin.frag_order)):
            shape = twin._block_shape(twin._params_log[e], i)
            a = bs.block(i_s, i * L, L, *shape)
            b = bt.block(i_t, i * L, L, *shape)
            assert a.is_cuda and torch.equal(a, b), \
                f"{what}: cell ({e}, {twin.frag_order[i]}) != the twin's"
            n += 1
    return n


def _held_to_plain(fleet, rep, dev, what, e0=WINDOW):
    """Window ``e0``'s per-shard groups against the plain version on the
    card: the max abs error (0, or the check fails)."""
    import torch

    from repro_torch.kernels.sketch_update import fleet as FK

    err = 0.0
    for (args, kw), (_, got) in zip(_window_groups(fleet, rep, e0),
                                    fleet._window_bufs[e0][0].device(),
                                    strict=True):
        plain = FK.fleet_update_ragged_ref(*_to_device(args, dev), **kw)
        got = got.reshape(plain.shape)
        err = max(err, float((got - plain).abs().max()))
        assert torch.equal(got, plain), f"{what}: shard group != plain"
        del plain
    return err


def _sharded_pair(sc, kind, mesh, schedule=None, **kw):
    """The twin (one device) and the sharded system replayed window by
    window (under a fresh ``schedule()`` each, if given), the launch
    counters reset before and read after each: ``{"twin"|"sharded":
    (system, B1 launches, host s)}``."""
    from repro_torch.core.disketch import DiSketchSystem

    out = {}
    for name, where in (("twin", dict(device=mesh.devices[0])),
                        ("sharded", dict(mesh=mesh))):
        system = DiSketchSystem(sc["mems"], kind, rho_target=RHO[kind],
                                log2_te=LOG2_TE, **where, **kw)
        counts, host_s, _ = _replay(sc["rep"], system, window=WINDOW,
                                    failures=schedule and schedule())
        assert sum(counts.values()) == counts["fleet_ragged"] > 0, counts
        out[name] = (system, counts["fleet_ragged"], host_s)
    sharded, twin = out["sharded"][0], out["twin"][0]
    want = _shard_launches(sharded.fleet)
    assert out["sharded"][1] == want >= out["twin"][1], \
        (out["sharded"][1], want, out["twin"][1])
    assert sharded.n_log == twin.n_log, f"sharded {kind}: n trajectory"
    return out


def _timed_query(fn, *args, **kw):
    import torch

    q0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - q0


def _sharded_line(what, runs, q_s, meter, extra=""):
    """One timing line of the sharded phase."""
    (sh, sh_l, sh_s), (tw, tw_l, tw_s) = runs["sharded"], runs["twin"]
    resident = {name: sum(c.numel() * 4 for b in {
        id(b): b for b, _ in system.fleet._window_bufs.values()}.values()
        for _, c in b.device() or ()) for name, system in (("sharded", sh),
                                                           ("twin", tw))}
    _log(f"sharded {what} [{_nvidia_smi()}]: replay {sh_s:.2f} s, B1 "
         f"launches {sh_l} (per shard and n_sub) against the twin's "
         f"{tw_s:.2f} s, {tw_l}; queries {q_s['sharded']:.2f} s against "
         f"{q_s['twin']:.2f} s; the gather handed {meter.bytes} B in "
         f"{meter.calls} f32 estimate slices to the merge device, against "
         f"{resident['sharded']} B of resident groups (the twin's "
         f"{resident['twin']} B){extra}")


def _sharded_window(dev, sc, kind, mesh):
    """cs or cms, window 8, sharded beside its single-device twin: every
    cell, one window's per-shard groups against the plain version, and
    all 5-hop flows (``RMSE_PIN``)."""
    from repro_torch.net.simulator import rmse

    keys, paths = sc["keys"], sc["paths"]
    runs = _sharded_pair(sc, kind, mesh)
    sharded, twin = runs["sharded"][0], runs["twin"][0]
    cells = _cells_equal(sharded.fleet, twin.fleet, f"sharded {kind}")
    err = _held_to_plain(sharded.fleet, sc["rep"], dev, f"sharded {kind}")
    q_s, est, meter = {}, {}, _GatherMeter()
    with meter:
        est["sharded"], q_s["sharded"] = _timed_query(
            sharded.query_flows, keys, paths, range(N_EPOCHS),
            merge="fragment")
    est["twin"], q_s["twin"] = _timed_query(
        twin.query_flows, keys, paths, range(N_EPOCHS), merge="fragment")
    assert np.array_equal(est["sharded"], est["twin"]), \
        f"sharded {kind}: estimates != the twin's"
    err_rmse = rmse(est["sharded"], sc["truth"])
    _pinned(f"sharded {kind} window 8 RMSE", err_rmse,
            RMSE_PIN[(kind, "window 8")], PIN_RTOL)
    if kind == "cs":
        _guarded(sc, f"sharded cs window {WINDOW} ({N_SHARDS} shards): "
                 f"query_flows(merge='fragment') of {len(keys)} 5-hop flows",
                 est["sharded"], q_s["sharded"],
                 lambda: sharded.query_flows(keys, paths, range(N_EPOCHS),
                                             merge="fragment"),
                 lambda e: _pinned("guarded sharded cs window 8 RMSE",
                                   rmse(e, sc["truth"]),
                                   RMSE_PIN[("cs", "window 8")], PIN_RTOL))
    _sharded_line(f"{kind} window {WINDOW}", runs, q_s, meter,
                  f"; {cells} cells == the twin's, window {WINDOW}'s shard "
                  f"groups == plain (max_abs_err {err}); {len(keys)} 5-hop "
                  f"flows == the twin's, RMSE {err_rmse!r} (pinned)")
    return runs["sharded"][1], err


def _sharded_univmon(dev, sc, mesh):
    """UnivMon (16 levels), window 8, sharded beside its twin: every cell,
    window 8's per-shard level groups against the plain version, the
    per-level estimates of all flows, and the entropy (``ENTROPY_PIN``)."""
    wl = sc["wl"]
    runs = _sharded_pair(sc, "um", mesh, n_levels=N_LEVELS)
    sharded, twin = runs["sharded"][0], runs["twin"][0]
    cells = _cells_equal(sharded.fleet, twin.fleet, "sharded um")
    err = _held_to_plain(sharded.fleet, sc["rep"], dev, "sharded um")
    q_s, ests, ent, meters = {}, {}, {}, {}
    total = float(len(wl.pkt_ts))
    for name, system in (("sharded", sharded), ("twin", twin)):
        # the entropy's own per-level estimates: the (L, K) estimates of
        # every path group that its one grouped call leaves on the card
        level = _Timed(system.fleet.um_level_window_query_groups)
        system.fleet.um_level_window_query_groups = level
        try:
            with _GatherMeter() as meters[name]:
                ent[name], q_s[name] = _timed_query(
                    system.query_entropy, wl.keys, wl.paths,
                    range(N_EPOCHS), total, n_levels=N_LEVELS,
                    level_seed=LEVEL_SEED, merge="fragment")
        finally:
            del system.fleet.um_level_window_query_groups
        (_, out), = level.calls
        ests[name] = out.cpu().numpy()
        assert ests[name].shape == (N_LEVELS, len(wl.keys))
    assert np.array_equal(ests["sharded"], ests["twin"]), \
        "sharded um: per-level estimates != the twin's"
    assert ent["sharded"] == ent["twin"], ent
    _pinned("sharded um window 8 entropy (fragment merge)", ent["sharded"],
            ENTROPY_PIN["window 8 fragment k_heavy 1024"], PIN_RTOL_F32)
    _sharded_line(f"um window {WINDOW} ({N_LEVELS} levels)", runs, q_s,
                  meters["sharded"],
                  f"; {cells} cells == the twin's, window {WINDOW}'s shard "
                  f"level groups == plain (max_abs_err {err}); (L, K) "
                  f"estimates of {len(wl.keys)} flows == the twin's; "
                  f"entropy {ent['sharded']!r} == the twin's (pinned)")
    return runs["sharded"][1], err


def _sharded_churn(sc, mesh):
    """cs, window 8, under ``churn_schedule()`` with parity groups of 5
    (shard-local for 4 shards of 5), sharded beside its twin: the lost and
    recoverable cells, ``recover()``, every cell after recovery, and all
    5-hop flows under "mask" and "recover" (``CHURN_PIN``)."""
    from repro_torch.core.fleet import parity_groups_chunked
    from repro_torch.net.simulator import rmse

    keys, paths = sc["keys"], sc["paths"]
    groups = parity_groups_chunked(range(len(sc["mems"])), PARITY_GROUP)
    runs = _sharded_pair(sc, "cs", mesh, schedule=churn_schedule,
                         fleet_kwargs={"parity_groups": groups})
    sharded, twin = runs["sharded"][0], runs["twin"][0]
    assert sharded._dead_at == twin._dead_at
    assert sharded.fleet._lost == twin.fleet._lost
    assert sharded.fleet.recoverable() == twin.fleet.recoverable() \
        == CHURN_RECOVERABLE, sharded.fleet.recoverable()
    q_s, rmses, meter = {"sharded": 0.0, "twin": 0.0}, {}, _GatherMeter()
    for failures in ("mask", "recover"):
        if failures == "recover":
            rec = {n: r[0].fleet.recover() for n, r in runs.items()}
            assert rec["sharded"] == rec["twin"] == CHURN_RECOVERABLE, rec
        est = {}
        for name, (system, _, _) in runs.items():
            with meter if name == "sharded" else _GatherMeter():
                est[name], s = _timed_query(
                    system.query_flows, keys, paths, range(N_EPOCHS),
                    merge="fragment", failures=failures)
            q_s[name] += s
        assert np.array_equal(est["sharded"], est["twin"]), failures
        rmses[failures] = rmse(est["sharded"], sc["truth"])
        _pinned(f"sharded churn cs {failures} RMSE", rmses[failures],
                CHURN_PIN[("cs", failures)], PIN_RTOL)
    cells = _cells_equal(sharded.fleet, twin.fleet, "sharded churn cs")
    _sharded_line(f"churn cs window {WINDOW}", runs, q_s, meter,
                  f"; lost {CHURN_LOST}, recovered {CHURN_RECOVERABLE} == "
                  f"the twin's; {cells} cells == the twin's after recovery;"
                  f" RMSE mask {rmses['mask']!r}, recover "
                  f"{rmses['recover']!r} == the twin's (pinned)")
    return runs["sharded"][1]


def sharded_phase(dev, sc):
    """The sharded fleet at the §6.1 setting: ``N_SHARDS`` shards of 5
    fragments on this card, each run beside its single-device twin (cs,
    cms, UnivMon, cs under churn).  Returns what the kernel line needs."""
    import torch

    from repro_torch.launch import make_switch_mesh, shard_frag_bounds

    mesh = make_switch_mesh(N_SHARDS, devices=[dev] * N_SHARDS)
    _log(f"sharded mesh: {N_SHARDS} shards on "
         f"{torch.cuda.device_count()} device(s), all on {mesh.devices[0]}; "
         f"fragment blocks {shard_frag_bounds(len(sc['mems']), N_SHARDS)}")
    res = {"ragged": 0, "max_abs_err": 0.0}
    for kind in ("cs", "cms"):
        launches, err = _sharded_window(dev, sc, kind, mesh)
        res["ragged"] += launches
        res["max_abs_err"] = max(res["max_abs_err"], err)
        torch.cuda.empty_cache()
    launches, err = _sharded_univmon(dev, sc, mesh)
    res["ragged"] += launches
    res["max_abs_err"] = max(res["max_abs_err"], err)
    torch.cuda.empty_cache()
    res["ragged"] += _sharded_churn(sc, mesh)
    torch.cuda.empty_cache()
    _log(f"sharded B1 launches of the sharded runs: {res['ragged']}")
    return res


# -- the sanitizer ------------------------------------------------------------

@contextlib.contextmanager
def _sanitizer_armed():
    """``REPRO_SANITIZE=1`` for the ``with`` body, the old value after."""
    from repro_torch import sanitize

    prev = os.environ.get(sanitize._ENV)
    os.environ[sanitize._ENV] = "1"
    try:
        yield
    finally:
        if prev is None:
            del os.environ[sanitize._ENV]
        else:
            os.environ[sanitize._ENV] = prev


def _guarded(sc, what, want, want_s, query, pin):
    """``query()`` once more with the sanitizer armed: the query plane's
    device compute under ``sanitize.transfer_guard()`` (the CUDA sync
    debug mode at "error" and the host-sync dispatch mode), on a system an
    earlier phase holds resident.  Its answer must equal the disarmed one,
    ``want``, bit for bit and hold its pin (``pin``); ``(what, armed s,
    disarmed s)`` goes to ``sc["guarded"]`` for the sanitize phase."""
    with _sanitizer_armed():
        got, s = _timed_query(query)
    assert np.array_equal(got, want), f"{what}: guarded {got!r} != {want!r}"
    pin(got)
    sc["guarded"].append((what, s, want_s))


def _one_window(sc, keys, paths):
    """A cs system that ran the first window of the §6.1 replay (one
    ``run_window`` of ``WINDOW`` epochs) and its query of ``keys``."""
    import torch

    from repro_torch.core.disketch import DiSketchSystem

    rep = sc["rep"]
    system = DiSketchSystem(sc["mems"], "cs", rho_target=RHO["cs"],
                            log2_te=LOG2_TE)
    order = system.fleet.frag_order
    system.run_window(0, [rep.epoch_stream(e) for e in range(WINDOW)],
                      packets=[rep.epoch_packet(e, order)
                               for e in range(WINDOW)])
    torch.cuda.synchronize()
    return system, system.query_flows(keys, paths, range(WINDOW),
                                      merge="fragment")


def sanitize_phase(dev, sc):
    """The sanitizer (``repro_torch.sanitize``, armed by
    ``REPRO_SANITIZE=1``) on the card.  (a) The guarded §6.1 queries the
    window, UnivMon and sharded phases ran on their resident systems (cs
    window 8, the UnivMon entropy with the device G-sum, 4 shards), each
    equal to its disarmed answer with its pin held.  (b) Positive
    controls: a host read, an upload and a boolean-mask index each raise
    under the armed guard, the sync debug mode is put back after each, and
    the copy out after the guard works.  (c) The load counter: with
    ``build.load``'s cache cleared, a guarded replay of one cs window with
    its query loads B1's library exactly once, and a second one loads
    nothing and answers the same; that window's groups == the plain
    version.  (d) The cost: the guarded queries' times beside the disarmed
    ones.  Returns what the kernel line needs."""
    import torch

    from repro_torch import sanitize
    from repro_torch.kernels import build
    from repro_torch.kernels.sketch_update import fleet as FK

    smi = _nvidia_smi()
    # (a) the guarded full-scale queries of the earlier phases
    names = [what.split(":")[0] for what, _, _ in sc["guarded"]]
    assert names == [f"cs window {WINDOW}", f"um window {WINDOW}",
                     f"sharded cs window {WINDOW} ({N_SHARDS} shards)"], names
    for what, s, s0 in sc["guarded"]:
        _log(f"sanitize guarded {what}: {s:.3f} s armed against {s0:.3f} s "
             "disarmed; == the disarmed answer bit for bit, pin held")

    # (b) positive controls: each leak raises under the armed guard
    t = torch.arange(16, dtype=torch.float32, device=dev)
    mode0 = torch.cuda.get_sync_debug_mode()
    controls = {"t.sum().item()": lambda: t.sum().item(),
                "torch.tensor(1.0, device='cuda')":
                    lambda: torch.tensor(1.0, device=dev),
                "t[t > 3]": lambda: t[t > 3]}
    caught = {}
    with _sanitizer_armed():
        for name, leak in controls.items():
            try:
                with sanitize.transfer_guard():
                    leak()
            except RuntimeError as e:
                caught[name] = (f"{type(e).__name__}: "
                                f"{str(e).splitlines()[0][:90]}")
            else:
                raise AssertionError(f"sanitize: {name} did not raise under "
                                     "the armed guard")
            assert torch.cuda.get_sync_debug_mode() == mode0, name
        with sanitize.transfer_guard():
            assert torch.cuda.get_sync_debug_mode() == 2
            y = torch.where(t > 3, 2 * t, 0.0)
        out = y.cpu().numpy()            # the explicit copy out, after it
    assert out.tolist() == [0.0] * 4 + [2.0 * i for i in range(4, 16)]
    for name, why in caught.items():
        _log(f"sanitize control {name} under the armed guard: raised {why}")

    # (c) the load counter: one load of B1's library, then none
    keys, paths = sc["keys"], sc["paths"]
    build.load.cache_clear()
    reset_counts()
    h0 = time.perf_counter()
    with _sanitizer_armed():
        snap = sanitize.trace_snapshot()
        first, est1 = _one_window(sc, keys, paths)
        loads1 = sanitize.traces_since(snap)
        snap = sanitize.trace_snapshot()
        second, est2 = _one_window(sc, keys, paths)
        loads2 = sanitize.traces_since(snap)
    replay_s = time.perf_counter() - h0
    counts = read_counts()
    assert loads1 == {"build.fleet_ragged": 1}, loads1
    assert loads2 == {}, loads2
    assert np.array_equal(est1, est2) and np.isfinite(est1).all()
    launches = counts["fleet_ragged"]
    assert launches > 0 and counts["sketch_update"] == \
        counts["fleet_dense"] == 0, counts
    err = 0.0
    for (args, kw), (_, got) in zip(_window_groups(second.fleet, sc["rep"], 0),
                                    second.fleet._window_bufs[0][0].device(),
                                    strict=True):
        plain = FK.fleet_update_ragged_ref(*_to_device(args, dev), **kw)
        got = got.reshape(plain.shape)
        err = max(err, float((got - plain).abs().max()))
        assert torch.equal(got, plain), "sanitize window != plain version"
        del plain
    del first, second
    torch.cuda.empty_cache()

    # (d) the cost
    armed = sum(s for _, s, _ in sc["guarded"])
    disarmed = sum(s0 for _, _, s0 in sc["guarded"])
    _log(f"sanitize [{smi}]: controls raised {len(caught)} of "
         f"{len(controls)}; loads after cache_clear {loads1}, then "
         f"{loads2}; two guarded one-window replays with their queries of "
         f"{len(keys)} 5-hop flows {replay_s:.2f} s, B1 launches {launches}, "
         f"window groups == plain (max_abs_err {err}); guarded queries "
         f"{armed:.3f} s against {disarmed:.3f} s disarmed (+"
         f"{armed - disarmed:.3f} s, run in the earlier phases)")
    return dict(ragged=launches, max_abs_err=err)


# -- the model serving path --------------------------------------------------

def _close(what, got, want, rtol, atol, chunk=512):
    """Fail unless ``got`` is within ``atol + rtol * |want|`` of ``want``
    everywhere (compared in position chunks along dim 1, to bound the
    temporaries at full width); returns the largest absolute error."""
    worst, ratio = 0.0, 0.0
    for lo in range(0, want.shape[1], chunk):
        g, w = got[:, lo:lo + chunk], want[:, lo:lo + chunk]
        if not bool(g.isfinite().all()):
            raise AssertionError(f"{what}: non-finite values")
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        ratio = max(ratio, float((err / (atol + rtol * w.abs())).max()))
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: off by {worst:.3g} (> {atol} + "
                             f"{rtol} x |want|, ratio {ratio:.3g})")
    return worst


def _serve_reduced(dev):
    """(a) Every family at ``reduced`` on the card against the port on the
    CPU with the same (numpy-seeded) weights: forward, prefill, and a
    decode step after a prefill of S - 1 tokens (MoE capacity E/K)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, list_configs, reduced
    from repro_torch.models import convert
    from repro_torch.models import model as PM

    b, s, cpu, worst = 2, 32, torch.device("cpu"), 0.0
    for name in list_configs():
        cfg = reduced(get_config(name))
        if cfg.n_experts:
            cfg = dataclasses.replace(
                cfg, moe_capacity_factor=float(cfg.n_experts / cfg.top_k))
        host = PM.init_params(np.random.default_rng(0), cfg,
                              dtype=torch.float32, device=cpu)
        card = convert.from_numpy(convert.to_numpy(host), dev)
        rng = np.random.default_rng(1)
        x = torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
            if cfg.embed_inputs else rng.integers(0, cfg.vocab, (b, s)))

        def run(params, x):
            out = [PM.forward(params, x, cfg)[0]]
            st = PM.init_decode_state(params, cfg, b, s, dtype=torch.float32)
            out.append(PM.prefill(params, x, cfg, st)[0])
            st = PM.init_decode_state(params, cfg, b, s, dtype=torch.float32)
            _, st = PM.prefill(params, x[:, :s - 1], cfg, st)
            tok = x[:, s - 1:s] if cfg.embed_inputs else x[:, s - 1]
            out.append(PM.decode_step(params, tok, cfg, st)[0][:, None])
            return out

        errs = [_close(f"serve {name} {what}", g.cpu(), w, tol, tol)
                for what, g, w, tol in zip(
                    ("forward", "prefill", "decode"), run(card, x.to(dev)),
                    run(host, x), (2e-4, 2e-4, 3e-4))]
        worst = max(worst, *errs)
        _log(f"serve   {name} (reduced): card == CPU, max |err| forward "
             f"{errs[0]:.3g}, prefill {errs[1]:.3g}, decode {errs[2]:.3g}")
    return worst


def _serve_full(dev):
    """(b) gemma2-2b at full width and depth, weights from a
    ``torch.Generator`` on the card: the server at the reference server's
    defaults (a cold run, then the measured one), then teacher forcing."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import convert
    from repro_torch.models import model as PM

    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    h0 = time.perf_counter()
    params = PM.init_params(gen, cfg, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in convert.flatten(params).values())
    _log(f"serve   {SERVE_ARCH} full width: {cfg.n_layers} layers, d_model "
         f"{cfg.d_model}, vocab {cfg.vocab}; {n} f32 parameters ({4 * n} B; "
         f"cfg.n_params() {cfg.n_params()}), drawn on the card in "
         f"{time.perf_counter() - h0:.1f} s")
    out = {"params": n, "weight_bytes": 4 * n}
    for run in ("cold", "measured"):
        rng = np.random.RandomState(0)
        reqs = [SV.Request(i, rng.randint(0, cfg.vocab, size=SERVE_PROMPT_LEN
                                          ).astype(np.int32), SERVE_MAX_NEW,
                           t_enqueue=time.perf_counter())
                for i in range(SERVE_REQUESTS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done, stats = SV.serve(cfg, params, reqs, SERVE_BATCH, SERVE_MAX_LEN,
                               dev)
        m = SV.summary(done, stats, time.perf_counter() - t0)
        m["peak_bytes"] = torch.cuda.max_memory_allocated()
        if m["requests"] != SERVE_REQUESTS or m["tokens"] != \
                SERVE_REQUESTS * SERVE_MAX_NEW or not all(
                    0 <= t < cfg.vocab for r in done for t in r.out):
            raise AssertionError(f"serve: {m['requests']} requests, "
                                 f"{m['tokens']} tokens")
        _log(f"serve   {run}: {m['requests']} requests, {m['tokens']} tokens "
             f"in {m['seconds']:.3f} s, {m['tok_per_s']:.1f} tok/s, "
             f"{m['steps']} decode steps; TTFT p50 {m['ttft_p50_s']:.4f} s, "
             f"latency p50 {m['latency_p50_s']:.4f} s p99 "
             f"{m['latency_p99_s']:.4f} s; {m['step_ms']:.3f} ms a decode "
             f"step (batch {SERVE_BATCH}), {m['prefill_ms']:.3f} ms a "
             f"prefill ({SERVE_BATCH} x {SERVE_PROMPT_LEN}); peak "
             f"{m['peak_bytes']} B")
    out["server"] = m
    out["profile"] = _decode_profile(cfg, params)
    out["teacher"] = _teacher_forcing(dev, cfg, params)
    return out


def _decode_profile(cfg, params, steps=8):
    """``steps`` decode steps of the server's batch under torch.profiler:
    the device's busy share of the wall time and the heaviest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as PM

    dev = params["embed"].device
    state = PM.init_decode_state(params, cfg, SERVE_BATCH, SERVE_MAX_LEN,
                                 dtype=torch.float32)
    _, state = PM.prefill(params, torch.zeros(
        (SERVE_BATCH, SERVE_PROMPT_LEN), dtype=torch.long, device=dev), cfg,
        state)
    tok = torch.zeros(SERVE_BATCH, dtype=torch.long, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        for _ in range(steps):
            _, state = PM.decode_step(params, tok, cfg, state)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - h0)
    ev = _device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:4]
    _log(f"serve   profile of {steps} decode steps (batch {SERVE_BATCH}): "
         f"device busy {busy_ms:.3f} of {wall_ms:.3f} ms wall "
         f"({100 * busy_ms / wall_ms:.1f}%, profiler on), "
         f"{sum(e.count for e in ev)} device events; heaviest: " + "; ".join(
             f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x"
             f"{e.count}" for e in top))
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "steps": steps,
            "events": sum(e.count for e in ev)}


def _teacher_forcing(dev, cfg, params):
    """Prefill of SERVE_TF tokens == forward, and SERVE_TF_STEPS decode
    steps == forward at their positions (2e-4 and 3e-4)."""
    import torch

    from repro_torch.models import model as PM

    t = SERVE_TF + SERVE_TF_STEPS
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, t))).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    h0 = time.perf_counter()
    want, _ = PM.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    fwd_ms = 1e3 * (time.perf_counter() - h0)
    state = PM.init_decode_state(params, cfg, 1, t, dtype=torch.float32)
    h0 = time.perf_counter()
    got, state = PM.prefill(params, tokens[:, :SERVE_TF], cfg, state)
    torch.cuda.synchronize()
    pre_ms = 1e3 * (time.perf_counter() - h0)
    err_p = _close("serve prefill == forward", got, want[:, :SERVE_TF],
                   2e-4, 2e-4)
    del got
    err_d, step_ms = 0.0, []
    for i in range(SERVE_TF_STEPS):
        h0 = time.perf_counter()
        logits, state = PM.decode_step(params, tokens[:, SERVE_TF + i], cfg,
                                       state)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - h0))
        err_d = max(err_d, _close(
            f"serve decode step {i} == forward", logits[:, None],
            want[:, SERVE_TF + i:SERVE_TF + i + 1], 3e-4, 3e-4))
    peak = torch.cuda.max_memory_allocated()
    _log(f"serve   teacher forcing, {SERVE_TF} + {SERVE_TF_STEPS} tokens "
         f"(local window {cfg.local_window}): forward {fwd_ms:.1f} ms, "
         f"prefill {pre_ms:.1f} ms, max |err| {err_p:.3g} (2e-4); "
         f"{SERVE_TF_STEPS} decode steps at {SERVE_TF}+ context, median "
         f"{float(np.median(step_ms)):.3f} ms, max |err| {err_d:.3g} "
         f"(3e-4); peak {peak} B")
    return {"forward_ms": fwd_ms, "prefill_ms": pre_ms, "prefill_err": err_p,
            "decode_err": err_d, "decode_ms": float(np.median(step_ms)),
            "peak_bytes": peak}


def _serve_pinned(dev):
    """(c) gemma2-2b at full width cut to SERVE_LAYERS layers, numpy-seeded
    weights, held to the reference's SERVE_PIN."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as PM

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    h0 = time.perf_counter()
    params = PM.init_params(np.random.default_rng(SERVE_SEED), cfg,
                            dtype=torch.float32, device=dev)
    init_s = time.perf_counter() - h0
    prompt = torch.from_numpy(np.random.default_rng(SERVE_SEED + 1).integers(
        0, cfg.vocab, (1, SERVE_PROMPT))).to(dev)
    state = PM.init_decode_state(params, cfg, 1, SERVE_PROMPT,
                                 dtype=torch.float32)
    logits, _ = PM.prefill(params, prompt, cfg, state)
    last = logits[0, -1].double().cpu().numpy()
    top = np.argsort(-last, kind="stable")[:len(SERVE_PIN["ids"])]
    if top.tolist() != SERVE_PIN["ids"]:
        raise AssertionError(f"SERVE_PIN: top ids {top.tolist()} against "
                             f"the reference's {SERVE_PIN['ids']}")
    rel = 0.0
    for i, want in zip(top, SERVE_PIN["logits"]):
        _pinned(f"SERVE_PIN logit {i}", float(last[i]), want, SERVE_PIN_RTOL)
        rel = max(rel, abs(float(last[i]) - want) / abs(want))
    _log(f"serve   SERVE_PIN: {SERVE_LAYERS}-layer full-width {SERVE_ARCH}, "
         f"numpy-seeded weights ({init_s:.1f} s to draw and copy): top-8 ids "
         f"== the reference's, logits within {rel:.3g} relative "
         f"({SERVE_PIN_RTOL})")
    return rel, params


def serve_phase(dev):
    """The model serving path: (a) every family at ``reduced`` on the card
    == on the CPU; (b) full-width gemma2-2b: the server and teacher
    forcing; (c) ``SERVE_PIN``.  The path runs torch ops only: no launch of
    B1, B2 or B3.  Returns ``{"pin_params": ...}``: (c)'s numpy-seeded
    weights, which the train phase's ``TRAIN_PIN`` starts from."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    _log(f"serve   torch.backends.cuda.matmul.allow_tf32 = {tf32}")
    if tf32:
        raise AssertionError("TF32 matmuls are on: f32 would not mean f32")
    reset_counts()
    res = {"reduced_err": _serve_reduced(dev)}
    torch.cuda.empty_cache()
    res.update(_serve_full(dev))
    torch.cuda.empty_cache()
    res["pin_rel"], params = _serve_pinned(dev)
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"serve launched sketch kernels: {counts}")
    _log(f"serve   sketch kernel launches on the serving path: {counts}")
    _log(json.dumps({"serve": res}))
    return {"pin_params": params}


# -- the training path ---------------------------------------------------------

def _mostly_close(what, got, want, rtol, lr_sum=None, per_leaf=True,
                  frac=0.0):
    """Coordinates of ``got`` off ``want`` by more than ``rtol`` of their
    leaf's (``per_leaf=False``: the whole tree's) largest |value|: fail
    if more than ``frac`` of them are, or (with ``lr_sum``) if any is off
    by more than ``2 * lr_sum``.  Returns (coordinates off, worst error
    over the scale).  Adam divides by sqrt(v_hat) + eps, so a parameter
    whose gradient cancels to the eps scale takes a learning-rate-sized
    step whose size follows its rounding; and a compressed step keeps or
    leaves an estimate within rounding of its threshold."""
    wants = [w.float() for w in want]
    top = max(float(w.abs().max()) for w in wants)
    off = n = 0
    worst = 0.0
    for g, w in zip(got, wants):
        scale = max(float(w.abs().max()) if per_leaf else top, 1e-30)
        err = (g.float().cpu() - w).abs()
        off += int((err > rtol * scale).sum())
        n += err.numel()
        worst = max(worst, float(err.max()) / scale)
        if lr_sum is not None and not float(err.max()) <= 2 * lr_sum:
            raise AssertionError(f"{what}: off by {float(err.max())} > 2 x "
                                 f"the learning rates ({lr_sum})")
    if not off <= frac * n:
        raise AssertionError(f"{what}: {off} of {n} coordinates off by more "
                             f"than {rtol} of the largest |value|")
    return off, worst


def _kept_band(comp, grads, resid, step, rel=1e-5):
    """One ``apply`` of ``comp`` on these inputs, without changing them:
    (coordinates kept, estimates within ``rel`` of the threshold, the
    threshold)."""
    import torch

    from repro_torch.tree import leaves

    flat_g, flat_r = leaves(grads), leaves(resid)
    cur = step % comp.n_sub
    sk = torch.zeros((comp.depth, comp.width), dtype=torch.float32,
                     device=flat_g[0].device)
    for acc, idx, active, _ in comp._passes(flat_g, flat_r, cur):
        comp.sketch(acc, idx, active, out=sk)
    thresh = comp.kth_largest(comp.k_of(sum(g.numel() for g in flat_g)),
                              lambda: comp._magnitudes(sk, flat_g, flat_r,
                                                       cur))
    kept = band = 0
    for mag in comp._magnitudes(sk, flat_g, flat_r, cur):
        kept += int(((mag >= thresh) & (mag > 0)).sum())
        band += int(((mag - thresh).abs() <= rel * thresh).sum())
    return kept, band, float(thresh)


def _train_arch(dev, name):
    """One family at ``reduced``: TRAIN_A_STEPS steps of
    ``make_train_step`` on the card and on the CPU from the same
    numpy-seeded weights and batches; with the compressor (TRAIN_A_COMPRESS)
    its first step's selection also runs alone on both from the same
    inputs."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import make_compressor
    from repro_torch.models import model as PM
    from repro_torch.train import optimizer as PO
    from repro_torch.train import train_step as PT
    from repro_torch.tree import leaves, tree_map

    cpu, b, s = torch.device("cpu"), 2, 32
    cfg = reduced(get_config(name))
    host = PM.init_params(np.random.default_rng(0), cfg, dtype=torch.float32,
                          device=cpu)
    compress = name in TRAIN_A_COMPRESS
    comp = make_compressor(sum(p.numel() for p in leaves(host))) \
        if compress else None
    data = SyntheticLM(cfg.vocab, s, b, seed=0)
    batches = []
    for i in range(TRAIN_A_STEPS):
        bt = {k: torch.from_numpy(v).long() for k, v in data.batch(i).items()}
        if cfg.embed_inputs:
            bt["tokens"] = torch.from_numpy(np.random.default_rng(
                i).standard_normal((b, s, cfg.d_model), dtype=np.float32))
        batches.append(bt)
    if compress:
        grads, _, _ = PT.grads_of(host, batches[0]["tokens"],
                                  batches[0]["labels"], cfg, remat=True)
        zero = comp.init(host).residual
        kb = [_kept_band(comp, tree_map(lambda t: t.to(where), grads),
                         tree_map(lambda t: t.to(where), zero), 0)
              for where in (cpu, dev)]
        if abs(kb[0][0] - kb[1][0]) > kb[0][1] + kb[1][1]:
            raise AssertionError(
                f"compressor kept {kb[1][0]} on the card, {kb[0][0]} on the "
                f"CPU, more apart than the {kb[0][1]} + {kb[1][1]} estimates "
                f"within 1e-5 of the threshold")
    # Each step starts on both devices from the CPU run's state (copied
    # to the card before the CPU step writes it in place), so the card is
    # held to the same function on the same inputs every step; a
    # trajectory would compound Adam's eps-scale coordinates (and MoE
    # routing near ties) into later steps.
    step = PT.make_train_step(cfg, PO.cosine_schedule(1e-3, 0, 10),
                              compressor=comp)
    c_st = PT.init_train_state(tree_map(lambda t: t.clone(), host), comp)
    hist, worst, off, moments = [], 0.0, 0, [(0, 0.0), (0, 0.0)]
    for i, bt in enumerate(batches):
        g_st, g_m = step(tree_map(lambda t: t.to(dev, copy=True), c_st),
                         {k: v.to(dev) for k, v in bt.items()})
        c_st, c_m = step(c_st, bt)
        hist.append({k: float(v) for k, v in c_m.items()})
        for k in ("loss", "grad_norm"):
            _pinned(f"step {i} {k} (card vs CPU)", float(g_m[k]),
                    float(c_m[k]), 1e-5)
        lr = hist[-1]["lr"]
        mo = [_mostly_close(w, leaves(getattr(g_st.opt, w)),
                            leaves(getattr(c_st.opt, w)), 5e-5, frac=1e-4)
              for w in ("m", "v")]
        o, w_ = _mostly_close("params", leaves(g_st.params),
                              leaves(c_st.params), 1e-5, lr_sum=lr,
                              per_leaf=False, frac=1e-4)
        off, worst = max(off, o), max(worst, w_)
        moments = [(max(a[0], b_[0]), max(a[1], b_[1]))
                   for a, b_ in zip(moments, mo)]
        del g_st
    n = sum(p.numel() for p in leaves(c_st.params))
    extra = (f"; compressor kept {kb[1][0]} on the card, {kb[0][0]} on the "
             f"CPU (within 1e-5 of the threshold: {kb[1][1]}, {kb[0][1]})"
             ) if compress else ""
    _log(f"train   {name} (reduced{', compressed' if compress else ''}): "
         f"card == CPU at each of {TRAIN_A_STEPS} steps, losses "
         f"{[round(h['loss'], 5) for h in hist]}; params: at most {off} of "
         f"{n} off by > 1e-5 of max (worst {worst:.3g}); m, v: "
         f"{moments[0][0]} and {moments[1][0]} off by > 5e-5 of their leaf's "
         f"max (worst {max(mo[1] for mo in moments):.3g}){extra}")
    return {"params_off": off, "params_worst": worst,
            "moments_off": [mo[0] for mo in moments],
            "moments_worst": max(mo[1] for mo in moments)}


def _train_reduced(dev):
    """(a) Every family at ``reduced``, card == CPU (``_train_arch``);
    every family runs before a failure is raised."""
    from repro_torch.configs import list_configs

    out, failed = {}, []
    for name in list_configs():
        try:
            out[name] = _train_arch(dev, name)
        except AssertionError as e:
            _log(f"train   {name} (reduced): FAILED {e}")
            failed.append(f"{name}: {e}")
    if failed:
        raise AssertionError("train (a): " + "; ".join(failed))
    return out


def _pin_steps(dev, cfg, params):
    """TRAIN_STEPS steps of ``make_train_step`` from ``params`` (updated
    in place): each step's loss and grad norm, and ``final_norm`` and its
    AdamW moment m after the steps (f64 numpy)."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import optimizer as PO
    from repro_torch.train import train_step as PT

    step = PT.make_train_step(cfg, PO.cosine_schedule(
        TRAIN_LR, TRAIN_STEPS // 10, TRAIN_STEPS))
    state = PT.init_train_state(params)
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=TRAIN_SEED)
    hist = []
    for i in range(TRAIN_STEPS):
        state, m = step(state, {k: torch.from_numpy(v).long().to(dev)
                                for k, v in data.batch(i).items()})
        hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return (hist, state.params["final_norm"].double().cpu().numpy(),
            state.opt.m["final_norm"].double().cpu().numpy())


def _pin_errors(hist, norm, m):
    """Relative errors of a ``_pin_steps`` run against TRAIN_PIN: losses
    and grad norms (the worst), final_norm's and m's sampled entries (L2
    of the difference over the pin's, and the worst entry over the
    largest), final_norm's L2 norm."""
    at = list(TRAIN_NORM_AT)
    out = {"rel": max(abs(h[k] - TRAIN_PIN[k][i]) / abs(TRAIN_PIN[k][i])
                      for i, h in enumerate(hist)
                      for k in ("loss", "grad_norm")),
           "final_norm_l2": abs(float(np.linalg.norm(norm))
                                / TRAIN_PIN["final_norm_l2"] - 1)}
    for name, got in (("final_norm", norm[at]), ("m", m[at])):
        want = np.asarray(TRAIN_PIN[name])
        out[f"{name}_err"] = float(np.linalg.norm(got - want)
                                   / np.linalg.norm(want))
        out[f"{name}_worst"] = float(np.abs(got - want).max()
                                     / np.abs(want).max())
    return out


def _train_pinned(dev, params):
    """(c) TRAIN_PIN: SERVE_PIN's 2-layer full-width gemma2-2b (its f32
    weights, on the card), TRAIN_STEPS steps of ``make_train_step``; then
    the control, the same steps from a copy of the weights with TF32
    matmuls, which m's limit must catch."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SERVE_LAYERS)
    copy = tree_map(lambda t: t.clone(), params)
    hist, norm, m = _pin_steps(dev, cfg, params)
    del params
    for i, h in enumerate(hist):
        for k in ("loss", "grad_norm"):
            _pinned(f"TRAIN_PIN {k} {i}", h[k], TRAIN_PIN[k][i],
                    TRAIN_PIN_RTOL)
    _pinned("TRAIN_PIN final_norm l2", float(np.linalg.norm(norm)),
            TRAIN_PIN["final_norm_l2"], TRAIN_PIN_RTOL)
    err = _pin_errors(hist, norm, m)
    # The updated entries follow Adam's per-entry division by
    # sqrt(v_hat): each is about -lr sign(g), its error the learning rate
    # times its own gradient's relative error; so they are held as a
    # vector.  m is linear in the gradients.
    if not err["final_norm_err"] <= TRAIN_PIN_RTOL:
        raise AssertionError(f"TRAIN_PIN final_norm: its entries off by "
                             f"{err['final_norm_err']:.3g} relative (L2; > "
                             f"{TRAIN_PIN_RTOL})")
    if not err["m_err"] <= TRAIN_PIN_M_RTOL:
        raise AssertionError(f"TRAIN_PIN m: its entries off by "
                             f"{err['m_err']:.3g} relative (L2; > "
                             f"{TRAIN_PIN_M_RTOL})")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = _pin_errors(*_pin_steps(dev, cfg, copy))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del copy
    if not ctl["m_err"] > TRAIN_PIN_M_RTOL:
        raise AssertionError(f"TRAIN_PIN m: the TF32 control is within "
                             f"{ctl['m_err']:.3g} of the pin, inside the "
                             f"limit {TRAIN_PIN_M_RTOL}: the pin cannot tell "
                             f"its gradients from f32 ones")
    for what, e in (("f32", err), ("TF32 control", ctl)):
        _log(f"train   TRAIN_PIN ({what}): {SERVE_LAYERS}-layer full-width "
             f"{SERVE_ARCH}, {TRAIN_STEPS} steps at {TRAIN_BATCH} x "
             f"{TRAIN_SEQ}: losses and grad norms within {e['rel']:.3g} "
             f"relative; final_norm's entries within "
             f"{e['final_norm_err']:.3g} (L2; the worst entry "
             f"{e['final_norm_worst']:.3g} of the largest), its L2 norm "
             f"within {e['final_norm_l2']:.3g} ({TRAIN_PIN_RTOL}); m within "
             f"{e['m_err']:.3g} (L2; the worst entry {e['m_worst']:.3g} of "
             f"the largest; {TRAIN_PIN_M_RTOL})")
    return {**err, "control": ctl}


def _step_line(what, h, n):
    share = 6 * n * h["tokens_per_s"] / BF16_PEAK
    extra = (f"; compressor {h['compress_ms']:.1f} ms, k {h['k']}, kept "
             f"{h['kept']} ({h['tied']} at the threshold)"
             if "k" in h else "")
    _log(f"train   {what} step {h['step']}: loss {h['loss']:.6f}, grad norm "
         f"{h['grad_norm']:.6f}, {h['ms']:.2f} ms, {h['tokens_per_s']:.1f} "
         f"tokens/s, {100 * share:.2f}% of the bf16 dense peak (6 N tokens "
         f"/ time, N = {n}, {BF16_PEAK:.3g} FLOP/s), peak "
         f"{h['peak_bytes']} B{extra}")


def _profile_summary(prof, step_ms):
    """The device's busy share of one profiled train step and where its
    time goes (matmul kernels, AdamW's ``multi_tensor_apply`` kernels, the
    rest)."""
    ev = _device_events(prof)
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    kinds = {"matmul": 0.0, "adamw": 0.0, "other": 0.0}
    for e in ev:
        name = e.key.lower()
        kind = "adamw" if "multi_tensor_apply" in name else "matmul" if any(
            w in name for w in ("gemm", "cutlass", "xmma", "nvjet")) \
            else "other"
        kinds[kind] += e.self_device_time_total / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    _log(f"train   profile of full step {TRAIN_FULL['steps']} "
         f"({TRAIN_FULL['batch']} x {TRAIN_FULL['seq']}, profiler on): "
         f"device busy {busy:.1f} of {step_ms:.1f} ms (CUDA events; "
         f"{100 * busy / step_ms:.1f}%), {sum(e.count for e in ev)} device "
         f"events; matmul kernels {kinds['matmul']:.1f} ms, AdamW's foreach "
         f"kernels {kinds['adamw']:.1f} ms, the rest {kinds['other']:.1f} "
         f"ms; heaviest: " + "; ".join(
             f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms x"
             f"{e.count}" for e in top))
    return {"busy_ms": busy, "step_ms": step_ms, **kinds,
            "events": sum(e.count for e in ev)}


def _train_full(dev, ceiling):
    """(b) gemma2-2b at full width and depth, bf16, through
    ``launch/train.py::train``: TRAIN_FULL, its last step under
    torch.profiler (started and stopped by the step log lines), then
    TRAIN_COMPRESS, then a checkpoint after step TRAIN_RESTART_AT of a
    TRAIN_FULL run and a restart, whose next loss must be TRAIN_FULL's.
    Each run must start with at most ``ceiling`` bytes held on the card:
    more means an earlier run's tensors are still alive."""
    import math
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT
    from repro_torch.tree import leaves

    cfg = get_config(TRAIN_ARCH)
    out, counted, held = {}, [], []

    def quiet(msg):
        if not msg.startswith("step "):
            _log(f"train   {msg}")

    last = TRAIN_FULL["steps"]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def profiling(msg):          # train() logs each step after it ends
        quiet(msg)
        if msg.startswith(f"step {last - 1:5d} "):
            prof.start()
        elif msg.startswith(f"step {last:5d} "):
            prof.stop()

    def run(what, log=quiet, **kw):
        torch.cuda.empty_cache()
        held.append(torch.cuda.memory_allocated(dev))
        if held[-1] > ceiling:
            raise AssertionError(
                f"train {what}: {held[-1]} B held on the card before the "
                f"run, more than the {ceiling} B at the phase's start: an "
                f"earlier run's tensors are still alive")
        h0 = time.perf_counter()
        state, hist = LT.train(cfg, seed=0, log_every=1, device=dev,
                               log=log, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - h0
        counted.append(sum(p.numel() for p in leaves(state.params)))
        del state
        torch.cuda.empty_cache()
        for h in hist:
            if not (math.isfinite(h["loss"]) and math.isfinite(
                    h["grad_norm"])):
                raise AssertionError(f"train {what}: step {h['step']} {h}")
            _step_line(what, h, counted[-1])
        return hist, wall

    full, wall = run("full", log=profiling, **TRAIN_FULL)
    if not abs(full[0]["loss"] - math.log(cfg.vocab)) < 1.0:
        raise AssertionError(f"train full: first loss {full[0]['loss']} "
                             f"is not near ln(vocab) {math.log(cfg.vocab)}")
    steady = [h["ms"] for h in full[1:-1]]    # not the first, not profiled
    out["full"] = {"ms_median": float(np.median(steady)),
                   "tokens_per_s": TRAIN_FULL["batch"] * TRAIN_FULL["seq"]
                   / (float(np.median(steady)) / 1e3),
                   "peak_bytes": max(h["peak_bytes"] for h in full),
                   "wall_s": wall}
    out["full"]["peak_share"] = 6 * counted[0] * \
        out["full"]["tokens_per_s"] / BF16_PEAK
    out["profile"] = _profile_summary(prof, full[-1]["ms"])
    del prof
    comp, wall = run("compressed", **TRAIN_COMPRESS)
    for h in comp:
        if not h["k"] <= h["kept"] < h["k"] + h["tied"]:
            raise AssertionError(
                f"train compressed step {h['step']}: kept {h['kept']} with "
                f"{h['tied']} at the threshold, k {h['k']}: the threshold "
                f"is not the k-th largest estimate")
    out["compressed"] = {"ms": [h["ms"] for h in comp],
                         "compress_ms": [h["compress_ms"] for h in comp],
                         "k": comp[0]["k"],
                         "kept": [h["kept"] for h in comp],
                         "tied": [h["tied"] for h in comp],
                         "peak_bytes": max(h["peak_bytes"] for h in comp),
                         "wall_s": wall}
    d = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        first, wall1 = run("preempted", ckpt_dir=d,
                           ckpt_every=TRAIN_RESTART_AT,
                           until=TRAIN_RESTART_AT, **TRAIN_FULL)
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs)
        rest, wall2 = run("restarted", ckpt_dir=d,
                          ckpt_every=TRAIN_RESTART_AT,
                          until=TRAIN_RESTART_AT + 1, **TRAIN_FULL)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for what, hist in (("preempted", first), ("restarted", rest)):
        for h in hist:
            want = full[h["step"] - 1]
            for k in ("loss", "grad_norm"):
                _pinned(f"train {what} step {h['step']} {k}", h[k], want[k],
                        1e-6)
    (h,) = rest
    want = full[h["step"] - 1]
    _log(f"train   restart: checkpoint of {size} B after step "
         f"{TRAIN_RESTART_AT} (the preempted run {wall1:.1f} s), restarted "
         f"run {wall2:.1f} s; step {h['step']} loss {h['loss']!r} against "
         f"the uninterrupted {want['loss']!r}, grad norm "
         f"{h['grad_norm']!r} against {want['grad_norm']!r}")
    _log(f"train   held on the card before each full-width run (full, "
         f"compressed, preempted, restarted): {held} B, at most {ceiling} "
         f"B")
    out["restart"] = {"ckpt_bytes": size, "preempted_s": wall1,
                      "restarted_s": wall2,
                      "loss_equal": h["loss"] == want["loss"]}
    out["held_bytes"] = held
    return out


def train_phase(dev, served):
    """The training path: (c) ``TRAIN_PIN`` from the serve phase's 2-layer
    weights; (a) every family at ``reduced`` on the card == on the CPU;
    (b) full-width gemma2-2b: ten steps, three compressed, a checkpoint and
    a restart.  Torch ops and autograd only: no launch of B1, B2 or B3."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    _log(f"train   torch.backends.cuda.matmul.allow_tf32 = {tf32}")
    if tf32:
        raise AssertionError("TF32 matmuls are on: f32 would not mean f32")
    reset_counts()
    # the pinned weights are the only tensors of the phase held now; each
    # full-width run must find the card back at this or below
    ceiling = torch.cuda.memory_allocated(dev) + (256 << 20)
    res = {"pin": _train_pinned(dev, served.pop("pin_params"))}
    torch.cuda.empty_cache()
    res["reduced"] = _train_reduced(dev)
    torch.cuda.empty_cache()
    res.update(_train_full(dev, ceiling))
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"train launched sketch kernels: {counts}")
    _log(f"train   sketch kernel launches on the training path: {counts}")
    _log(json.dumps({"train": res}))
    return res


def _sharding_pin():
    """(a) The port's spec tables of every arch on both production meshes
    against the reference's digests."""
    from repro_torch.configs import get_config, list_configs
    from repro_torch.launch import abstract_production_mesh
    from repro_torch.launch import shardings as SH

    got = {}
    for arch in list_configs():
        for mk in ("single", "multi"):
            got[f"{arch} {mk}"] = json_digest(SH.spec_tables(
                get_config(arch),
                abstract_production_mesh(multi_pod=mk == "multi")))
    bad = {k: (v, SHARDING_PIN.get(k)) for k, v in got.items()
           if v != SHARDING_PIN.get(k)}
    if bad or set(got) != set(SHARDING_PIN):
        raise AssertionError(f"sharding: spec tables differ from the "
                             f"reference's: {bad}")
    _log(f"sharding SHARDING_PIN held: {len(got)} tables (10 archs x "
         f"single and multi pod) equal the reference's digests")


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _sharded_serve(dev, cfg, mesh):
    """(b) serve: a prefill of SHARD_SERVE and SHARD_DECODE greedy decode
    steps, unsharded and then sharded, from the same f32 weights."""
    import torch

    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as PM
    from repro_torch.models.sharding import sharding_env

    b, s = SHARD_SERVE
    gen = torch.Generator(device=dev).manual_seed(3)
    params = PM.init_params(gen, cfg, dtype=torch.float32, device=dev)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)

    def run(p, specs=None):
        st = PM.init_decode_state(p, cfg, b, s + SHARD_DECODE,
                                  dtype=torch.float32, specs=specs)
        logits, st = PM.prefill(p, prompt, cfg, st)
        outs, toks = [logits[:, -1]], []
        tok = torch.argmax(logits[:, -1], dim=-1)
        for _ in range(SHARD_DECODE):
            toks.append(tok)
            logits, st = PM.decode_step(p, tok, cfg, st)
            outs.append(logits)
            tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        return outs, toks

    with torch.no_grad():
        run(params)                                      # warm
        (want, want_t), ms_u = _timed(lambda: run(params))
        dp = SH.place(params, SH.param_specs(params, cfg, mesh, fsdp=False),
                      mesh)
        specs = SH.decode_state_specs(cfg, b, mesh)
        with sharding_env(mesh):
            run(dp, specs)
            (got, got_t), ms_s = _timed(lambda: run(dp, specs))
    got = [g.full_tensor() for g in got]
    got_t = [t.full_tensor() for t in got_t]
    if not all(torch.equal(g, w) for g, w in zip(got_t, want_t)):
        raise AssertionError("sharding serve: greedy tokens differ")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    if not err <= 2e-4:
        raise AssertionError(f"sharding serve: logits off by {err}")
    _log(f"sharding serve (1, 1) mesh, {cfg.name} full width f32: prefill "
         f"{b} x {s} + {SHARD_DECODE} decode steps; greedy tokens equal; "
         f"logits max |diff| {err!r} (bit-equal: {equal}); {ms_s:.1f} ms "
         f"sharded against {ms_u:.1f} ms unsharded")
    return {"max_abs_err": err, "bit_equal": equal, "ms": ms_s,
            "ms_unsharded": ms_u}


def _sharded_train(dev, cfg, mesh):
    """(b) train: one bf16 step at SHARD_TRAIN with remat, sp and FSDP,
    unsharded and then sharded from the same state and batch."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as PM
    from repro_torch.models.sharding import sharding_env
    from repro_torch.train.optimizer import cosine_schedule
    from repro_torch.train.train_step import init_train_state, \
        make_train_step
    from repro_torch.tree import leaves

    b, s = SHARD_TRAIN
    lr = 3e-4
    gen = torch.Generator(device=dev).manual_seed(4)
    params = PM.init_params(gen, cfg, dtype=torch.bfloat16, device=dev)
    start = [p.clone() for p in leaves(params)]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticLM(cfg.vocab, s, b, seed=7).batch(0).items()}
    step = make_train_step(cfg, cosine_schedule(lr, 0, 10), remat=True,
                           sp=True)
    state = init_train_state(params)
    (state, m_u), ms_u = _timed(lambda: step(state, batch))
    want = leaves(state.params)
    del state
    torch.cuda.empty_cache()
    from repro_torch.tree import flatten
    treedef = flatten(params)[1]
    p0 = treedef.unflatten(start)
    del params
    specs = SH.param_specs(p0, cfg, mesh, fsdp=True)
    dp = SH.place(p0, specs, mesh)
    db = SH.place(batch, SH.batch_specs_of(batch, mesh), mesh)
    with sharding_env(mesh):
        st = init_train_state(dp)
        (st, m_s), ms_s = _timed(lambda: step(st, db))
    for k in ("loss", "grad_norm"):
        _pinned(f"sharding train {k}", float(m_s[k]), float(m_u[k]),
                SHARD_TRAIN_RTOL)
    got = [p.to_local() for p in leaves(st.params)]
    top = max(float(w.float().abs().max()) for w in want)
    off = n = 0
    worst = 0.0
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        off += int((err > 1e-5 * top).sum())
        n += err.numel()
        worst = max(worst, float(err.max()))
    if not (off <= 1e-4 * n and worst <= 2 * lr):
        raise AssertionError(f"sharding train: {off} of {n} parameters off "
                             f"by more than 1e-5 of the largest, worst "
                             f"{worst}")
    _log(f"sharding train (1, 1) mesh, {cfg.name} full width bf16 {b} x "
         f"{s}, remat, sp, FSDP: loss {float(m_s['loss'])!r} against "
         f"{float(m_u['loss'])!r}, grad norm {float(m_s['grad_norm'])!r} "
         f"against {float(m_u['grad_norm'])!r}; parameters off by > 1e-5 "
         f"of the largest: {off} of {n}, worst {worst!r}; {ms_s:.1f} ms "
         f"sharded against {ms_u:.1f} ms unsharded (first step of each)")
    del st, dp, want, got, p0, start
    torch.cuda.empty_cache()
    return {"loss": float(m_s["loss"]), "params_off": off, "ms": ms_s,
            "ms_unsharded": ms_u}


def _spec_bytes(tree, specs, sizes) -> int:
    """Per-device bytes of ``tree`` (meta tensors) placed by ``specs``:
    each leaf's bytes over the product of its spec's mesh axes."""
    from repro_torch.tree import leaves

    total = 0
    for x, spec in zip(leaves(tree), leaves(specs)):
        div = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                div *= sizes[a]
        total += x.numel() * x.element_size() // div
    return total


def _cell_arg_bytes(arch, shape_name, mesh_kind) -> int:
    """A cell's per-device argument bytes from the spec tables alone."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import abstract_production_mesh, dryrun
    from repro_torch.launch import shardings as SH
    from repro_torch.models import model as PM
    from repro_torch.tree import tree_map

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = abstract_production_mesh(multi_pod=mesh_kind == "multi")
    sizes = mesh.shape
    params = PM.init_params(None, cfg, device="meta")
    pspecs = SH.param_specs(params, cfg, mesh, fsdp=shape.kind == "train")
    batch = dryrun.input_specs(arch, shape_name)
    total = _spec_bytes(params, pspecs, sizes) + _spec_bytes(
        batch, SH.batch_specs_of(batch, mesh), sizes)
    if shape.kind == "train":
        f32 = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                             device="meta"), params)
        total += 2 * _spec_bytes(f32, pspecs, sizes) + 2 * 4   # m, v, steps
    elif shape.kind == "decode":
        st = PM.init_decode_state(params, cfg, shape.global_batch,
                                  shape.seq_len)
        specs = SH.decode_state_specs(
            cfg, shape.global_batch, mesh,
            seq_shard=shape_name.startswith("long"))
        total += _spec_bytes(st.caches, specs.caches, sizes)
    return total


def _dryrun_cells():
    """(c) The dry-run of SHARD_CELLS on the card."""
    from repro_torch.launch import dryrun

    out = {}
    for (shape_name, mk), (lo, hi) in SHARD_CELLS.items():
        rec = dryrun.run_cell(SERVE_ARCH, shape_name, mk)
        if rec["status"] != "ok":
            raise AssertionError(f"sharding dry-run {shape_name} {mk}: "
                                 f"{rec['error']}\n{rec['traceback']}")
        mem = rec["memory_analysis"]
        want = _cell_arg_bytes(SERVE_ARCH, shape_name, mk)
        frac = rec["useful_flops_frac"]
        _log("sharding dryrun " + json.dumps(rec, default=str))
        _log(f"sharding dryrun {SERVE_ARCH} {shape_name} {mk} "
             f"{rec['mesh_shape']}: peak {mem['peak_bytes']} B, arguments "
             f"{mem['argument_bytes']} B (spec tables {want} B), "
             f"useful_flops_frac {frac!r} (band {lo} to {hi}), "
             f"{rec['flops']!r} FLOP a device, collectives "
             f"{rec['collective_bytes_total']} B, dominant "
             f"{rec['dominant']}; built in {rec['build_s']:.1f} s, run "
             f"{rec['run_s']:.1f} s")
        if not mem["peak_bytes"] < HBM_CARD:
            raise AssertionError(f"sharding dry-run {shape_name} {mk}: peak "
                                 f"{mem['peak_bytes']} B")
        if mem["argument_bytes"] != want:
            raise AssertionError(f"sharding dry-run {shape_name} {mk}: "
                                 f"{mem['argument_bytes']} argument bytes, "
                                 f"the spec tables give {want}")
        if not lo <= frac <= hi:
            raise AssertionError(f"sharding dry-run {shape_name} {mk}: "
                                 f"useful_flops_frac {frac} outside the "
                                 f"predicted {lo} to {hi}")
        out[f"{shape_name} {mk}"] = {
            k: rec[k] for k in ("flops", "op_bytes", "collective_bytes",
                                "collective_bytes_total", "compute_s",
                                "memory_s", "collective_s", "dominant",
                                "useful_flops_frac", "build_s", "run_s")}
        out[f"{shape_name} {mk}"]["peak_bytes"] = mem["peak_bytes"]
    return out


def sharding_phase(dev):
    """Model sharding: (a) SHARDING_PIN; (b) a world-size-1 NCCL group and
    a (1, 1) mesh of the card, full-width gemma2-2b sharded against
    unsharded (serve and train); (c) the dry-run's cells under a fake
    group of 256 and 512 ranks.  Each group is destroyed before the next
    starts.  No B1-B3 launch."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import make_host_mesh, process_group

    reset_counts()
    res = {}
    _sharding_pin()
    cfg = get_config(SERVE_ARCH)
    torch.cuda.empty_cache()
    with process_group("nccl"):
        mesh = make_host_mesh("cuda")
        res["serve"] = _sharded_serve(dev, cfg, mesh)
        torch.cuda.empty_cache()
        res["train"] = _sharded_train(dev, cfg, mesh)
        del mesh
    torch.cuda.empty_cache()
    res["dryrun"] = _dryrun_cells()
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"sharding launched sketch kernels: {counts}")
    _log(json.dumps({"sharding": res}, default=str))
    return res


def _b2_rows(params, signed):
    """``ops._launch`` keywords of the B2 loop's launches, one per row of
    an epoch's parameter table."""
    from repro_torch.kernels.sketch_update import fleet as FK

    return [dict(width=int(p[FK.PARAM_WIDTH]), n_sub=int(p[FK.PARAM_N_SUB]),
                 log2_te=LOG2_TE, col_seed=int(p[FK.PARAM_COL_SEED]),
                 sign_seed=int(p[FK.PARAM_SIGN_SEED]),
                 sub_seed=int(p[FK.PARAM_SUB_SEED]), signed=signed,
                 level=0, mitigation=False) for p in params]


def _b2_loop(t, launch):
    """The B2 loop on a sampled epoch (``t``, an ``epoch_path`` timing
    entry): one ``launch`` (``ops._launch`` or the plain version) per
    parameter row."""
    keys, vals, ts, _ = t["trect"]
    rows = _b2_rows(t["params"], t["kw"]["signed"])

    def run():
        for r, a in enumerate(rows):
            launch(keys[r], vals[r], ts[r], **a)
    return run


def epoch_kernel_timing(res, dev):
    """Times of B2 (the loop, one launch per row) and B3 at the shapes of
    the sampled cs epoch, with their plain versions and bounds.  B2's loop
    is timed eagerly (``ms``), under torch.profiler (its kernels' own
    device time) and from a CUDA graph (``device_ms``; also on the sampled
    cms epoch)."""
    from repro_torch.kernels.sketch_update import fleet as FK
    from repro_torch.kernels.sketch_update import ops
    from repro_torch.kernels.sketch_update.ref import sketch_update_ref

    t = res["timing"]["cs"]
    keys, vals, ts, params = t["trect"]
    kw = t["kw"]
    n_frags, p_max = keys.shape
    out = {"fleet_ragged": kernel_timing(t["ragged"], dev)}
    # B3: one launch over the rectangle
    ms = _time_ms(lambda: FK._launch_dense(keys, vals, ts, params, **kw))
    device_ms = _graph_ms(lambda: FK._launch_dense(keys, vals, ts, params,
                                                   **kw))
    plain_ms = _time_ms(lambda: FK.fleet_update_ref(keys, vals, ts, params,
                                                    **kw), reps=3, warmup=1)
    out_bytes = n_frags * kw["n_sub_max"] * kw["width_max"] * 4
    in_bytes = _packet_bytes(n_frags * p_max, t["live"]) + params.numel() * 4
    bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    ops_s = OPS_PER_PAIR * t["live"] / OPS_PER_S
    out["fleet_dense"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(bytes_s, ops_s),
        bound_by="bytes" if bytes_s >= ops_s else "operations")
    # B2: one launch per parameter row, as the loop makes them
    rows = _b2_rows(t["params"], kw["signed"])
    grid = ops.single_geometry(p_max)
    loop_kernel = _b2_loop(t, ops._launch)
    ms = _time_ms(loop_kernel, reps=5, warmup=1)
    wall_ms, kern_ms, n_k = _profiled(loop_kernel, "sketch_update_kernel")
    _log(f"timing  sketch_update loop: {len(rows)} launches of {grid} CTAs "
         f"({len(rows) * grid} in all); loop {ms:.3f} ms (CUDA events); "
         f"under torch.profiler the loop's wall {wall_ms:.3f} ms, its {n_k} "
         f"kernels {kern_ms:.3f} ms on the device "
         f"({1e3 * kern_ms / max(n_k, 1):.2f} us each)")
    for kind in ("cs", "cms"):
        graph = [_graph_ms(_b2_loop(res["timing"][kind], ops._launch))
                 for _ in range(2)]
        _log(f"timing  sketch_update {kind} epoch "
             f"{res['timing'][kind]['epoch']} loop of "
             f"{len(res['timing'][kind]['params'])} launches, device (zero "
             f"fills + kernels, CUDA graph, two timings): {graph[0]:.4f}, "
             f"{graph[1]:.4f} ms")
        if kind == "cs":
            device_ms = graph[0]
    loop_plain = _b2_loop(t, sketch_update_ref)
    plain_ms = _time_ms(loop_plain, reps=2, warmup=1)
    live_rows = (vals != 0).sum(dim=1).tolist()
    bytes_s = sum(_packet_bytes(p_max, n) + a["n_sub"] * a["width"] * 4
                  for a, n in zip(rows, live_rows)) / HBM_BYTES_PER_S
    out["sketch_update"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(bytes_s, ops_s),
        bound_by="bytes" if bytes_s >= ops_s else "operations")
    for name, v in out.items():
        shape = (f"{v['groups']} grouped launches" if name == "fleet_ragged"
                 else f"{n_frags}x{p_max} rectangle, n_sub_max "
                      f"{kw['n_sub_max']}")
        _timing_line(f"{name} cs epoch {t['epoch']} ({shape})", v)
    return out


def profile_replay(mems, rep, window=WINDOW, kind="cs"):
    """One more replay (same inputs as the path it repeats) under
    torch.profiler: the device's busy share of the replay's wall time, the
    kernels that fill it, and the torch ops that take host time.  What the
    profiler does not see (numpy packing, Python) is the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.disketch import DiSketchSystem

    system = DiSketchSystem(mems, kind, rho_target=RHO[kind],
                            log2_te=LOG2_TE, n_levels=N_LEVELS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        rep.run(system, window=window)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - h0
    on_dev = _device_events(prof)
    on_host = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU]
    device_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    top_dev = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:5]
    top_cpu = sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:5]
    torch_cpu_ms = sum(e.self_cpu_time_total for e in on_host) / 1e3
    what = (f"{-(-N_EPOCHS // window)} windows of {window}" if window > 1
            else f"{N_EPOCHS} epochs, per-epoch control")
    _log(f"profile {kind} replay, {what}: wall "
         f"{wall_s * 1e3:.1f} ms, device busy {device_ms:.3f} ms "
         f"({100 * device_ms / (wall_s * 1e3):.2f}% of wall), torch ops on "
         f"the host {torch_cpu_ms:.1f} ms, the rest numpy/Python")
    update = [e for e in on_dev if "fleet_ragged_kernel" in e.key
              or "fleet_dense_kernel" in e.key]
    update_ms = sum(e.self_device_time_total for e in update) / 1e3
    _log(f"profile   update kernels {update_ms:.3f} ms on the device in "
         f"{sum(e.count for e in update)} launches "
         f"({100 * update_ms / (wall_s * 1e3):.3f}% of wall)")
    for e in top_dev:
        _log(f"profile   device {e.self_device_time_total / 1e3:9.3f} ms "
             f"x{e.count:<5d} {e.key[:90]}")
    for e in top_cpu:
        _log(f"profile   host   {e.self_cpu_time_total / 1e3:9.3f} ms "
             f"x{e.count:<5d} {e.key[:90]}")


def kernel_timing(groups, dev):
    """Times of B1's grouped launches (a window's or an epoch's) at the main
    path's shapes, inputs already validated and on the card: ``ms``, CUDA
    events over back-to-back calls of each launch path (its zero fill,
    ctypes call and kernel, host included), summed over the launches;
    ``device_ms``, the device time of all their zero fills and kernels
    (``_graph_ms``); the plain version's time; the bound for the same work;
    and how hard the heaviest counters contend (``_heaviest_counters``)."""
    from repro_torch.kernels.sketch_update import fleet as FK

    launches = [(_to_device(args, dev), kw) for args, kw in groups]

    def run():
        for targs, kw in launches:
            FK._launch(*targs, **kw)

    ms = sum(_time_ms(lambda: FK._launch(*targs, **kw))
             for targs, kw in launches)
    device_ms = _graph_ms(run)
    plain_ms = bound_bytes_s = bound_ops_s = 0.0
    for (args, kw), (targs, _) in zip(groups, launches):
        plain_ms += _time_ms(lambda: FK.fleet_update_ragged_ref(*targs, **kw),
                             reps=3, warmup=1)
        keys, vals, _, params, bf = args
        live = int((vals != 0).sum())
        out_bytes = params.shape[0] * kw["n_sub_max"] * kw["width_max"] * 4
        in_bytes = _packet_bytes(len(keys), live) + params.nbytes + bf.nbytes
        bound_bytes_s += (in_bytes + out_bytes) / HBM_BYTES_PER_S
        pairs = _passing_pairs(vals, args[2], kw["n_levels"])
        bound_ops_s += OPS_PER_PAIR * pairs / OPS_PER_S
    bound_by = "bytes" if bound_bytes_s >= bound_ops_s else "operations"
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=1e3 * max(bound_bytes_s, bound_ops_s),
                bound_by=bound_by, groups=len(groups),
                contention=_heaviest_counters(launches))


def _passing_pairs(vals, ts, n_levels):
    """The (packet, level row) pairs that pass B1's level test: a live
    packet once for cs and cms, and for UnivMon once per level up to its
    own (its level id rides the ts bits from LVL_SHIFT)."""
    from repro_torch.kernels.sketch_update.kernel import (LVL_FIELD_MASK,
                                                          LVL_SHIFT)

    live = vals != 0
    if n_levels == 1:
        return int(live.sum())
    lvl = (ts[live] >> LVL_SHIFT) & LVL_FIELD_MASK
    return int((lvl.astype(np.int64) + 1).sum())


def _heaviest_counters(launches):
    """How many of the trace's adds land on one counter, the same-address
    atomics that serialise in L2: every row's monitored packets counted per
    counter (the plain version with every live value 1, unsigned).  Returns
    the most hits on one counter and the heaviest counter's share of its
    row's monitored packets (largest and median over the rows that have
    any)."""
    import torch

    from repro_torch.kernels.sketch_update import fleet as FK

    most, shares = 0, []
    for (keys, vals, ts, params, bf), kw in launches:
        hits = FK.fleet_update_ragged_ref(
            keys, (vals != 0).float(), ts, params, bf,
            **dict(kw, signed=False)).flatten(1)
        top, total = hits.max(dim=1).values, hits.sum(dim=1)
        some = total > 0
        most = max(most, int(top.max()))
        shares += (top[some] / total[some]).tolist()
        del hits
    torch.cuda.synchronize()
    return dict(most_hits=most, share_max=max(shares),
                share_median=float(np.median(shares)))


def _timing_line(what, v):
    """One kernel's timing line of the log."""
    c = v.get("contention")
    hot = (f"; heaviest counter {c['most_hits']} hits, "
           f"{100 * c['share_max']:.2f}% of its row's monitored packets "
           f"(median over rows {100 * c['share_median']:.2f}%)" if c else "")
    device = (f", device {v['device_ms']:.4f} ms (zero fill + kernel, CUDA "
              f"graph)" if v.get("device_ms") is not None else "")
    _log(f"timing  {what}: eager {v['ms']:.4f} ms (CUDA events, host "
         f"included){device}, plain version {v['plain_ms']:.3f} ms, bound "
         f"{v['bound_ms']:.4f} ms ({v['bound_by']}){hot}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import build
        # imported here, on a shallow stack: model.py imports torch._dynamo,
        # whose import keeps the importing frames alive (see model.py)
        from repro_torch.models import model  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 2
    try:
        t0 = time.perf_counter()
        smi = _nvidia_smi()
        _log(f"gpu     {smi}")
        dev = torch.device("cuda")
        b0 = time.perf_counter()
        built = build.build_all()
        _log(f"build   {len(built)} librar{'y' if len(built) == 1 else 'ies'}"
             f" in {time.perf_counter() - b0:.1f} s (parallel nvcc, sm_90a)")
        for name, info in built.items():
            _log(f"build   {name}: {info['seconds']:.1f} s")
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line:
                    _log(f"ptxas   {line.strip()}")
        worst = {"fleet_ragged": _phase(kernel_phase, dev),
                 "sketch_update": _phase(kernel_phase_single, dev),
                 "fleet_dense": _phase(kernel_phase_dense, dev)}
        sc = _phase(build_scenario)
        res = _phase(main_path, dev, sc)
        timing = res["timing"]
        _timing_line(f"fleet_ragged one cs window ({timing['groups']} "
                     f"launches)", timing)
        s_timing = res["scatter_timing"]
        _timing_line(f"csr_scatter one cs window ({s_timing['groups']} "
                     f"launches; its page-locked staging of "
                     f"{s_timing['upload_mb']:.2f} MB uploads in "
                     f"{s_timing['upload_ms']:.4f} ms)", s_timing)
        ep = _phase(epoch_path, dev, sc)
        ep_timing = _phase(epoch_kernel_timing, ep, dev)
        um_w = _phase(univmon_window, dev, sc)
        um_e = _phase(univmon_epoch, dev, sc)
        _phase(aggregated_phase, dev, sc)
        churn = _phase(churn_phase, dev, sc)
        ctrl = _phase(control_phase, dev, sc, res)
        export = _phase(export_phase, sc, res)
        chaos = _phase(chaos_phase, dev, sc, res)
        sharded = _phase(sharded_phase, dev, sc)
        san = _phase(sanitize_phase, dev, sc)
        served = _phase(serve_phase, dev)
        _phase(train_phase, dev, served)
        del served
        _phase(sharding_phase, dev)
        src = "src/repro_torch/kernels/sketch_update/csrc/"
        ref = "src/repro/kernels/sketch_update/"
        entries = [
            ("fleet_ragged", ref + "fleet.py:297",
             res["launches"] + ep["ragged"] + um_w["launches"]
             + um_e["ragged"] + churn["ragged"] + ctrl["ragged"]
             + export + chaos["ragged"] + sharded["ragged"] + san["ragged"],
             max(worst["fleet_ragged"], res["max_abs_err"],
                 um_w["max_abs_err"], churn["max_abs_err"],
                 ctrl["max_abs_err"], chaos["max_abs_err"],
                 sharded["max_abs_err"], san["max_abs_err"]), timing),
            ("sketch_update", ref + "kernel.py:419", ep["loop"] + um_e["loop"],
             max(worst["sketch_update"], ep["max_abs_err"],
                 um_e["max_abs_err"]), ep_timing["sketch_update"]),
            ("fleet_dense", ref + "fleet.py:160", ep["dense"] + churn["dense"],
             max(worst["fleet_dense"], ep["max_abs_err"],
                 churn["max_abs_err"]), ep_timing["fleet_dense"]),
            # replaces the reference's host packer, not one of its kernels
            ("csr_scatter", "src/repro/core/fleet.py:234",
             res["scatter_launches"], res["scatter_err"], s_timing),
            # the same kernel folding UnivMon levels: replaces the
            # reference's host fold as well
            ("csr_scatter_level_fold", "src/repro/core/fleet.py:159",
             um_w["scatter_launches"], um_w["scatter_err"],
             um_w["scatter_timing"]),
        ]
        line = {"kernels": [{
            "name": name, "route": "cuda",
            "source": f"{src}{name.replace('_level_fold', '')}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": t["ms"],
            "device_ms": t.get("device_ms"), "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        } for name, replaces, launches, err, t in entries]}
        _log(json.dumps(line))
        _log(f"gpu     {smi}")
        _log(f"done    in {time.perf_counter() - t0:.1f} s")
    except Exception:                  # any failed phase fails the run
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
