"""On-GPU smoke run of the PyTorch/CUDA port (neuralmelting_tpu_torch).

    python3 chip_smoke.py                     # one GPU

Phases, in order (any failed check exits non-zero):
  1. build       — compile the CUDA kernels from neuralmelting_tpu_torch/csrc
                   (one nvcc per source, all at once, then one link) and
                   print each kernel's ptxas registers and spills (none
                   allowed in B1 and B4); then g(r)'s bin pass through
                   torch.compile, at a batch of 4096-atom frames;
  LJ path (kernels B1 total, B2 sweep):
  2. small       — B1 and B2 against their plain PyTorch versions at the
                   rc=1.5 test geometry, R=3 and R=130 (two 128-replica
                   threefry tiles), and B1 on a slab with empty cells and
                   cells at count == K; every B1 (and B4) comparison also
                   holds two kernel calls on the same inputs to the same
                   bits;
  3. full        — the same at the north-star geometry: LJ, 4096 atoms
                   (16x8x8 fcc cells), a 32x32 (P,T) grid, R=1024; CUDA-event
                   times of each kernel beside its plain version;
  4. main        — melting_pipeline(engine="cellmc") on the default device
                   (the card) at that configuration with a short schedule;
                   B1/B2 launch counters are zeroed before and read after,
                   and each kernel must have run;
  5. physics     — the docs/VALIDATION.md LJ config (256 atoms, P*=(1,5),
                   12 temperatures) through the port as the chains of
                   seeds 7-14 (7 the document's): every chain diag 0 and
                   the chains' mean T_m(P*=1) within 2% of 0.78; printed
                   beside the JAX gather engine's chains of the same seeds
                   (tests/golden/lj_validation_gather.json, made by
                   tests/make_lj_validation.py), with the smallest steady
                   bias the gate catches; seed 7's T_m printed;
  The gather engine (the JAX package's default; no TPU kernel: its stages
  run as torch operations replayed from CUDA graphs, a pass's colour
  substeps compiled by torch.compile at their first call with a shape):
  5a. gather-small — the 108-atom, 2x2-grid chunk of
                   tests/test_torch_gather_engine.py on the card against
                   the port on the CPU from the same inputs: a pass's
                   shift, colour order, picks and displacements equal bit
                   for bit (ln u and HMC normals: ulps printed); one pass's
                   decisions equal but where a margin is below G_MARGIN
                   (any printed with its margin), and the same against
                   that pass with eager substeps on the card (positions
                   and pe within the tests' limits); the chunk's hist, xacc
                   and decisions equal, pe, virial, vol and frames within
                   the tests' limits; the chunk through CUDA graphs equal
                   to it run eagerly on the card, bit for bit;
  5b. gather-physics — the physics phase's configuration, gate and JAX
                   chains through melting_pipeline's default engine:
                   every chain diag 0 with a finite T_m, the mean
                   T_m(P*=1) within 2% of 0.78, port - JAX printed;
                   seconds a chain and ms a sweep; the chains run one
                   after another in this process (physics_chains with no
                   workers: spawned processes sharing the card ran them
                   slower);
  5c. gather-hmc — one chunk at 256 atoms with an HMC move a sweep (8
                   leapfrog steps): HMC moves accepted, diag 0 (no
                   NL_STALE), pe against a fresh list total and that total
                   against brute force within rtol 1e-5;
  5d. gather-full — 4096 atoms on the JAX CLI's default 4x16 grid (R=64),
                   two chunks of 2 records x 4 sweeps through
                   setup_run(engine="gather"): ms a sweep, attempted
                   moves/s, rebuilds, host syncs and graph replays a sweep,
                   K, peak memory; one sweep and its record under
                   torch.profiler: the device-busy share. It runs last:
                   once a process has profiled CUDA-graph replays,
                   torch.profiler loses kernel records in its later
                   sessions (python -m neuralmelting_tpu_torch.profiler_drops),
                   and the times of B5, P1 and golden's sweep come from
                   such sessions;
  EAM path (kernels B3 sweep, B4 total; the rc=3.8 synthetic Al table,
  written to a temp directory at run time):
  6. eam-small   — B4 and B3 against their plain versions at 4x4x4 fcc Al
                   (cells (3,3,3), K=16), R=3 and R=130 (rt=128, two tiles),
                   and at 16x8x8 fcc Al with K=40, R=3 (B3 with fewer warps
                   than cells a colour, two rounds a colour step):
                   identical decisions, the density slab, the pe identity
                   against fresh B4 totals, every atom inside its cell;
                   and B4 on a slab with empty cells and cells at
                   count == K;
  7. eam-full    — the same at scripts/eambench.py's configuration (AL,
                   16x8x8 fcc = 4096 atoms, 16x16 grid, R=256, seed 11);
                   CUDA-event times of each kernel beside its plain version;
                   then B3 and B4 (with and without the virial) again at
                   the slot capacity K of the main path's chunks (after
                   one warm-up chunk): held to their plain versions and
                   timed on the same inputs; then that ensemble re-binned
                   at K=40, B3's two-round case (fewer warps than a
                   colour's cells), held and timed the same way;
  8. eam-main    — melting_pipeline(element="AL", engine="cellmc") on the
                   default device at that configuration with a short
                   schedule; B3/B4 counters zeroed before and read after;
  EAM on the gather engine (the JAX package's default for EAM too; no TPU
  kernel: the gather stages replayed from CUDA graphs, with the setfl
  splines on the card and a density cache):
  8-1. eam-gather-small — 256 Al atoms (cells (2, 2, 2): stride 2 at
                   2 rc), a 2x2 grid, on the card against the port on the
                   CPU from the same state: a pass's draws bit for bit
                   (ln u and HMC normals: ulps printed); one pass's and
                   one tail's (a volume trial and an HMC move) decisions
                   equal but where a margin is below G_MARGIN, pe and the
                   density cache within the gather tests' limits (the
                   pass also against itself with eager colour substeps
                   on the card), the tail's cache equal to rho_sums of
                   its configuration;
                   a chunk of 2 x 2 sweeps through CUDA graphs equal to it
                   run eagerly (the cache too) and, against the CPU, hist,
                   xacc and decisions equal, energies, frames and the
                   cache within those limits;
  8-2. eam-gather-hmc — config 3's size (256 atoms, 10 temperatures), an
                   HMC move of 8 leapfrog steps a sweep, 2 x 4 sweeps:
                   diag 0, HMC moves accepted, pe against a fresh list's
                   total (rtol 1e-5) and the forces against autograd of
                   that total on the card (rtol and atol 5e-3);
  CLI and bench (kernels B1-B4 through the port's entry points):
  8a. cli        — the five stages remcmc -> parse -> rdf -> neural -> post
                   in-process through their main(argv) on the card, in a
                   temp directory: LJ 16x8x8 fcc = 4096 atoms (full width),
                   an 8x8 (P, T) grid (a cut of the 32x32 north star, for
                   the ~50 MB of text it writes), 4 records of 8 sweeps,
                   seed 1234, with frames; B1/B2 counters zeroed before
                   remcmc and read after; diag 0, 64 .thrm and 64 .traj
                   files, the checkpoint, one sampling_chunk event, the
                   parsed and feature shapes, a finite T_m, post --no-plot;
                   then remcmc --restart from the checkpoint for 2 records:
                   per slot, the first record's pe/N within RESTART_TOL of
                   the checkpointed run's last (a restart that sampled from
                   the lattice would lie beyond it); seconds per stage and
                   which text writer ran; then remcmc with no --engine
                   (gather) at 256 atoms on a 2x4 grid, 4 records of 4
                   sweeps, and its --restart for 2 records (diag 0, the
                   restart's first pe/N within RESTART_TOL of the
                   checkpointed last);
  8b. bench      — python -m neuralmelting_tpu_torch.bench's main in-process
                   at its full configuration (its JSON line printed as it
                   is): every row's diag 0 and rate > 0; B1-B4 counters
                   zeroed before and read after, each > 0;
  The production drivers (B1/B2 for LJ, B3/B4 for EAM; the counters
  zeroed before each run and read after, each > 0):
  8c. northstar  — python -m neuralmelting_tpu_torch.northstar at full
                   scale (32x32 (P, T) x 4096 LJ atoms, 6 eq + 4 samp
                   chunks of 5 records x 20 sweeps): diag 0, 32 resolved
                   rows, T_m(P*=1) of its one classifier training
                   within 2% of 0.78 (ROADMAP C11); points/hour, the
                   breakdown and T_m(P) beside the JAX package's
                   northstar_result.json; then C7 on the card: g(r) pair
                   counts of the compiled bin pass equal its eager
                   form's on 64 jittered 4096-atom frames, with both
                   times a frame; then --cool at full
                   width cut to 1 eq + 1 samp chunk a leg (diag 0, the
                   cool leg's T_m reported); then --fast stopped before
                   its first samp chunk and resumed (attempts_to_complete
                   2, diag 0);
  8d. coexist    — coexist_run for LJ at its defaults (16x8x8 = 4096
                   atoms, 13 T x 3 rows, prep at 8x8x8, relax 3, up to 40
                   measured chunks with the early stop), then EAM Al at
                   full width cut to --relax 1 --chunks 4: diag 0; in
                   every coexistence chunk no swap and every replica on
                   its slot; in the first chunk after the splice the
                   solid row's PE/atom below the liquid row's at every T
                   (that gap also printed for the first measured chunk,
                   where the reference protocol's liquid row has frozen,
                   in the JAX package's chains too: ROADMAP C9,
                   tests/test_torch_coexist_relax.py); finite liquid
                   fractions; the bracket and `consistent` reported (no
                   gate on their values);
  8e. sweep      — bench.melting_sweep (config 3: 256 Al atoms, 10 T,
                   30 records of 15 sweeps): diag 0, a finite T_m;
                   points/hour;
  9. eam-physics — docs/VALIDATION.md config 3, the heating leg as
                   scripts/eam_tm_ab.py pins it, as 8 chains (seeds 5-12)
                   held to the JAX gather engine's chains of the same
                   seeds (eam_config3_gather.json): per slot pe/N, V and
                   the virial pressure, and T_m of one classifier
                   trained on either side's features, each within 4
                   standard errors; diag 0 and T_m inside the grid; then
                   eam-gather-physics: the same chains, gates and
                   reference through melting_pipeline's default engine,
                   gather (like for like: the reference is the JAX
                   gather engine's), each chain's seconds, ms a sweep,
                   rebuilds and host syncs. The 16 chains run in
                   PHYS_WORKERS["eam-physics"] spawned processes sharing
                   the card (physics_chains: the process count, the
                   host's CPU cores and each chain's seconds printed)
                   while this process trains the classifiers on the JAX
                   chains' features, once for both engines' gates; the
                   gates are computed here.
  Serial path (kernel B5 lj_delta: the run kernel, position_run, and the
  batched one, delta_moves) and the probe (kernel P1):
  10. serial-small — batched B5 against its plain version, dE and dW, at
                   the JAX kernel test's shapes (R=1, N=256, M=4; R=2,
                   N=108, M=2);
  11. serial-full  — the same at one attempt's launch (R=1, N=256, M=1)
                   and batched at BASELINE config 2's shape (R=64
                   replicas of 4096 perturbed fcc atoms, M=32, rc 2.5),
                   with CUDA-event times and the bound;
  12. serial-run   — one config-1 sweep's runs of position attempts, from
                   one state, through position_run (one launch a run) and
                   through moves.position with brute_backend() (one
                   batched launch an attempt): positions, pe, virial,
                   decisions and weights bit for bit equal; against
                   position_run_plain on the CPU from the same state,
                   decisions equal up to a rounding tie (margin < 1e-4),
                   weights (up to the first tie) and, with no tie, pe,
                   virial and positions within B5_RTOL x the summed term
                   magnitudes plus f32 rounding; then a run of 256
                   attempts at N=4096 (48 KB of shared memory), held the
                   same two ways; times per launch and per attempt, and
                   the bound summed over the run;
  13. golden      — BASELINE config 1 (tests/make_golden.py) through the
                   port's serial engine on the default device (the card),
                   B5's counters zeroed before and read after: launches
                   must equal the runs of position attempts, attempts
                   through the run kernel the position attempts; records
                   and frames held to the committed tests/golden/config1.*
                   (the JAX package's run) and every decision to the
                   port's own CPU run of it; seconds per sweep, attempted
                   moves/s; tests/test_golden.py's cold case (32 atoms,
                   2 records of 3 sweeps) on the card against the port's
                   loop-based CPU reference (refimpl/cpu_ref.py): every
                   decision equal, positions, box, vol and pe within that
                   test's tolerances; and one sweep under torch.profiler:
                   device busy, idle share, device operations an attempt
                   (python3 -m neuralmelting_tpu_torch.profile_chunk
                   serial breaks it down);
  14. golden-hmc  — tests/test_golden.py's HMC case (32 atoms, ppos 0.7,
                   pvol 0.05, seed 9) on the card against the port's CPU
                   run: acceptance ratios equal, positions within 1e-2;
  14a. sharded    — multi-process cellmc (parallel/cellmc_sharded.py): two
                   ranks, spawned processes sharing the card over gloo,
                   each on its shard of the bench's LJ configuration
                   (4096 atoms, R=1024, 512 a rank) and of its EAM one
                   (4096 Al atoms, R=256): each rank's first B2/B3 sweep
                   and B1/B4 total at its own shard-folded seeds against
                   their plain versions, then two chunks of run_sampling
                   (B1-B4 counters zeroed before and read after, each
                   > 0): diag 0 on every rank (SHIFT_DESYNC clear),
                   records gathered whole (nrec, R), hist rows
                   permutations of 0..R-1, the record pe of replicas 0
                   and R-1 against a brute-force total of the gathered
                   positions (LJ 0.05 + 5e-4 |E|, EAM 0.02 + 1e-4 |E|);
                   the first chunk writes a checkpoint (rank 0), and a
                   fresh set-up on each rank restores it
                   (runner.restore_setup: barrier, whole load, the rank's
                   shard) and runs the second chunk again, which must
                   equal the first run of it bit for bit (records, hist,
                   xacc, diag and the gathered pos, box, pe, slot_of),
                   B1/B2 or B3/B4 launched again; the checkpoint's MB and
                   the restore's seconds a rank;
                   a rank that fails or passes SHARD_TIMEOUT fails the
                   phase with its traceback, and neither may import jax
                   or the JAX package; seconds a chunk and moves/s a rank
                   beside the same chunk on this one process;
                   then, on the same ranks, the gather engine over the
                   process group at full width: gather-full's LJ
                   configuration (4096 atoms, R=64, chunks of 1 record x
                   2 sweeps) and eam-gather-full's EAM one (chunks of 1 x
                   1): two chunks, the first checkpointed, the second
                   timed and again from the checkpoint on fresh set-ups,
                   bit for bit; diag 0, hist permutations, record pe of
                   replicas 0 and 63 against a brute-force total (EAM:
                   of the setfl splines the gather engine samples); this
                   process runs the same chunks whole and holds the
                   ranks' timed chunk to its own (hold_chunk: hist, xacc
                   and decisions equal, energies and frames within the
                   gather limits); seconds and ms a sweep a rank beside
                   one process's, rebuilds, host syncs (each a
                   collective) and remote rebuilds a sweep, checkpoint MB
                   and restore seconds;
  15. probe       — every P1 variant against its plain version at REPS
                   passes, then the per-variant timing at the passes that
                   make a launch last >= 1 ms (python -m
                   neuralmelting_tpu_torch.probe), each variant held to its
                   plain version again at those passes, with its SASS
                   counts a pass and both shares. A device time that no
                   torch.profiler session recorded (probe.device_ms tries
                   three) is taken with CUDA events around each call, and
                   the [profiler] line after [total] lists every such one.
  15-1. eam-longrc — the rc 6.3 Al table (written to a temp directory)
                   on 7^3 fcc = 1372 atoms: python -m
                   neuralmelting_tpu_torch.longrc_run at --fast's depth
                   (cellmc, 2 temperatures, 2 sweeps; B3/B4 counters
                   zeroed before and read after, each > 0): diag 0, cells
                   (3, 3, 3), K >= 72, initial pe/N within 1e-3 of the
                   JAX package's -3.3609 (longrc_result.json), moves/s >
                   0; B3 on jittered replicas at K=72, R=8, one cycle,
                   decisions and slabs as the plain version's; B3 (51
                   cycles) and B4 at longrc_run's own set-up (8
                   temperatures, K=72) held to their plain versions and
                   timed beside the bound; then the default engine,
                   gather (cells (2, 2, 2), stride 2 at 2 rc): pe/N within
                   1e-3 of -3.3609, two chunks of 1 record x 2 sweeps at
                   R=8 (the first compiles and captures), diag 0, ms,
                   rebuilds and host syncs a sweep;
  15a. eam-gather-full — eambench's physics (4096 Al atoms, 16x8x8 fcc,
                   the rc 3.8 table) on the JAX CLI's default 4x16 grid
                   (R=64), two chunks of 1 record x 2 sweeps through
                   setup_run (the first captures the graphs), CUDA events
                   only (no profiler, which gather-full's sweep must be
                   the only one to run on graph replays): ms a sweep,
                   attempted moves/s, rebuilds, host syncs and graph
                   replays a sweep, K, the cells and peak memory;
  The dense engine (the JAX package's --engine dense, LJ; no TPU kernel:
  its stages replayed from CUDA graphs, its colour substeps and energy
  row sums compiled by torch.compile):
  15b. dense-small — the physics phase's configuration (256 atoms, a
                   2x12 grid, seed 7) cut to 2 records x 2 sweeps, so
                   that dense-physics compiles nothing more: a record
                   block's draws on the card against the CPU's, bit for
                   bit (ln u: ulps printed); the chunk through CUDA graphs
                   equal to its stages run eagerly on the card, bit for
                   bit (states, keys, ghost map, frames, hist, xacc);
                   three moves' dE and dW a replica and every replica's
                   record pe and virial against brute-force minimum image
                   within the JAX dense tests' limits; the same chunk on
                   the CPU beside it (hist, xacc and decisions printed,
                   not gated);
  15c. dense-physics — the physics phase's configuration, gate and JAX
                   chains through melting_pipeline(engine="dense"), one
                   after another in this process: every chain diag 0 with
                   a finite T_m and 800 dense sweeps, the mean T_m(P*=1)
                   within 2% of 0.78; seconds a chain, ms, rebuilds and
                   host syncs a sweep;
  15d. dense-full — gather-full's configuration (4096 atoms, the 4x16
                   grid, R=64, seed 1234), two chunks of 2 records x 4
                   sweeps (the first compiles and captures): diag 0; ms,
                   rebuilds, host syncs and graph replays a sweep, peak
                   memory; replicas 0 and 63's record pe and virial
                   against brute force within the JAX total's limits
                   (their dE and dW printed: at this box the f32
                   cancellation in |r|^2 - 2 r.p + |p|^2 exceeds the
                   limits the JAX tests set at 256 atoms);
  16. gather-full — (5d above) last.

The last lines are the card's name and power limit (nvidia-smi), the
kernels' JSON line (each kernel's launches on its path's main run, error
against its plain version, CUDA-event ms of kernel and plain version at
full width (B5's run kernel: device ms a launch over config 1's runs,
its launches golden's; batched B5, off the main path: device ms at R=64,
its launches serial-run's per-attempt path's; P1: device ms of pair_div
at its timing passes, its launches the probe phase's), and the least
time the card could take for that work,
bound_ms, from its bytes over 3.35 TB/s or its f32 operations over
67 TFLOP/s, whichever is larger; B3's and B4's entries also carry
chunk_kcap and chunk_ms, the time at the chunks' K, B4's also ms_virial,
bound_ms_virial and chunk_ms_virial; B1-B4's entries carry launches_cli
and launches_bench, their launches in the cli and bench phases, and
launches_northstar (B1, B2), launches_coexist (B1-B4) and
launches_sweep (B3, B4), their launches in those phases' main runs,
and launches_sharded, their launches on both ranks of the sharded
phase's chunks;
B3's and B4's entries carry launches_longrc (eam-longrc's longrc_run)
and k72_* and k40_* fields: K, cells, replicas, kernel, plain and bound
ms (B4 also with the virial) at the long-rc geometry (K=72) and at
eambench's cells re-binned at K=40, B3's with its cycles and, at K=40,
its warps), and
{"ok": true, "device": {...}}.
Without a CUDA device, or without the package beside this script, it
exits non-zero and prints no result. Imports nothing of jax or of the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from neuralmelting_tpu_torch import bench as BENCH
from neuralmelting_tpu_torch import coexist as CX
from neuralmelting_tpu_torch import coexist_run as COEXIST_RUN
from neuralmelting_tpu_torch import golden as GOLD
from neuralmelting_tpu_torch import longrc_run as LRC
from neuralmelting_tpu_torch import northstar as NS
from neuralmelting_tpu_torch import probe as P1
from neuralmelting_tpu_torch import runner
from neuralmelting_tpu_torch.cli import neural as CLI_NEURAL
from neuralmelting_tpu_torch.cli import parse as CLI_PARSE
from neuralmelting_tpu_torch.cli import post as CLI_POST
from neuralmelting_tpu_torch.cli import rdf as CLI_RDF
from neuralmelting_tpu_torch.cli import remcmc as CLI_REMCMC
from neuralmelting_tpu_torch.config import RunConfig
from neuralmelting_tpu_torch.features import rdf as RDF
from neuralmelting_tpu_torch.io import native, thermo, traj
from neuralmelting_tpu_torch.models import eam as eam_mod
from neuralmelting_tpu_torch.models import eam_cheb, eam_gen
from neuralmelting_tpu_torch.models.lattice import make_supercell
from neuralmelting_tpu_torch.models.lj import LJCut
from neuralmelting_tpu_torch.neural.melt import melting_curve
from neuralmelting_tpu_torch.neural.models import PhaseCNN, init_params
from neuralmelting_tpu_torch.neural.scalers import get_scaler
from neuralmelting_tpu_torch.neural.train import (extreme_t_labels,
                                                  train_classifier)
from neuralmelting_tpu_torch.ops import _build
from neuralmelting_tpu_torch.ops import cellmc as CK
from neuralmelting_tpu_torch.ops import cellmc_eam as CE
from neuralmelting_tpu_torch.ops import cellmc_geom as CG
from neuralmelting_tpu_torch.ops import dense_delta as DD
from neuralmelting_tpu_torch.ops import ghosts as GH
from neuralmelting_tpu_torch.ops import eam_energy as EE
from neuralmelting_tpu_torch.ops import jrandom as J
from neuralmelting_tpu_torch.ops import lj_delta as LD
from neuralmelting_tpu_torch.ops import neighbors as NB
from neuralmelting_tpu_torch.parallel import ensemble as ENS
from neuralmelting_tpu_torch.parallel import mesh
from neuralmelting_tpu_torch.ops.energy import (delta_move_brute, min_image,
                                                pair_energy_virial)
from neuralmelting_tpu_torch.pipeline import melting_pipeline
from neuralmelting_tpu_torch.refimpl import cpu_ref as CPU_REF
from neuralmelting_tpu_torch.profile_chunk import (_device_ms, configs,
                                                   kernel_label)
from neuralmelting_tpu_torch.sampler import cellmc as SC
from neuralmelting_tpu_torch.sampler import checkerboard as CB
from neuralmelting_tpu_torch.sampler import dense as DS
from neuralmelting_tpu_torch.sampler import moves, serial
from neuralmelting_tpu_torch.sampler.state import FIELDS
from neuralmelting_tpu_torch.utils import MetricsLogger

DEV = torch.device("cuda")
FULL = configs()     # LJ north star, EAM eambench: 4096 atoms each
KERNELS = {
    "sweep": dict(name="cellmc_sweep (B2)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/cellmc_sweep.cu",
                  replaces="neuralmelting_tpu/ops/pallas/cellmc.py:460"),
    "total": dict(name="cellmc_total (B1)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/cellmc_total.cu",
                  replaces="neuralmelting_tpu/ops/pallas/cellmc.py:743"),
    "eam_sweep": dict(
        name="cellmc_eam_sweep (B3)", route="cuda",
        source="neuralmelting_tpu_torch/csrc/cellmc_eam_sweep.cu",
        replaces="neuralmelting_tpu/ops/pallas/cellmc_eam.py:89"),
    "eam_total": dict(
        name="cellmc_eam_total (B4)", route="cuda",
        source="neuralmelting_tpu_torch/csrc/cellmc_eam_total.cu",
        replaces="neuralmelting_tpu/ops/pallas/cellmc_eam.py:351"),
    "delta": dict(name="lj_delta position_run (B5)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/lj_delta.cu",
                  replaces="neuralmelting_tpu/ops/pallas/lj_kernel.py:64"),
    "delta_batched": dict(
        name="lj_delta delta_moves (B5, batched)", route="cuda",
        source="neuralmelting_tpu_torch/csrc/lj_delta.cu",
        replaces="neuralmelting_tpu/ops/pallas/lj_kernel.py:64"),
    "probe": dict(name="vpu_probe pair_div (P1)", route="cuda",
                  source="neuralmelting_tpu_torch/csrc/vpu_probe.cu",
                  replaces="scripts/vpu_probe.py:39"),
}
HERE = os.path.dirname(os.path.abspath(__file__))
# the JAX gather engine's config-3 chains (scripts/eam_config3_reference.py)
REFERENCE = os.path.join(HERE, "eam_config3_gather.json")
# the JAX serial engine's config-1 run (tests/make_golden.py)
GOLDEN = os.path.join(HERE, "tests", "golden")
# the JAX gather engine's chains of the LJ validation config
# (tests/make_lj_validation.py)
LJ_REFERENCE = os.path.join(GOLDEN, "lj_validation_gather.json")
Z_PHYS = 4.0            # standard errors allowed between port and JAX
CLF_SEEDS = range(4)    # classifier initial weights per chain
KB_EV = 8.617333262e-5
# cli: |pe/N of the restart's first record - the checkpointed run's last|
# per slot. The lattice's pe/N (printed beside) lies > 0.5 below every
# slot's after 32 sweeps, so a restart that sampled from the lattice
# fails; the hot slots (superheated crystals that melt) still drift
# between records 8 sweeps apart, by less than the limit
RESTART_TOL = 0.25
# the JAX package's initial pe/N of the long-rc 7^3 lattice
# (longrc_result.json)
LRC_PE0 = -3.3609
ERR = {k: 0.0 for k in KERNELS}
TIMES = {}
BOUND = {}
STAGE_S = {}            # host seconds of pipeline stages, by name
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 operations/s
# outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12
# f32 operations per pair term, counted from the kernels' code (a divide
# or a square root counts as one, so the bound stays a lower bound):
# LJ total: each half-stencil candidate pair that the box test keeps 3
# sub, 5 for r^2 and the compare; a pair inside max(rc, rc/s) also max,
# divide, 4 mul, 2 compares and 4 adds
OPS_LJ_CAND = 9
OPS_LJ_IN = 12
# B1 and B4: the box test of an atom and a nonempty stencil cell, 2 sub
# and 2 max an axis, 3 mul, 2 add and the compare (cellmc_common.cuh,
# box_gap2)
OPS_BOX = 18
# LJ sweep: two r^2 (16), one shared divide, the e(new) - e(old) algebra
OPS_LJ_SWEEP = 30
# EAM: one r^2 (8) plus masks and the image shift per candidate pair
# (twice, old and new, in the sweep); a Clenshaw term is 3 operations
OPS_EAM_CAND = 12
OPS_EAM_SWEEP_CAND = 20
# B5, per atom and side: the minimum image (3 x sub, divide, rint, mul,
# sub), r^2 (5) and the cutoff compare; inside rc also max, divide, sr6
# (2), sr12, e (2), w (3) and the two accumulates
OPS_B5_PAIR = 21
OPS_B5_IN = 12
# B5 sums of N terms in another order than the plain version: |k - p| <=
# B5_RTOL * (sum of the terms' magnitudes)
B5_RTOL = 2e-6
# P1 against its plain version, relative to max |plain|: exact for the
# variants whose operations the plain version repeats, the approximate
# reciprocal (square root) for the rest, bf16 rounding for the bf16 ones
PROBE_TOL = {"recip": 1e-4, "recip0": 1e-4, "rsqrt": 1e-4,
             "pair_recip": 1e-4, "fma_peak_bf16": 2.0 ** -5,
             "pair_div_bf16": 2.0 ** -5}


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def small_case(r, rc=1.5, seed=0, nsub=16):
    """Jittered 256-atom fcc replicas binned at the rc=1.5 geometry."""
    pos, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), 4)
    g = np.random.default_rng(seed)
    pos = np.stack([(pos + 0.05 * g.standard_normal(pos.shape)) % box
                    for _ in range(r)]).astype(np.float32)
    boxes = np.repeat(box[None], r, 0)
    geom = CG.make_geom(box, rc, pos.shape[1], nsub=nsub)
    shift = torch.tensor([0.3, 0.05, 0.55], device=DEV)
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos, device=DEV),
        torch.as_tensor(boxes, device=DEV), shift)
    check(not bool(over), "small case overflows its slots")
    temps = np.linspace(0.6, 1.8, r).astype(np.float32)
    w = boxes / np.asarray(geom.ncell, np.float32)
    params = np.concatenate([(1.0 / temps)[:, None],
                             np.full((r, 1), 0.15, np.float32), w, boxes], 1)
    pot3 = torch.tensor([1.0, 1.0, rc, 0.0], device=DEV)
    return geom, (x, y, z), ids, count, \
        torch.as_tensor(params, device=DEV), pot3


def edge_case(rc, stride, nsub, r, seed):
    """R replicas with K=8 slots a cell on a 2x2x2 sub-grid of sites,
    jittered: cell 0 holds K atoms, cell 1 none, every other cell a seeded
    count in [0, K]. Cells are 1.1 rc wide. Returns (geom, slabs, ids,
    count, params)."""
    kcap = 8
    n = 4 if stride == 2 else 3
    w = 1.1 * rc
    box = np.full(3, n * w)
    geom = CG.make_geom(box, rc, r * n ** 3 * kcap, nsub=nsub, stride=stride,
                        kcap=kcap)
    check(geom.ncell == (n, n, n), f"edge case cells {geom.ncell}")
    g = np.random.default_rng(seed)
    cnt = g.integers(0, kcap + 1, (r, geom.ncells))
    cnt[:, 0], cnt[:, 1] = kcap, 0
    slot = np.arange(geom.rows) % kcap
    occ = slot[None] < np.repeat(cnt, kcap, axis=1)            # (R, C*K)
    tabs = CG.geom_tables(geom)
    slabs = []
    for a in range(3):
        site = tabs[a] + 0.25 + 0.5 * ((slot >> a) & 1)
        v = (site[None] + 0.03 * g.standard_normal(occ.shape)) * w
        slabs.append(torch.as_tensor(np.where(occ, v, CG.INVALID)
                                     .astype(np.float32), device=DEV))
    ids = torch.as_tensor(np.where(occ, np.arange(geom.rows)[None], -1),
                          device=DEV)
    count = torch.as_tensor(cnt.astype(np.int32), device=DEV)
    temps = np.linspace(0.6, 1.8, r)
    params = np.concatenate([(1.0 / temps)[:, None], np.full((r, 1), 0.1),
                             np.full((r, 3), w), np.full((r, 3), n * w)], 1)
    return geom, tuple(slabs), ids, count, torch.as_tensor(
        params.astype(np.float32), device=DEV)


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------

def energies(geom, slabs, params, pot3):
    r = slabs[0].shape[0]
    ones = torch.ones(r, device=DEV)
    sums = CK.total(geom, slabs, params, pot3, ones)
    return CK.combine_sums(sums, float(pot3[0]), ones)[0], sums


def compare_total(geom, slabs, params, pot3, tag):
    r = slabs[0].shape[0]
    scale = torch.linspace(0.98, 1.02, r, device=DEV)
    k = CK.total(geom, slabs, params, pot3, scale)
    k2 = CK.total(geom, slabs, params, pot3, scale)
    p = CK.total_plain(geom, slabs, params, pot3, scale)
    torch.cuda.synchronize()
    check(torch.equal(k, k2), f"[{tag}] two total calls differ")
    rel = float(((k[:, :4] - p[:, :4]).abs() / p[:, :4].abs()).max())
    ERR["total"] = max(ERR["total"], float((k - p).abs().max()))
    log(f"[{tag}] total R={r}: max rel err of sums {rel:.3e} "
        f"(limit 1e-5), max abs {float((k - p).abs().max()):.3e}")
    check(rel <= 1e-5, f"[{tag}] total kernel disagrees: rel {rel}")
    check(bool((k[:, 4:] == 0).all()), f"[{tag}] total rows 4-7 not zero")


def compare_sweep(geom, slabs, ids, count, params, pot3, rt, tag, exact,
                  ncyc=1, seed0=(4242, 17), sweep=3):
    """One sweep by the kernel and by the plain version from the same
    slabs, at the threefry keys of ``seed0`` and ``sweep``; returns the
    kernel's slabs and stats."""
    r = slabs[0].shape[0]
    ntiles = -(-r // rt)
    seeds = SC.tile_seeds(seed0, sweep, ntiles, DEV)
    ks = tuple(a.clone() for a in slabs)
    ps = tuple(a.clone() for a in slabs)
    e0, _ = energies(geom, slabs, params, pot3)
    kst = CK.sweep(geom, ncyc, rt, ks, count, params, pot3, seeds)
    pst = CK.sweep_plain(geom, ncyc, rt, ps, count, params, pot3, seeds)
    torch.cuda.synchronize()
    e1, sums1 = energies(geom, ks, params, pot3)
    valid = ids >= 0
    dpos = max(float((a - b)[valid].abs().max()) for a, b in zip(ks, ps))
    ntry_eq = bool(torch.equal(kst[:, 2], pst[:, 2]))
    nacc_k, nacc_p = float(kst[:, 1].sum()), float(pst[:, 1].sum())
    nacc_rel = abs(nacc_k - nacc_p) / max(nacc_p, 1.0)
    dde = float((kst[:, 0] - pst[:, 0]).abs().max())
    tracked = kst[:, 0].double()
    true = (e1 - e0).double()
    # E(final) - E(initial) from two f32 pair-sum totals carries their
    # rounding: a few ulps of S12o + S6o
    tol = 5e-3 + 1e-4 * true.abs() + 2.0 ** -21 * (sums1[:, 0] + sums1[:, 1])
    bad = int(((tracked - true).abs() > tol).sum())
    log(f"[{tag}] sweep R={r} rt={rt}: n_try equal {ntry_eq}, n_acc kernel "
        f"{nacc_k:.0f} plain {nacc_p:.0f} (rel {nacc_rel:.2e}), max |dx| "
        f"{dpos:.3e}, max |dE_k - dE_p| {dde:.3e}, pe identity misses "
        f"{bad}/{r} (max |tracked - true| "
        f"{float((tracked - true).abs().max()):.3e})")
    check(ntry_eq, f"[{tag}] n_try differs")
    check(bad == 0, f"[{tag}] pe identity fails on {bad} replicas")
    wv = params[:, 2:5]
    tabs = torch.as_tensor(CG.geom_tables(geom), device=DEV)
    for a in range(3):
        lo = tabs[a][None].to(torch.float32) * wv[:, a, None]
        out = valid & ((ks[a] < lo) | (ks[a] >= lo + wv[:, a, None]))
        check(not bool(out.any()), f"[{tag}] an atom left its cell")
    if exact:
        check(nacc_k == nacc_p and dpos <= 1e-6 and dde <= 1e-4,
              f"[{tag}] decisions differ: n_acc {nacc_k} vs {nacc_p}, "
              f"|dx| {dpos}, |dE| {dde}")
        ERR["sweep"] = max(ERR["sweep"], dpos)
    else:
        check(nacc_rel <= 1e-5, f"[{tag}] n_acc rel {nacc_rel} > 1e-5")
    return ks, kst


def cuda_ms(fn, reps):
    fn()                                         # warm-up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


STENCIL27 = [(0, 0, 0)] + CG.offsets26()


def stencil_sum(geom, count, offs):
    """(R, C) f64: per cell, the occupied slots of its stencil cells."""
    _, nb, _ = CG.stencil(geom, offs, count.device)
    return count[:, nb].sum(dim=-1).to(torch.float64)


def bound(nbytes, nops):
    """(least ms for this work, what bounds it) on the H100's peaks."""
    t_b, t_o = nbytes / HBM_BPS, nops / F32_OPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def half_candidates(geom, slabs, params, count, cut2):
    """The work of a half-stencil walk with the box test, all replicas:
    (candidate pairs, box tests). The candidates are each cell's own
    unordered pairs and, for each atom, the atoms of every half-stencil
    cell whose bounding box (at the image the stencil sees it) lies at a
    squared distance below cut2, formed in f32 as the kernels' box_gap2
    forms it; a cell beyond holds no pair inside cut2. A box test is one
    (atom, nonempty half-stencil cell)."""
    r, dev = slabs[0].shape[0], slabs[0].device
    c, k = geom.ncells, geom.kcap
    _, nb, img = CG.stencil(geom, CG.offsets13(), dev)
    v = [a.reshape(r, c, k) for a in slabs]
    occ = v[0] < 1e29
    big = torch.finfo(torch.float32).max
    lo = [torch.where(occ, a, big).amin(-1) for a in v]        # (R, C)
    hi = [torch.where(occ, a, -big).amax(-1) for a in v]
    cnt = count.to(torch.float64)
    kept = float((cnt * (cnt - 1) / 2).sum())
    tests = 0.0
    for r0 in range(0, r, 16):
        rs = slice(r0, min(r, r0 + 16))
        g2 = 0.0
        for a in range(3):
            sh = img[..., a].to(torch.float32)[None] * params[rs, 5 + a,
                                                              None, None]
            b_lo = (lo[a][rs][:, nb] + sh)[:, :, None, :]       # (r, C, 1, O)
            b_hi = (hi[a][rs][:, nb] + sh)[:, :, None, :]
            m = v[a][rs][..., None]                            # (r, C, K, 1)
            gap = torch.clamp(torch.maximum(b_lo - m, m - b_hi), min=0.0)
            g2 = g2 + gap * gap
        ncnt = count[rs][:, nb][:, :, None, :]
        live = occ[rs][..., None] & (ncnt > 0)
        tests += float(live.sum())
        kept += float(torch.where(live & (g2 < cut2), ncnt, 0)
                      .to(torch.float64).sum())
    return kept, tests


def pairs_within(geom, slabs, params, rc2):
    """Ordered atom pairs closer than the cutoff, all replicas."""
    r, dev = slabs[0].shape[0], slabs[0].device
    c, k = geom.ncells, geom.kcap
    _, nb, img = CG.stencil(geom, STENCIL27, dev)
    v = [a.reshape(r, c, k) for a in slabs]
    n = 0
    for r0 in range(0, r, 4):
        rs = slice(r0, min(r, r0 + 4))
        cand = [(v[a][rs][:, nb, :] + img[..., a].to(torch.float32)[
            None, :, :, None] * params[rs, 5 + a, None, None, None])[
            :, :, None] for a in range(3)]
        mov = [v[a][rs][..., None, None] for a in range(3)]
        d = [cand[a] - mov[a] for a in range(3)]
        u = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        ok = (cand[0] < 1e29) & (mov[0] < 1e29) & (u < rc2) & (u > 0)
        n += int(ok.sum())
    return n


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    t = time.perf_counter()
    lib = _build.build()
    ver = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"[build] {lib.name} in {time.perf_counter() - t:.1f} s; "
        f"nvcc: {ver[-1]}; torch "
        f"{torch.__version__} (CUDA {torch.version.cuda}); "
        f"python {sys.version.split()[0]}")
    # ptxas -v: per kernel its registers, then its stack and spills
    kernel = spill = ""
    seen = []
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            log(f"[build] {kernel}: {line.split(':', 1)[-1].strip()}; "
                f"{spill}")
            seen.append((kernel, spill))
    # the redesigned total kernels keep their loop state in registers
    for src in ("cellmc_total.cu", "cellmc_eam_total.cu"):
        mine = [sp for k, sp in seen if k.startswith(src + " ")]
        check(mine and all("0 bytes spill stores" in sp
                           and "0 bytes spill loads" in sp for sp in mine),
              f"[build] {src}: spills or no ptxas report: {mine}")
    # g(r)'s bin pass goes through torch.compile at its first call on the
    # card: compile it here, at rdf_frames' batch of 4096-atom frames, so
    # that the main path's features seconds hold no compile
    t = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(3)
    g = RDF.rdf_frames(torch.rand((16, 4096, 3), generator=gen, device=DEV)
                       * 16.0, torch.full((16, 3), 16.0, device=DEV), 64,
                       7.6)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(g).all()), "[build] g(r) not finite")
    log(f"[build] g(r) bin pass compiled (torch.compile) and run in "
        f"{time.perf_counter() - t:.1f} s")


def kernel_name(mangled):
    """'cellmc_sweep.cu sweep_kernel' from a mangled kernel symbol (a
    kernel in an unnamed namespace of csrc/<file>.cu)."""
    m = re.search(r"_\d+_([a-z]\w*?)_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(2))
    tail = mangled[m.end() + n:]
    # a template kernel over one bool (ILb0E / ILb1E) or int (ILi6EE)
    targ = {"ILb0E": "<false>", "ILb1E": "<true>"}.get(tail[:5], "")
    t = re.match(r"ILi(\d+)E", tail)
    if t:
        targ = f"<{t.group(1)}>"
    return f"{m.group(1)}.cu {mangled[m.end():m.end() + n]}{targ}"


def phase_small():
    for r in (3, 130):
        geom, slabs, ids, count, params, pot3 = small_case(r)
        rt = SC.pick_rt(r)
        log(f"[small] geom ncell={geom.ncell} K={geom.kcap} J={geom.nsub} "
            f"R={r} rt={rt} tiles={-(-r // rt)}")
        compare_total(geom, slabs, params, pot3, "small")
        compare_sweep(geom, slabs, ids, count, params, pot3, rt, "small",
                      exact=True)
    geom, slabs, _, count, params = edge_case(1.5, 2, 8, 3, 5)
    log(f"[small] edge case: cells {geom.ncell}, K={geom.kcap}, empty cells "
        f"{int((count == 0).sum())}, full cells "
        f"{int((count == geom.kcap).sum())}")
    compare_total(geom, slabs, params, torch.tensor([1.0, 1.0, 1.5, 0.0],
                                                    device=DEV),
                  "small, edge")


def phase_full(name):
    cfg = FULL["lj"]
    setup = runner.setup_run(cfg, engine="cellmc", device=DEV)
    geom = setup.geom
    r = setup.states.temp.shape[0]
    rt = SC.pick_rt(r)
    ncyc = SC.default_ncyc(geom)
    params = SC.params_of(setup.states, geom, setup.us.kb)
    pot3 = setup.pot.pot3(DEV)
    slabs = setup.slabs[:3]
    log(f"[full] geom ncell={geom.ncell} K={geom.kcap} J={geom.nsub} "
        f"ncyc={ncyc} R={r} natoms={geom.natoms}")
    compare_total(geom, slabs, params, pot3, "full")
    ks, _ = compare_sweep(geom, slabs, setup.slabs[3], setup.slab_count,
                          params, pot3, rt, "full", exact=False, ncyc=ncyc)
    compare_total(geom, ks, params, pot3, "full, after a sweep")
    seeds = SC.tile_seeds((1, 2), 0, -(-r // rt), DEV)
    ones = torch.ones(r, device=DEV)
    work = tuple(a.clone() for a in slabs)
    TIMES["sweep"] = (
        cuda_ms(lambda: CK.sweep(geom, ncyc, rt, work, setup.slab_count,
                                 params, pot3, seeds), 5),
        cuda_ms(lambda: CK.sweep_plain(geom, ncyc, rt, work,
                                       setup.slab_count, params, pot3,
                                       seeds), 2))
    TIMES["total"] = (
        cuda_ms(lambda: CK.total(geom, slabs, params, pot3, ones), 10),
        cuda_ms(lambda: CK.total_plain(geom, slabs, params, pot3, ones), 3))
    # least time for the same work on these inputs
    cnt = setup.slab_count.to(torch.float64)
    rows = r * geom.rows
    rc2 = float(pot3[2]) ** 2
    n_in = pairs_within(geom, slabs, params, rc2) / 2      # s = 1
    kept, tests = half_candidates(geom, slabs, params, setup.slab_count, rc2)
    BOUND["total"] = bound(4 * (3 * rows + 10 * r + 4) + 4 * 8 * r,
                           kept * OPS_LJ_CAND + tests * OPS_BOX
                           + n_in * OPS_LJ_IN)
    log(f"[full] B1's bound counts {kept:.0f} candidate pairs, {tests:.0f} "
        f"box tests and {n_in:.0f} pairs inside rc")
    movers = torch.clamp(cnt, max=geom.nsub)
    cand = stencil_sum(geom, setup.slab_count, STENCIL27) - 1.0
    BOUND["sweep"] = bound(
        4 * (2 * 3 * rows + r * geom.ncells + 8 * r + 2 * (-(-r // rt)))
        + 4 * 8 * r, ncyc * float((movers * cand).sum()) * OPS_LJ_SWEEP)
    for k in ("sweep", "total"):
        ms, pms = TIMES[k]
        log(f"[full] {k}: kernel {ms:.3f} ms, plain {pms:.3f} ms per call, "
            f"bound {BOUND[k][0]:.4f} ms ({BOUND[k][1]}) (R={r}, CUDA "
            f"events after warm-up) on {name}")


def phase_main(name):
    cfg = FULL["lj"]
    CK.reset_launches()
    res = melting_pipeline(cfg, nbins=64, model="cnn", epochs=100,
                           engine="cellmc")
    launches = dict(CK.LAUNCHES)
    for k in ("sweep", "total"):
        KERNELS[k]["launches"] = launches[k]
    s = res.seconds
    rate = res.moves_tried / s["sampling"]
    log(f"[main] diag={res.diag} launches={launches} moves_tried="
        f"{res.moves_tried} T_m(P) first/last={res.tm[0]:.4f}/"
        f"{res.tm[-1]:.4f}")
    STAGE_S["main_features"] = s["features"]
    STAGE_S["main_frames"] = res.records.pe.numel()      # records x R
    log(f"[main] attempted moves/s {rate:.4e} (sampling incl. setup "
        f"{s['sampling']:.3f} s, features {s['features']:.3f} s, classifier "
        f"{s['classifier']:.3f} s) on {name}")
    check(res.diag == 0, f"[main] diag {res.diag}")
    check(all(v > 0 for v in launches.values()),
          f"[main] a kernel never launched: {launches}")
    check(np.isfinite(res.tm).all() and np.isfinite(res.probs).all(),
          "[main] non-finite T_m or probabilities")
    check(res.probs.shape == (32, 32) and res.g_slot.shape == (1024, 64),
          "[main] output shapes")
    check(np.isfinite(res.g_slot).all() and np.isfinite(res.sq_slot).all(),
          "[main] non-finite features")
    pe = res.records.pe.cpu().numpy() / 4096
    check(np.isfinite(pe).all() and (pe < 0).all(),
          "[main] record pe/N not finite and negative")


def validation_cfg(seed):
    """The docs/VALIDATION.md LJ configuration with the chain seed given
    (the document's is 7)."""
    return RunConfig(name="val", element="LJ", ncells=(4, 4, 4), npress=2,
                     ntemp=12, press=(1.0, 5.0),
                     temp=tuple(np.linspace(0.55, 1.45, 12)), nsmpl=40,
                     mod=20, ncut=15, seed=seed, dpos0=0.1, dvol0=0.01)


def phase_physics(name):
    """The docs/VALIDATION.md LJ config (melting_pipeline, nbins 48, MLP,
    400 epochs, band 2) as the chains of seeds 7-14 that
    tests/make_lj_validation.py ran through the JAX gather engine
    (tests/golden/lj_validation_gather.json). One chain's T_m(P*=1)
    spreads by ~0.01-0.013 from seed to seed, on either side, about the
    width of the 2% band, so seed 7's value is printed with its own
    verdict and the gates are: every chain diag 0 with a finite T_m, and
    the chains' mean T_m(P*=1) within 2% of 0.78. The JAX chains are
    printed beside the port's, with the smallest steady bias of the
    port's mean that the 2% gate catches with 95% probability: from the
    JAX chains' mean, shifted to 1.645 standard errors (the JAX chains'
    sd over sqrt(8)) beyond either end of the band."""
    with open(LJ_REFERENCE) as f:
        ref = json.load(f)
    t = time.perf_counter()
    chains, _ = physics_chains("physics", [
        (seed, validation_cfg(seed), dict(nbins=48, model="mlp", epochs=400,
                                          band=2, engine="cellmc"))
        for seed in ref["chain_seeds"]])
    tms = []
    for seed in ref["chain_seeds"]:
        res = chains[seed][0]
        check(res.diag == 0 and np.isfinite(res.tm).all(),
              f"[physics] seed {seed}: diag {res.diag}, T_m {res.tm}")
        tms.append(res.tm)
    dt = time.perf_counter() - t
    tms = np.asarray(tms)
    tm1, tm5 = float(tms[0, 0]), float(tms[0, 1])
    err1 = abs(tm1 / 0.78 - 1.0)
    log(f"[physics] seed {ref['chain_seeds'][0]}: T_m(P*=1)={tm1:.4f} "
        f"T_m(P*=5)={tm5:.4f}; |T_m(1)/0.78 - 1| = {err1:.4f} (one chain: "
        f"{'inside' if err1 <= 0.02 else 'outside'} 2%)")
    port = tms[:, 0]
    jax_tm = np.asarray([c["tm"][0] for c in ref["chains"]])
    mean = float(port.mean())
    err = abs(mean / 0.78 - 1.0)
    m_j, se_j = float(jax_tm.mean()), jax_tm.std(ddof=1) / math.sqrt(
        len(port))
    catch_up = 0.78 * 1.02 + 1.645 * se_j - m_j
    catch_down = m_j - (0.78 * 0.98 - 1.645 * se_j)
    log(f"[physics] T_m(P*=1) by chain (seeds {ref['chain_seeds']}): port "
        f"{np.round(port, 4).tolist()}, JAX gather "
        f"{np.round(jax_tm, 4).tolist()}; chains outside 2% of 0.78: port "
        f"{int((np.abs(port / 0.78 - 1) > 0.02).sum())}, JAX "
        f"{int((np.abs(jax_tm / 0.78 - 1) > 0.02).sum())} of {len(port)}")
    log(f"[physics] mean T_m(P*=1) port {mean:.4f} (sd "
        f"{port.std(ddof=1):.4f}), JAX {jax_tm.mean():.4f} (sd "
        f"{jax_tm.std(ddof=1):.4f}); |mean/0.78 - 1| = {err:.4f} (gate "
        f"0.02: {'PASS' if err <= 0.02 else 'MISS'}); port - JAX "
        f"{mean - m_j:+.4f}; the gate catches a steady bias of the mean "
        f"beyond +{catch_up:.4f} / -{catch_down:.4f} with 95% probability; "
        f"mean T_m(P*=5) {tms[:, 1].mean():.4f}; {dt:.1f} s on {name}")
    check(err <= 0.02, f"[physics] mean T_m(P*=1)={mean} misses the 2% gate")


# ---------------------------------------------------------------------------
# the gather engine (no TPU kernel: torch stages replayed from CUDA graphs)
# ---------------------------------------------------------------------------

# tests/test_torch_gather_engine.py's chunk: 108 atoms, a 2x2 grid close
# enough for swaps, 2 records of 2 sweeps
GATHER_SMALL = dict(name="gsmall", element="LJ", ncells=(3, 3, 3), npress=2,
                    ntemp=2, press=(1.0, 1.3), temp=(0.8, 0.84), nsmpl=2,
                    mod=2, ncut=0, seed=3)
# the stated f32 tolerances of the gather tests: pe and virial rtol, vol
# rtol, positions relative to the box edge; a decision that differs must
# have its margin |ln u - weight| below G_MARGIN
G_RTOL, G_VOL, G_POS, G_MARGIN = 1e-5, 1e-6, 1e-5, 1e-4


def f32_ulps(a, b):
    """Largest distance in f32 ulps between two f32 tensors (host)."""
    ia = a.detach().cpu().contiguous().view(torch.int32).long()
    ib = b.detach().cpu().contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def gather_chunk(cfg, device, graphs=True, setfl=None):
    """setup_run + one chunk of the gather engine: (setup, recs, frames,
    hist, xacc, diag) as run_sampling returns them. ``graphs`` False runs
    the run function of the same parameters with its stages eager on the
    card."""
    setup = runner.setup_run(cfg, setfl=setfl, device=device)
    if graphs:
        return runner.run_sampling(setup, write_files=False)
    run = ENS.make_ensemble_run_fn(
        setup.us.kb, setup.us.p2e, setup.cellcfg,
        **runner.gather_run_kwargs(setup, cfg.nsmpl, True), graphs=False)
    (states, _, aux, _, recs, frames, hist, xacc, diag, _) = run(
        setup.states, setup.nls, setup.aux, setup.slot_of,
        J.key(cfg.seed + 1).to(setup.device), setup.pot, setup.table,
        setup.t_grid, setup.p_grid)
    return (dataclasses.replace(setup, states=states, aux=aux), recs,
            frames, hist, xacc, int(diag))


def hold_chunk(a, b, tag, scale=None):
    """Two chunks of one configuration: hist, xacc and every decision
    (acc_* records) equal, energies and frames within the stated limits,
    relative to each value or, for a field in ``scale``, to its (R,)
    summed term magnitudes. Returns the largest differences."""
    check(torch.equal(a[3].cpu(), b[3].cpu()) and torch.equal(
        a[4].cpu(), b[4].cpu()), f"[{tag}] hist or xacc differ: "
          f"{a[4].tolist()} vs {b[4].tolist()}")
    for f in ("sweep", "acc_pos", "acc_vol", "acc_hmc", "dpos", "dvol"):
        check(torch.equal(getattr(a[1], f).cpu(), getattr(b[1], f).cpu()),
              f"[{tag}] records differ in {f}")
    err = {}
    for f, tol in (("pe", G_RTOL), ("virial", G_RTOL), ("vol", G_VOL)):
        x, y = getattr(a[1], f).cpu(), getattr(b[1], f).cpu()
        ref = y.abs() if f not in (scale or {}) else scale[f].cpu()
        err[f] = float(((x - y).abs() / ref).max())
        check(err[f] <= tol, f"[{tag}] {f} rel {err[f]:.2e} > {tol}")
    lmax = float(b[2][1].max())
    err["pos"] = float((a[2][0].cpu() - b[2][0].cpu()).abs().max()) / lmax
    check(err["pos"] <= G_POS, f"[{tag}] frames differ by {err['pos']:.2e}"
          f" of the box edge")
    return err


def compiled_against_eager(tag, g, style, kd, sg, ag, tg):
    """The card's pass (its colour substeps through torch.compile) against
    the same pass with eager substeps on the card, from the same state:
    decisions equal but where a margin is below G_MARGIN, positions, pe
    and the density cache within the gather tests' limits."""
    one_pass = CB.make_cb_pass_fn(g.us.kb, g.cellcfg, style, compiled=False)
    te = []
    se, ae = one_pass(g.pot, g.table, g.states, g.nls, g.aux, g.states.dpos,
                      kd, trace=te)
    differ, margins = 0, []
    for (vg, a1, _), (ve, a2, me) in zip(tg, te):
        bad = (a1 != a2) & ve
        differ += int(bad.sum())
        margins += me[bad].abs().tolist()
    check(all(m < G_MARGIN for m in margins), f"[{tag}] compiled against "
          f"eager substeps: a decision differs beyond rounding: {margins}")
    err = {"pos": float((sg.pos - se.pos).abs().max() / se.box.max()),
           "pe": float(((sg.pe - se.pe) / se.pe).abs().max())}
    if style == "eam":
        err["rho"] = rho_err(ag, ae)
    if not differ:
        check(err["pos"] <= G_POS and err["pe"] <= G_RTOL
              and err.get("rho", 0.0) <= G_RTOL,
              f"[{tag}] compiled against eager substeps: {err}")
    log(f"[{tag}] the pass with compiled colour substeps against eager ones "
        f"on the card: {differ} decisions differ"
        + (f" (margins {margins})" if differ else "") + ", "
        + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
        + f"; pe {f32_ulps(sg.pe, se.pe)} f32 ulps apart")


def phase_gather_small(name):
    """Draws, one pass's decisions and one chunk: the card (CUDA graphs,
    and eager) against the port on the CPU from the same inputs."""
    cfg = RunConfig(**GATHER_SMALL)
    g = runner.setup_run(cfg, device=DEV)
    c = runner.setup_run(cfg, device="cpu")
    cc = g.cellcfg
    # the draws of one pass and one HMC move from the same keys
    kd = J.fold_in(g.states.key, 3)
    dg = CB.pass_draws(kd, cc.ncolors, cc.cells_per_color, g.states.dpos)
    dc = CB.pass_draws(kd.cpu(), cc.ncolors, cc.cells_per_color,
                       c.states.dpos)
    for k, a, b in zip(("shift", "order", "u", "disp"), dg, dc):
        check(torch.equal(a.cpu(), b), f"[gather-small] draws differ: {k}")
    ln_ulps = f32_ulps(dg[4], dc[4])
    ng, nc = J.normal(g.states.key, (108, 3)), J.normal(c.states.key,
                                                       (108, 3))
    n_ulps = f32_ulps(ng, nc)
    n_share = float((ng.cpu() != nc).float().mean())
    log(f"[gather-small] draws: shift, colour order, picks and displacements"
        f" equal bit for bit; ln u within {ln_ulps} f32 ulps; HMC normals "
        f"within {n_ulps} ulps, {100 * n_share:.2f}% not equal (the card's "
        "log and log1p against the CPU's)")
    # one pass from the same state (the card's colour substeps compiled):
    # each decision's margin
    one_pass = CB.make_cb_pass_fn(g.us.kb, cc)
    tg, tc = [], []
    sg, ag = one_pass(g.pot, g.table, g.states, g.nls, g.aux, g.states.dpos,
                      kd, trace=tg)
    sc, _ = one_pass(c.pot, c.table, c.states, c.nls, c.aux, c.states.dpos,
                     kd.cpu(), trace=tc)
    differ, margins = 0, []
    for (vg, ag, mg), (vc, ac, mc) in zip(tg, tc):
        bad = (ag.cpu() != ac) & vc
        differ += int(bad.sum())
        margins += mc[bad].abs().tolist()
    ndec = int(sum(int(v.sum()) for v, _, _ in tc))
    log(f"[gather-small] one pass, {ndec} decisions: {differ} differ"
        + (f", margins {margins}" if differ else ""))
    check(all(m < G_MARGIN for m in margins),
          f"[gather-small] a decision differs beyond rounding: {margins}")
    if not differ:
        pos_err = float((sg.pos.cpu() - sc.pos).abs().max())
        check(pos_err <= G_POS * float(sc.box.max()),
              f"[gather-small] pass positions differ by {pos_err}")
    compiled_against_eager("gather-small", g, "pair", kd, sg, ag, tg)
    # one chunk: graphs against eager on the card (bits), card against CPU
    ENS.reset_counts()
    a = gather_chunk(cfg, DEV)
    counts = dict(ENS.COUNTS)
    e = gather_chunk(cfg, DEV, graphs=False)
    for f in FIELDS:
        check(torch.equal(getattr(a[0].states, f), getattr(e[0].states, f)),
              f"[gather-small] graphs against eager: {f} differs")
    check(torch.equal(a[0].states.key, e[0].states.key)
          and torch.equal(a[2][0], e[2][0]),
          "[gather-small] graphs against eager: keys or frames differ")
    err = hold_chunk(a, gather_chunk(cfg, "cpu"), "gather-small")
    check(a[5] == 0, f"[gather-small] diag {a[5]}")
    log(f"[gather-small] chunk of 2 x 2 sweeps, xacc {a[4].tolist()}: CUDA "
        f"graphs equal eager bit for bit; against the CPU hist, xacc and "
        f"decisions equal, pe rel {err['pe']:.2e}, virial {err['virial']:.2e}"
        f", vol {err['vol']:.2e}, frames {err['pos']:.2e} of the box edge; "
        f"{counts} on {name}")


# the validation chains of a phase run in this many spawned processes
# that share the card, each taking chains until none is left, or, with
# 0, one after another in this process. Processes on one card take turns
# on it: the LJ chains ran slower in 2, 4 or 8 processes than in this
# one; the EAM phase gains from training the classifiers while its pool
# runs, once for both engines' JAX-chain gates (PERF.md section 6)
PHYS_WORKERS = {"physics": 0, "gather-physics": 0, "dense-physics": 0,
                "eam-physics": 8}
PHYS_TIMEOUT = 900          # seconds for a phase's chains


def host_record(rec):
    """A ThermoRecord's tensors on the host."""
    return dataclasses.replace(rec, **{f.name: getattr(rec, f.name).cpu()
                                       for f in dataclasses.fields(rec)})


def run_chain(cfg, kw):
    """One validation chain: (melting_pipeline's result, its engine's
    COUNTS (the gather engine's ENS.COUNTS, the dense engine's
    DS.COUNTS), its seconds)."""
    counts = DS if kw.get("engine") == "dense" else ENS
    counts.reset_counts()
    t = time.perf_counter()
    res = melting_pipeline(cfg, **kw)
    return res, dict(counts.COUNTS), time.perf_counter() - t


def chain_worker(jobs, results):
    """A spawned process of ``physics_chains``: runs ``run_chain`` on every
    (key, cfg, keyword arguments) it takes from ``jobs`` until None, and
    puts (key, the outcome pickled, its tensors on the host) on
    ``results`` for each, or (key, the traceback); last ("foreign", the
    jax or JAX-package modules it imported)."""
    import traceback
    key = None
    try:
        for key, cfg, kw in iter(jobs.get, None):
            res, counts, secs = run_chain(cfg, kw)
            res = dataclasses.replace(res, classifier=None,
                                      records=host_record(res.records))
            # pickled by value: the queue's own pickler would share the
            # tensors' storage with this process, which exits first
            results.put((key, pickle.dumps((res, counts, secs))))
        results.put(("foreign", sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "neuralmelting_tpu"))))
    except Exception:
        results.put((key, traceback.format_exc()))


def physics_chains(tag, jobs, meanwhile=None, on_result=None):
    """A validation phase's chains, (key, cfg, melting_pipeline keyword
    arguments) each, on the card from PHYS_WORKERS[tag] spawned
    processes, each taking chains until none is left; ``meanwhile()``
    runs in this process while they do, then ``on_result(key, outcome)``
    on each chain's outcome as it comes (with no workers: the chains one
    after another in this process, after ``meanwhile``). Returns ({key:
    (result, ENS.COUNTS, seconds)}, what ``meanwhile`` returned). A chain
    that fails, a process that dies and a phase that passes PHYS_TIMEOUT
    fail the phase; a process that imported jax or the JAX package too."""
    import multiprocessing as mp
    import queue as queue_mod
    t = time.perf_counter()
    workers = PHYS_WORKERS[tag]
    on_result = on_result or (lambda key, outcome: None)
    if not workers:
        extra = meanwhile() if meanwhile else None
        out = {}
        for key, cfg, kw in jobs:
            out[key] = run_chain(cfg, kw)
            on_result(key, out[key])
        log(f"[{tag}] {len(jobs)} chains one after another in this "
            "process: " + ", ".join(f"chain {k} {v[2]:.1f} s"
                                    for k, v in out.items())
            + f"; {time.perf_counter() - t:.1f} s in all")
        return out, extra
    ctx = mp.get_context("spawn")
    todo, results = ctx.Queue(), ctx.Queue()
    nproc = min(workers, len(jobs))
    for job in list(jobs) + [None] * nproc:
        todo.put(job)
    procs = [ctx.Process(target=chain_worker, args=(todo, results))
             for _ in range(nproc)]
    for p in procs:
        p.start()
    out, done = {}, 0
    try:
        extra = meanwhile() if meanwhile else None
        while len(out) < len(jobs) or done < nproc:
            try:
                key, val = results.get(timeout=5.0)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                check(not dead, f"[{tag}] a chain process exited with "
                      f"{dead}")
                check(time.perf_counter() - t < PHYS_TIMEOUT,
                      f"[{tag}] the chains passed {PHYS_TIMEOUT} s")
                continue
            if key == "foreign":
                check(not val, f"[{tag}] a chain process imported {val}")
                done += 1
                continue
            check(isinstance(val, bytes), f"[{tag}] chain {key} failed:\n"
                  f"{val}")
            out[key] = pickle.loads(val)
            on_result(key, out[key])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    log(f"[{tag}] {len(jobs)} chains in {nproc} spawned processes sharing "
        f"the card, on a host of {os.cpu_count()} CPU cores: "
        + ", ".join(f"chain {k} {v[2]:.1f} s" for k, v in out.items())
        + f" (a process's first chain also compiles); "
        f"{time.perf_counter() - t:.1f} s from the first start to the last "
        "result")
    return out, extra


def phase_gather_physics(name):
    """The physics phase's configuration and gate on the gather engine
    (melting_pipeline's default), printed beside the JAX gather chains of
    the same seeds; the chains run in spawned processes
    (``physics_chains``)."""
    with open(LJ_REFERENCE) as f:
        ref = json.load(f)
    t = time.perf_counter()
    chains, _ = physics_chains("gather-physics", [
        (seed, validation_cfg(seed), dict(nbins=48, model="mlp", epochs=400,
                                          band=2))
        for seed in ref["chain_seeds"]])
    tms, secs, ms_sweep = [], [], []
    for seed in ref["chain_seeds"]:
        cfg = validation_cfg(seed)
        res, counts, sec = chains[seed]
        secs.append(sec)
        sweeps = counts["sweeps"]
        check(sweeps == cfg.nsmpl * cfg.mod, f"[gather-physics] seed {seed}:"
              f" {sweeps} gather sweeps, not {cfg.nsmpl * cfg.mod}")
        ms_sweep.append(1e3 * res.seconds["sampling"] / sweeps)
        check(res.diag == 0 and np.isfinite(res.tm).all(),
              f"[gather-physics] seed {seed}: diag {res.diag}, T_m {res.tm}")
        tms.append(res.tm)
        log(f"[gather-physics] seed {seed}: T_m(P*)={np.round(res.tm, 4)}; "
            f"{secs[-1]:.1f} s (sampling {res.seconds['sampling']:.1f} s, "
            f"{ms_sweep[-1]:.2f} ms a sweep, {counts['rebuilds']} "
            f"rebuilds, {counts['syncs']} syncs)")
    port = np.asarray(tms)[:, 0]
    jax_tm = np.asarray([c["tm"][0] for c in ref["chains"]])
    mean = float(port.mean())
    err = abs(mean / 0.78 - 1.0)
    log(f"[gather-physics] T_m(P*=1) by chain (seeds {ref['chain_seeds']}): "
        f"port {np.round(port, 4).tolist()}, JAX gather "
        f"{np.round(jax_tm, 4).tolist()}, port - JAX "
        f"{np.round(port - jax_tm, 4).tolist()}")
    log(f"[gather-physics] mean T_m(P*=1) port {mean:.4f} (sd "
        f"{port.std(ddof=1):.4f}), JAX {jax_tm.mean():.4f}; |mean/0.78 - 1|"
        f" = {err:.4f} (gate 0.02: {'PASS' if err <= 0.02 else 'MISS'}); "
        f"port - JAX {mean - jax_tm.mean():+.4f}; {np.mean(secs):.1f} s a "
        f"chain, {np.mean(ms_sweep):.2f} ms a sweep (sampling incl. set-up),"
        f" {time.perf_counter() - t:.1f} s in all on {name}")
    check(err <= 0.02,
          f"[gather-physics] mean T_m(P*=1)={mean} misses the 2% gate")


def phase_gather_hmc(name):
    """One chunk at 256 atoms with HMC (8 leapfrog steps, a setting whose
    trajectories stay inside the list's budget: the JAX package's chunk
    of it on the CPU gives diag 0 too)."""
    cfg = RunConfig(name="ghmc", element="LJ", ncells=(4, 4, 4), npress=2,
                    ntemp=2, press=(1.0, 4.0), temp=(0.7, 1.1), nsmpl=2,
                    mod=4, ncut=0, seed=5, phmc=0.05, nstps=8)
    setup, recs, _, _, _, diag = runner.run_sampling(
        runner.setup_run(cfg, device=DEV), write_files=False)
    acc = recs.acc_hmc.cpu()
    check(diag == 0, f"[gather-hmc] diag {diag} (8: NL_STALE)")
    check(float(acc.max()) > 0, "[gather-hmc] no HMC move accepted")
    st = setup.states
    nls, _ = ENS.build_ensemble_nl(setup.pot, st, setup.cfg.skin,
                                   capacity=setup.cap)
    pe_list, _ = NB.pair_energy_virial(setup.pot, st.pos, st.box, nls)
    pe_brute = torch.stack([pair_energy_virial(setup.pot, st.pos[r],
                                               st.box[r])[0]
                            for r in range(st.pos.shape[0])])
    e1 = float(((st.pe - pe_list).abs() / pe_list.abs()).max())
    e2 = float(((pe_brute - pe_list).abs() / pe_list.abs()).max())
    log(f"[gather-hmc] 4 replicas x 256 atoms, 2 x 4 sweeps, one HMC move a "
        f"sweep: acc_hmc by record {np.round(acc.numpy(), 3).tolist()}, "
        f"diag {diag}; pe against a fresh list total rel {e1:.2e}, the fresh "
        f"list against brute force rel {e2:.2e} (limit {G_RTOL}) on {name}")
    check(e1 <= G_RTOL and e2 <= G_RTOL, "[gather-hmc] pe off its total")


def gather_full_cfg():
    """gather-full's configuration: 4096 LJ atoms on the JAX CLI's default
    4x16 grid (R=64), seed 1234, chunks of 2 records x 4 sweeps."""
    return RunConfig(name="gfull", element="LJ", ncells=(16, 8, 8), npress=4,
                     ntemp=16, nsmpl=2, mod=4, ncut=0, seed=1234)


def phase_gather_full(name):
    """4096 atoms on the JAX CLI's default 4x16 grid (R=64), one chunk of
    2 records x 4 sweeps through setup_run(engine="gather"); then one
    sweep and its record under torch.profiler."""
    cfg = gather_full_cfg()
    torch.cuda.reset_peak_memory_stats()
    t = runner.timed(DEV)
    setup = runner.setup_run(cfg, device=DEV)
    t_setup = runner.timed(DEV) - t
    ENS.reset_counts()
    setup, _, _, _, _, diag = runner.run_sampling(setup, write_files=False)
    t_chunk = runner.timed(DEV) - t - t_setup
    counts = dict(ENS.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(diag == 0, f"[gather-full] diag {diag}")
    sweeps = cfg.nsmpl * cfg.mod
    rate = float(setup.moves_tried) / t_chunk
    log(f"[gather-full] R=64 x 4096 atoms, cells {setup.cellcfg.ncell}, K="
        f"{setup.cap}, {CB.default_npasses(4096, setup.cellcfg)} passes a "
        f"sweep: set-up {t_setup:.2f} s; chunk {t_chunk:.2f} s (the first "
        f"one: it captures the CUDA graphs), {1e3 * t_chunk / sweeps:.1f} ms "
        f"a sweep, {rate:.4e} attempted moves/s; a sweep "
        f"{counts['rebuilds'] / sweeps:.2f} rebuilds, "
        f"{counts['syncs'] / sweeps:.2f} host syncs, "
        f"{counts['replays'] / sweeps:.2f} graph replays; peak memory "
        f"{peak:.2f} GiB on {name}")
    ENS.reset_counts()
    moves0 = float(setup.moves_tried)
    t = runner.timed(DEV)
    setup, _, _, _, _, diag = runner.run_sampling(setup, write_files=False)
    t2 = runner.timed(DEV) - t
    check(diag == 0, f"[gather-full] second chunk diag {diag}")
    log(f"[gather-full] a second chunk: {1e3 * t2 / sweeps:.1f} ms a sweep, "
        f"{(float(setup.moves_tried) - moves0) / t2:.4e} attempted moves/s, "
        f"{ENS.COUNTS['rebuilds']} rebuilds")
    run = ENS.make_ensemble_run_fn(
        setup.us.kb, setup.us.p2e, setup.cellcfg, skin=cfg.skin,
        capacity=setup.cap, mod=1, nrecords=1,
        nvol=runner.nvol_per_sweep(cfg, 4096), natoms=4096, exchange=True,
        npress=4, ntemp=16, write_traj=False)
    args = (setup.states, setup.nls, setup.aux, setup.slot_of,
            J.key(cfg.seed + 1).to(DEV), setup.pot, setup.table,
            setup.t_grid, setup.p_grid)
    run(*args)                                 # capture, outside the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_device_ms(ev) for ev in kern)
    log(f"[gather-full] one sweep and its record under torch.profiler: wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms "
        f"({sum(ev.count for ev in kern)} kernels), busy share "
        f"{busy / wall:.4f}; the most device time: " + ", ".join(
            f"{kernel_label(ev.key)} {_device_ms(ev):.1f} ms x{ev.count}"
            for ev in sorted(kern, key=_device_ms, reverse=True)[:4]))


# ---------------------------------------------------------------------------
# the dense engine (no TPU kernel: torch stages replayed from CUDA graphs)
# ---------------------------------------------------------------------------

# the JAX package's own limits against brute force (tests/test_dense.py):
# dE and dW rtol, dE atol, dW atol; the total's pe rtol and atol, virial
# atol
D_RTOL, D_DE_ABS, D_DW_ABS = 2e-4, 2e-4, 2e-3
D_TOT_RTOL, D_PE_ABS, D_VIR_ABS = 3e-4, 1e-2, 0.1


def dense_chunk(cfg, device, graphs=True):
    """setup_run(engine="dense") + one chunk: (setup, recs, frames, hist,
    xacc, diag) as run_sampling returns them. ``graphs`` False runs the
    run function of the same parameters with its stages eager."""
    setup = runner.setup_run(cfg, engine="dense", device=device)
    if graphs:
        return runner.run_sampling(setup, write_files=False)
    run = DS.make_dense_run_fn(
        setup.us.kb, setup.us.p2e, setup.cellcfg,
        **runner.dense_run_kwargs(setup, cfg.nsmpl, True), graphs=False)
    (states, gms, slot_of, recs, frames, hist, xacc, diag, _) = run(
        setup.states, setup.gms, setup.slot_of,
        J.key(cfg.seed + 1).to(setup.device), setup.pot, setup.table,
        setup.t_grid, setup.p_grid)
    return (dataclasses.replace(setup, states=states, gms=gms,
                                slot_of=slot_of), recs, frames, hist, xacc,
            int(diag))


def dense_brute(setup, tag, movers=3, seed=0, gate=("de", "dw", "pe",
                                                    "virial")):
    """The dense energies of ``setup`` against brute-force minimum image
    (ops/energy.py) on the card: dE and dW of ``movers`` random moves a
    replica, and each replica's pe and virial (the record's, from the
    ghost map) against the brute total of its synced positions. Returns
    the largest errors in units of the JAX package's limits (D_*); those
    named in ``gate`` must be within them."""
    st, gm, pot = setup.states, setup.gms, setup.pot
    r, n = st.pos.shape[:2]
    gen = torch.Generator().manual_seed(seed)
    ids = torch.stack([torch.randperm(n, generator=gen)[:movers]
                       for _ in range(r)]).to(DEV)
    disp = ((torch.rand((r, movers, 3), generator=gen) - 0.5) * 0.3).to(DEV)
    old = gm.pos_ext.gather(1, ids[..., None].expand(-1, -1, 3))
    de, dw = DD.delta_moves_dense(pot, gm, ids.int(), old, old + disp,
                                  with_virial=True)
    err = {"de": 0.0, "dw": 0.0, "pe": 0.0, "virial": 0.0}
    for k in range(r):
        for m in range(movers):
            i = int(ids[k, m])
            bde, bdw = delta_move_brute(pot, st.pos[k], st.box[k], i,
                                        st.pos[k, i] + disp[k, m])
            for f, got, want, atol in (("de", de[k, m], bde, D_DE_ABS),
                                       ("dw", dw[k, m], bdw, D_DW_ABS)):
                e = float((got - want).abs() / (atol + D_RTOL * want.abs()))
                err[f] = max(err[f], e)
        bpe, bvir = pair_energy_virial(pot, st.pos[k], st.box[k])
        for f, got, want, atol in (("pe", st.pe[k], bpe, D_PE_ABS),
                                   ("virial", st.virial[k], bvir,
                                    D_VIR_ABS)):
            e = float((got - want).abs() / (atol + D_TOT_RTOL * want.abs()))
            err[f] = max(err[f], e)
    check(max(err[f] for f in gate) <= 1.0, f"[{tag}] dense energies "
          f"against brute force beyond the JAX limits (1 = at the limit): "
          f"{err}")
    return err


def dense_small_cfg():
    """The physics phase's configuration (256 atoms, a 2x12 grid, seed 7)
    cut to 2 records of 2 sweeps: dense-physics then needs no compile of
    its own."""
    return dataclasses.replace(validation_cfg(7), name="dsmall", nsmpl=2,
                               mod=2, ncut=0)


def phase_dense_small(name):
    """A short chunk on the card (``dense_small_cfg``): a record block's
    draws against the CPU's, bit for bit but ln u (ulps printed); the chunk through CUDA graphs against its stages run
    eagerly, bit for bit; dE, dW and the record energies against
    brute-force minimum image, within the JAX dense tests' limits;
    against the port's CPU run of the same chunk (printed, not gated:
    energies part at f32 rounding there)."""
    cfg = dense_small_cfg()
    g = runner.setup_run(cfg, engine="dense", device=DEV)
    cc = g.cellcfg
    kw = runner.dense_run_kwargs(g, cfg.nsmpl, False)
    dg, dc = (DS.block_draws(k, cfg.mod, kw["npasses"], kw["nvol"],
                             cc.ncolors, cc.cells_per_color)
              for k in (g.states.key, g.states.key.cpu()))
    for k, a, b in zip(("key", "volume steps", "shift", "u", "disp"), dg,
                       dc):
        check(torch.equal(a.cpu(), b), f"[dense-small] draws differ: {k}")
    ln_ulps = max(f32_ulps(dg[k], dc[k]) for k in (5, 6))
    DS.reset_counts()
    a = dense_chunk(cfg, DEV)
    counts = dict(DS.COUNTS)
    e = dense_chunk(cfg, DEV, graphs=False)
    for f in FIELDS:
        check(torch.equal(getattr(a[0].states, f), getattr(e[0].states, f)),
              f"[dense-small] graphs against eager: {f} differs")
    for f in GH.FIELDS:
        check(torch.equal(getattr(a[0].gms, f), getattr(e[0].gms, f)),
              f"[dense-small] graphs against eager: ghost map {f} differs")
    check(torch.equal(a[0].states.key, e[0].states.key)
          and torch.equal(a[2][0], e[2][0]) and torch.equal(a[3], e[3])
          and torch.equal(a[4], e[4]),
          "[dense-small] graphs against eager: keys, frames, hist or xacc "
          "differ")
    check(a[5] == 0, f"[dense-small] diag {a[5]}")
    err = dense_brute(a[0], "dense-small")
    c = dense_chunk(cfg, "cpu")
    same = torch.equal(a[3].cpu(), c[3]) and torch.equal(a[4].cpu(), c[4])
    dec = all(torch.equal(getattr(a[1], f).cpu(), getattr(c[1], f))
              for f in ("acc_pos", "acc_vol", "dpos", "dvol"))
    pe_rel = float(((a[1].pe.cpu() - c[1].pe) / c[1].pe).abs().max())
    log(f"[dense-small] chunk of 2 x 2 sweeps, R=24 x 256 atoms, xacc "
        f"{a[4].tolist()}: CUDA graphs equal eager bit for bit; against "
        "brute-force minimum image (1 = the JAX tests' limit): "
        + ", ".join(f"{k} {v:.3f}" for k, v in err.items())
        + f"; a block's draws equal the CPU's bit for bit, ln u within "
        f"{ln_ulps} f32 ulps; against the CPU: hist and xacc equal {same}, "
        f"decisions "
        f"equal {dec}, record pe rel {pe_rel:.2e}; {counts} on {name}")


def phase_dense_physics(name):
    """The physics phase's configuration and gate on the dense engine
    (melting_pipeline(engine="dense")), printed beside the JAX gather
    chains of the same seeds, one after another in this process."""
    with open(LJ_REFERENCE) as f:
        ref = json.load(f)
    t = time.perf_counter()
    chains, _ = physics_chains("dense-physics", [
        (seed, validation_cfg(seed), dict(nbins=48, model="mlp", epochs=400,
                                          band=2, engine="dense"))
        for seed in ref["chain_seeds"]])
    tms, secs, ms_sweep, rb, sy = [], [], [], [], []
    for seed in ref["chain_seeds"]:
        cfg = validation_cfg(seed)
        res, counts, sec = chains[seed]
        sweeps = counts["sweeps"]
        check(sweeps == cfg.nsmpl * cfg.mod, f"[dense-physics] seed {seed}: "
              f"{sweeps} dense sweeps, not {cfg.nsmpl * cfg.mod}")
        check(res.diag == 0 and np.isfinite(res.tm).all(),
              f"[dense-physics] seed {seed}: diag {res.diag}, T_m {res.tm}")
        secs.append(sec)
        ms_sweep.append(1e3 * res.seconds["sampling"] / sweeps)
        rb.append(counts["rebuilds"] / sweeps)
        sy.append(counts["syncs"] / sweeps)
        tms.append(res.tm)
        log(f"[dense-physics] seed {seed}: T_m(P*)={np.round(res.tm, 4)}; "
            f"{sec:.1f} s (sampling {res.seconds['sampling']:.1f} s, "
            f"{ms_sweep[-1]:.2f} ms a sweep, {rb[-1]:.2f} rebuilds and "
            f"{sy[-1]:.2f} syncs a sweep), diag {res.diag}")
    port = np.asarray(tms)[:, 0]
    jax_tm = np.asarray([c["tm"][0] for c in ref["chains"]])
    mean = float(port.mean())
    err = abs(mean / 0.78 - 1.0)
    log(f"[dense-physics] T_m(P*=1) by chain (seeds {ref['chain_seeds']}): "
        f"port dense {np.round(port, 4).tolist()}, JAX gather "
        f"{np.round(jax_tm, 4).tolist()}")
    log(f"[dense-physics] mean T_m(P*=1) port dense {mean:.4f} (sd "
        f"{port.std(ddof=1):.4f}), JAX gather {jax_tm.mean():.4f}; "
        f"|mean/0.78 - 1| = {err:.4f} (gate 0.02: "
        f"{'PASS' if err <= 0.02 else 'MISS'}); {np.mean(secs):.1f} s a "
        f"chain, {np.mean(ms_sweep):.2f} ms a sweep (sampling incl. set-up),"
        f" {np.mean(rb):.2f} rebuilds and {np.mean(sy):.2f} host syncs a "
        f"sweep; {time.perf_counter() - t:.1f} s in all on {name}")
    check(err <= 0.02,
          f"[dense-physics] mean T_m(P*=1)={mean} misses the 2% gate")


def phase_dense_full(name):
    """gather-full's configuration (4096 LJ atoms, the JAX CLI's 4x16 grid,
    R=64, seed 1234) on the dense engine: two chunks of 2 records x 4
    sweeps through setup_run(engine="dense"); ms a sweep, rebuilds and
    host syncs a sweep, peak memory; the record energies of replicas 0
    and 63 against brute force within the JAX total's limits, and a few
    moves' dE and dW (printed: at this box the f32 cancellation in
    |r|^2 - 2 r.p + |p|^2, with |p|^2 up to ~1300, exceeds the limits
    the JAX tests set at 256 atoms, in the JAX algorithm too)."""
    cfg = gather_full_cfg()
    sweeps = cfg.nsmpl * cfg.mod
    torch.cuda.reset_peak_memory_stats()
    t = runner.timed(DEV)
    setup = runner.setup_run(cfg, engine="dense", device=DEV)
    t_setup = runner.timed(DEV) - t
    gm = setup.gms
    for k in range(2):
        DS.reset_counts()
        t = runner.timed(DEV)
        setup, _, _, _, xacc, diag = runner.run_sampling(
            setup, write_files=False, write_traj=False)
        dt = runner.timed(DEV) - t
        check(diag == 0, f"[dense-full] chunk {k} diag {diag}")
        what = "captures the CUDA graphs" if k == 0 else "replays them"
        log(f"[dense-full] chunk {k} ({what}): {dt:.2f} s, "
            f"{1e3 * dt / sweeps:.1f} ms a "
            f"sweep, {DS.COUNTS['rebuilds'] / sweeps:.2f} rebuilds, "
            f"{DS.COUNTS['syncs'] / sweeps:.2f} host syncs and "
            f"{DS.COUNTS['replays'] / sweeps:.2f} graph replays a sweep, xacc"
            f" {xacc.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sub = dataclasses.replace(
        setup, states=setup.states.__class__(**{
            f: getattr(setup.states, f)[[0, 63]] for f in FIELDS}),
        gms=GH.GhostMap(**{f: getattr(setup.gms, f)[[0, 63]]
                              for f in GH.FIELDS}))
    err = dense_brute(sub, "dense-full", movers=2, gate=("pe", "virial"))
    log(f"[dense-full] R=64 x 4096 atoms, cells {setup.cellcfg.ncell}, "
        f"{setup.cellcfg.cells_per_color} movers a colour, "
        f"{CB.default_npasses(4096, setup.cellcfg)} passes and "
        f"{runner.nvol_per_sweep(cfg, 4096)} volume trials a sweep, shell "
        f"{setup.shell}, gcap {setup.gcap} (N + gcap = "
        f"{gm.pos_ext.shape[1]}, {int(gm.nghost.max())} images at set-up): "
        f"set-up {t_setup:.2f} s; peak memory {peak:.2f} GiB; replicas 0 "
        "and 63 against brute force (1 = the JAX tests' limit): "
        + ", ".join(f"{k} {v:.3f}" for k, v in err.items()) + f" on {name}")


# ---------------------------------------------------------------------------
# EAM path
# ---------------------------------------------------------------------------

def eam_table():
    path = os.path.join(tempfile.mkdtemp(prefix="nm_smoke_"),
                        "al38.eam.alloy")
    eam_gen.write_setfl(path, rc=3.8)
    return path


def eam_small_case(cheb, r, seed=0, cells=(4, 4, 4), kcap=16):
    """Jittered fcc Al replicas, stride-3 cells (3,3,3) at the default 256
    atoms, slot capacity ``kcap``."""
    pos, box = make_supercell("fcc", 4.05, cells)
    g = np.random.default_rng(seed)
    pos = np.stack([(pos + 0.08 * g.standard_normal(pos.shape)) % box
                    for _ in range(r)]).astype(np.float32)
    boxes = np.repeat(np.asarray(box, np.float32)[None], r, 0)
    geom = CG.make_geom(box, cheb.rc_host, len(pos), nsub=1, stride=3,
                        kcap=kcap)
    x, y, z, ids, count, over = CG.bin_initial(
        geom, torch.as_tensor(pos, device=DEV),
        torch.as_tensor(boxes, device=DEV),
        torch.tensor([0.3, 0.65, 0.11], device=DEV))
    check(not bool(over), "eam small case overflows its slots")
    temps = np.linspace(300.0, 1500.0, r).astype(np.float32)
    w = boxes / np.asarray(geom.ncell, np.float32)
    params = np.concatenate([(1.0 / (8.617333262e-5 * temps))[:, None],
                             np.full((r, 1), 0.15, np.float32), w, boxes], 1)
    return geom, (x, y, z), ids, count, torch.as_tensor(params, device=DEV)


def compare_eam_total(geom, slabs, ids, params, scal, series, tag):
    r = slabs[0].shape[0]
    valid = ids >= 0
    for wv, scale in ((True, torch.ones(r, device=DEV)),
                      (False, torch.linspace(0.98, 1.02, r, device=DEV))):
        k, krho = CE.total(geom, slabs, params, scal, series, scale, wv)
        k2, krho2 = CE.total(geom, slabs, params, scal, series, scale, wv)
        p, prho = CE.total_plain(geom, slabs, params, scal, series, scale,
                                 wv)
        torch.cuda.synchronize()
        check(torch.equal(k, k2) and torch.equal(krho, krho2),
              f"[{tag}] two eam total calls differ (virial={wv})")
        rows = [0, 1, 2, 3, 5, 6] if wv else [0, 2, 3]
        # each row relative to its own magnitude, at least 1; but E = E_pair
        # + E_emb and W = -(W_pair' + W_emb') are sums of two parts that
        # cancel (W near zero pressure), so those two rows relative to the
        # magnitude of their parts, at least 1
        mag = p.abs()
        mag[:, 0] = mag[:, 2] + mag[:, 3]
        mag[:, 1] = mag[:, 5] + mag[:, 6]
        err = (k - p).abs() / mag.clamp(min=1.0)
        by_row = {q: float(err[:, q].max()) for q in rows}
        rel = max(by_row.values())
        # rows 0 and 1 relative to themselves, for the record
        two = [q for q in rows if q < 2]
        own = ((k - p).abs() / p.abs().clamp(min=1.0))[:, two].max(0)[0]
        drho = float((krho - prho).abs()[valid].max())
        ERR["eam_total"] = max(ERR["eam_total"], drho)
        log(f"[{tag}] eam total R={r} virial={wv}: max rel err of stats "
            f"{rel:.3e} (limit 1e-5; by row "
            + ", ".join(f"{q}: {e:.1e}" for q, e in by_row.items())
            + f"; rows {two} relative to themselves "
            + ", ".join(f"{float(e):.1e}" for e in own)
            + f"), max |rho_k - rho_p| {drho:.3e} (limit 2e-5)")
        check(rel <= 1e-5, f"[{tag}] eam total disagrees: rel {rel}")
        check(drho <= 2e-5, f"[{tag}] eam total rho disagrees: {drho}")
        zero = [4, 7] if wv else [1, 4, 5, 6, 7]
        check(bool((k[:, zero] == 0).all()), f"[{tag}] eam stats rows")


def compare_eam_sweep(geom, slabs, ids, count, params, scal, series, rt,
                      tag, exact, ncyc=1, seed0=(4242, 17), sweep=3):
    """One B3 sweep by the kernel and by the plain version from the same
    slabs and density slab, at the threefry keys of ``seed0`` and
    ``sweep``; returns the kernel's slabs and the plain version's
    CUDA-event ms."""
    r = slabs[0].shape[0]
    ones = torch.ones(r, device=DEV)
    st0, rho0 = CE.total(geom, slabs, params, scal, series, ones, False)
    seeds = SC.tile_seeds(seed0, sweep, -(-r // rt), DEV)
    ks = tuple(a.clone() for a in slabs) + (rho0.clone(),)
    ps = tuple(a.clone() for a in slabs) + (rho0.clone(),)
    kst = CE.sweep(geom, ncyc, rt, ks, count, params, scal, series, seeds)
    pst, plain_ms = timed_ms(lambda: CE.sweep_plain(
        geom, ncyc, rt, ps, count, params, scal, series, seeds))
    st1, rho1 = CE.total(geom, ks[:3], params, scal, series, ones, False)
    valid = ids >= 0
    dpos = max(float((a - b)[valid].abs().max())
               for a, b in zip(ks[:3], ps[:3]))
    drho = float((ks[3] - ps[3])[valid].abs().max())
    dfresh = float((ks[3] - rho1)[valid].abs().max())
    ntry_eq = bool(torch.equal(kst[:, 2], pst[:, 2]))
    nacc_k, nacc_p = float(kst[:, 1].sum()), float(pst[:, 1].sum())
    ndiff = int((kst[:, 1] != pst[:, 1]).sum())
    nacc_rel = abs(nacc_k - nacc_p) / max(nacc_p, 1.0)
    tracked = kst[:, 0].double()
    true = (st1[:, 0] - st0[:, 0]).double()
    tol = 5e-3 + 1e-4 * true.abs() + 2.0 ** -21 * st0[:, 0].double().abs()
    bad = int(((tracked - true).abs() > tol).sum())
    log(f"[{tag}] eam sweep R={r} rt={rt} ncyc={ncyc}: n_try equal "
        f"{ntry_eq}, n_acc kernel {nacc_k:.0f} plain {nacc_p:.0f} (rel "
        f"{nacc_rel:.2e}, {ndiff} replicas differ), max |dx| {dpos:.3e}, "
        f"max |rho_k - rho_p| {drho:.3e}, max |rho_k - fresh B4| "
        f"{dfresh:.3e}, pe identity misses {bad}/{r} (max |tracked - "
        f"true| {float((tracked - true).abs().max()):.3e})")
    check(ntry_eq, f"[{tag}] eam n_try differs")
    check(bad == 0, f"[{tag}] eam pe identity fails on {bad} replicas")
    check(dfresh <= 1e-4, f"[{tag}] eam density slab drifted: {dfresh}")
    # B3 never moves an atom out of its cell. The binning takes the cell
    # as int(y / w), as the JAX package does, and B3 tests tab*w <= y <
    # tab*w + w: at a cell edge y / w can round onto the next integer while
    # tab*w rounds past y, so an atom may lie an ulp or two of the box
    # outside its cell's f32 bounds. Such an atom, left where it was, is
    # not one B3 moved out; anything farther out is a binning fault
    wv = params[:, 2:5]
    tabs = torch.as_tensor(CG.geom_tables(geom), device=DEV)
    edge = torch.zeros_like(valid)
    left = torch.zeros_like(valid)
    beyond = 0.0
    for a in range(3):
        lo = tabs[a][None].to(torch.float32) * wv[:, a, None]
        hi = lo + wv[:, a, None]
        out = valid & ((slabs[a] < lo) | (slabs[a] >= hi))
        edge |= out
        left |= valid & ((ks[a] < lo) | (ks[a] >= hi))
        if bool(out.any()):
            gap = torch.maximum(lo - slabs[a], slabs[a] - hi)
            beyond = max(beyond, float(gap[out].max()))
    moved = (ks[0] != slabs[0]) | (ks[1] != slabs[1]) | (ks[2] != slabs[2])
    ulps = 8.0 * torch.finfo(torch.float32).eps * float(params[:, 5:8].max())
    if bool(edge.any()):
        log(f"[{tag}] {int(edge.sum())} atoms binned outside their cell's "
            f"f32 bounds (a cell edge; the farthest {beyond:.3e} A "
            f"beyond, limit {ulps:.3e}), {int((edge & moved).sum())} of "
            "them moved by the sweep")
    check(beyond <= ulps, f"[{tag}] an atom binned {beyond} A outside its "
          f"cell (limit {ulps}, 8 f32 ulps of the box)")
    check(not bool((left & (moved | ~edge)).any()),
          f"[{tag}] an atom left its cell")
    if exact:
        check(ndiff == 0 and dpos <= 1e-6 and drho <= 2e-5,
              f"[{tag}] eam decisions differ: {ndiff} replicas, |dx| "
              f"{dpos}, |drho| {drho}")
        ERR["eam_sweep"] = max(ERR["eam_sweep"], dpos)
    else:
        check(nacc_rel <= 1e-4, f"[{tag}] eam n_acc rel {nacc_rel} > 1e-4")
    return ks, plain_ms


def phase_eam_small(table):
    cheb = eam_cheb.from_spline(eam_mod.load(table))
    scal, series, nser = CE.eam_pack(cheb, DEV)
    log(f"[eam-small] Chebyshev series lengths {nser}, fit errors "
        f"{cheb.fit_err}")
    # R=3 and R=130 (two threefry tiles) at 256 atoms; then eambench's
    # cells (15,6,6) at K=40, where B3's CTA holds fewer warps than the
    # colour's 20 cells and a colour step takes a second round
    for r, cells, kcap in ((3, (4, 4, 4), 16), (130, (4, 4, 4), 16),
                           (3, (16, 8, 8), 40)):
        geom, slabs, ids, count, params = eam_small_case(cheb, r,
                                                         cells=cells,
                                                         kcap=kcap)
        rt = SC.pick_rt(r)
        warps = eam_sweep_warps(geom)
        log(f"[eam-small] geom ncell={geom.ncell} K={geom.kcap} R={r} "
            f"rt={rt} tiles={-(-r // rt)}; B3 takes {warps} warps for "
            f"{geom.cw} cells a colour")
        if kcap == 40:
            check(warps < geom.cw, f"[eam-small] K=40 takes {warps} warps "
                  f"for {geom.cw} cells: no second round")
        compare_eam_total(geom, slabs, ids, params, scal, series,
                          "eam-small")
        compare_eam_sweep(geom, slabs, ids, count, params, scal, series, rt,
                          "eam-small", exact=True)
    geom, slabs, ids, count, params = edge_case(cheb.rc_host, 3, 1, 3, 6)
    log(f"[eam-small] edge case: cells {geom.ncell}, K={geom.kcap}, empty "
        f"cells {int((count == 0).sum())}, full cells "
        f"{int((count == geom.kcap).sum())}")
    compare_eam_total(geom, slabs, ids, params, scal, series,
                      "eam-small, edge")


def eam_sweep_warps(geom):
    """Warps of a B3 CTA at this geometry, from the kernel's own sizing:
    its dynamic shared memory is (C + W (135 + 81 K)) words."""
    smem = _build.load().nm_eam_sweep_smem(*geom.ncell, geom.kcap)
    return (smem // 4 - geom.ncells) // (135 + 81 * geom.kcap)


def eam_bounds(geom, slabs, count, params, scal, nser, rt, ncyc):
    """Least ms, and what bounds it, of the work of B4 (without and with
    the virial) and of one B3 sweep of ncyc cycles on these inputs. B4's
    phi and rho terms are symmetric in i and j, so a pass needs each
    unordered candidate pair (half stencil, the cells the box test keeps)
    once and a Clenshaw pair term for each unordered pair inside rc (with
    the virial also phi' and f_rho' there, and F' of each atom); a B3
    trial needs its mover's 27 cells at the old and the new position."""
    r = slabs[0].shape[0]
    cand = stencil_sum(geom, count, STENCIL27) - 1.0
    n_in = pairs_within(geom, slabs, params, float(scal[0]))
    half, tests = half_candidates(geom, slabs, params, count,
                                  float(scal[0]))
    natoms = r * geom.natoms
    nbar = n_in / natoms
    n_phi, n_rho, n_f = nser
    rows = r * geom.rows
    nser_all = 2 * (n_phi + n_rho + n_f)
    ops_total = (half * OPS_EAM_CAND + tests * OPS_BOX
                 + n_in / 2 * (n_phi + n_rho) * 3 + natoms * (3 * n_f + 4))
    nbytes = 4 * (3 * rows + 9 * r + 8 + nser_all) + 4 * (8 * r + rows)
    occupied = (count > 0).to(torch.float64)
    trials = ncyc * float(occupied.sum())
    sweep = bound(
        4 * (2 * 4 * rows + r * geom.ncells + 8 * r + 8 + n_phi + n_rho
             + n_f + 2 * (-(-r // rt))) + 4 * 8 * r,
        ncyc * float((occupied * cand).sum()) * OPS_EAM_SWEEP_CAND
        + trials * (2 * nbar * (n_phi + n_rho) * 3 + 2 * nbar * n_f * 3
                    + 2 * n_f * 3))
    return dict(total=bound(nbytes, ops_total),
                total_virial=bound(nbytes, ops_total + n_in / 2
                                   * (n_phi + n_rho) * 3
                                   + natoms * (3 * n_f + 4)),
                sweep=sweep, n_in=n_in, nbar=nbar, trials=trials, half=half,
                tests=tests)


def phase_eam_full(name, table):
    setup = runner.setup_run(FULL["eam"], setfl=table,
                             engine="cellmc", device=DEV)
    geom = setup.geom
    r = setup.states.temp.shape[0]
    rt = SC.pick_rt(r)
    ncyc = SC.default_ncyc(geom)
    params = SC.params_of(setup.states, geom, setup.us.kb)
    scal, series, nser = CE.eam_pack(setup.pot, DEV)
    slabs, ids, count = setup.slabs[:3], setup.slabs[3], setup.slab_count
    log(f"[eam-full] geom ncell={geom.ncell} K={geom.kcap} J={geom.nsub} "
        f"ncyc={ncyc} R={r} natoms={geom.natoms} series {nser}")
    compare_eam_total(geom, slabs, ids, params, scal, series, "eam-full")
    ks, _ = compare_eam_sweep(geom, slabs, ids, count, params, scal, series,
                              rt, "eam-full", exact=False, ncyc=ncyc)
    compare_eam_total(geom, ks[:3], ids, params, scal, series,
                      "eam-full, after a sweep")
    seeds = SC.tile_seeds((1, 2), 0, -(-r // rt), DEV)
    ones = torch.ones(r, device=DEV)
    work = tuple(a.clone() for a in setup.slabs[:3] + setup.slabs[4:])
    TIMES["eam_sweep"] = (
        cuda_ms(lambda: CE.sweep(geom, ncyc, rt, work, count, params, scal,
                                 series, seeds), 3),
        cuda_ms(lambda: CE.sweep_plain(geom, ncyc, rt, work, count, params,
                                       scal, series, seeds), 1))
    TIMES["eam_total"] = (
        cuda_ms(lambda: CE.total(geom, slabs, params, scal, series, ones,
                                 False), 10),
        cuda_ms(lambda: CE.total_plain(geom, slabs, params, scal, series,
                                       ones, False), 1))
    ms_v = cuda_ms(lambda: CE.total(geom, slabs, params, scal, series, ones,
                                    True), 5)
    eb = eam_bounds(geom, slabs, count, params, scal, nser, rt, ncyc)
    BOUND["eam_total"], bound_v, BOUND["eam_sweep"] = (
        eb["total"], eb["total_virial"], eb["sweep"])
    KERNELS["eam_total"].update(ms_virial=ms_v, bound_ms_virial=bound_v[0])
    log(f"[eam-full] ordered pairs inside rc {eb['n_in']} "
        f"({eb['nbar']:.2f} per atom), {eb['trials']:.0f} trials per "
        f"sweep; B4's bound counts {eb['half']:.0f} candidate pairs and "
        f"{eb['tests']:.0f} box tests; B4 with the virial "
        f"{ms_v:.3f} ms, bound {bound_v[0]:.4f} ms ({bound_v[1]})")
    for k in ("eam_sweep", "eam_total"):
        ms, pms = TIMES[k]
        log(f"[eam-full] {k}: kernel {ms:.3f} ms, plain {pms:.3f} ms per "
            f"call, bound {BOUND[k][0]:.4f} ms ({BOUND[k][1]}) (K="
            f"{geom.kcap}, cells {geom.ncell}, ncyc={ncyc}, R={r}, CUDA "
            f"events after warm-up) on {name}")
    # B3 and B4 at the slot capacity the main path's chunks run at: after
    # one warm-up chunk (as profile_chunk.py takes it) the runner has
    # grown K. Held to their plain versions there as at set-up, then timed
    # on the same inputs
    warm = runner.run_sampling(setup, write_traj=False)[0]
    gk = warm.geom
    ncyc_k = SC.default_ncyc(gk)
    params_k = SC.params_of(warm.states, gk, warm.us.kb)
    log(f"[eam-full] after a warm-up chunk: K={gk.kcap}, cells {gk.ncell}, "
        f"ncyc={ncyc_k}; B3 takes {eam_sweep_warps(gk)} warps for {gk.cw} "
        f"cells a colour")
    compare_eam_sweep(gk, warm.slabs[:3], warm.slabs[3], warm.slab_count,
                      params_k, scal, series, rt, "eam-full, chunk K",
                      exact=False, ncyc=ncyc_k)
    chunk = tuple(a.clone() for a in warm.slabs[:3] + warm.slabs[4:])
    ms_k = cuda_ms(lambda: CE.sweep(gk, ncyc_k, rt, chunk, warm.slab_count,
                                    params_k, scal, series, seeds), 3)
    KERNELS["eam_sweep"].update(chunk_kcap=gk.kcap, chunk_ms=ms_k)
    log(f"[eam-full] eam_sweep after a warm-up chunk: kernel {ms_k:.3f} ms "
        f"per call at the chunk's K={gk.kcap} (cells {gk.ncell}, ncyc="
        f"{ncyc_k}, R={r}, CUDA events after warm-up) on {name}")
    compare_eam_total(gk, warm.slabs[:3], warm.slabs[3], params_k, scal,
                      series, "eam-full, chunk K")
    t4 = [cuda_ms(lambda: CE.total(gk, warm.slabs[:3], params_k, scal,
                                   series, ones, wv), 10)
          for wv in (False, True)]
    KERNELS["eam_total"].update(chunk_kcap=gk.kcap, chunk_ms=t4[0],
                                chunk_ms_virial=t4[1])
    log(f"[eam-full] eam_total after a warm-up chunk: kernel {t4[0]:.3f} ms "
        f"per call, {t4[1]:.3f} ms with the virial, at the chunk's K="
        f"{gk.kcap} (set-up K={geom.kcap}: {TIMES['eam_total'][0]:.3f} / "
        f"{ms_v:.3f} ms; R={r}, CUDA events after warm-up) on {name}")
    # B3's two-round case: the chunk's ensemble re-binned at K=40, where a
    # CTA holds fewer warps than a colour's cells and a colour step runs a
    # second round (eam-small holds it exactly at R=3); held to the plain
    # versions and timed at this R
    two = runner._rebind_cellmc(warm, dataclasses.replace(gk, kcap=40))
    g40 = two.geom
    check(g40.kcap == 40, f"[eam-full] re-binned at K={g40.kcap}, not 40")
    w40 = eam_sweep_warps(g40)
    check(w40 < g40.cw, f"[eam-full] K=40 takes {w40} warps for {g40.cw} "
          "cells: no second round")
    timed_eam_pair(name, "eam-full, K=40", "k40", two, rt, seeds, ones,
                   extra={"k40_warps": w40})


def timed_eam_pair(name, tag, key, setup, rt, seeds, ones, extra=None):
    """B3 (one sweep of the default cycles) and B4 (without and with the
    virial) at ``setup``'s cellmc slabs: held to their plain versions,
    then CUDA-event times of kernel and plain version beside the bound,
    stored on the kernels line's B3 and B4 entries as ``key``_* fields."""
    geom = setup.geom
    ncyc = SC.default_ncyc(geom)
    params = SC.params_of(setup.states, geom, setup.us.kb)
    scal, series, nser = CE.eam_pack(setup.pot, DEV)
    slabs, ids, count = setup.slabs[:3], setup.slabs[3], setup.slab_count
    r = slabs[0].shape[0]
    compare_eam_total(geom, slabs, ids, params, scal, series, tag)
    # the plain version's time is that of its one run in the comparison
    _, sweep_plain = compare_eam_sweep(geom, slabs, ids, count, params, scal,
                                       series, rt, tag, exact=False,
                                       ncyc=ncyc)
    work = tuple(a.clone() for a in setup.slabs[:3] + setup.slabs[4:])
    sweep_ms = cuda_ms(lambda: CE.sweep(geom, ncyc, rt, work, count, params,
                                        scal, series, seeds), 3)
    tot = [cuda_ms(lambda: CE.total(geom, slabs, params, scal, series, ones,
                                    wv), 10) for wv in (False, True)]
    tot_plain = cuda_ms(lambda: CE.total_plain(geom, slabs, params, scal,
                                               series, ones, False), 1)
    eb = eam_bounds(geom, slabs, count, params, scal, nser, rt, ncyc)
    common = {f"{key}_kcap": geom.kcap, f"{key}_cells": list(geom.ncell),
              f"{key}_replicas": r}
    KERNELS["eam_sweep"].update(
        common, **{f"{key}_ms": sweep_ms, f"{key}_plain_ms": sweep_plain,
                   f"{key}_bound_ms": eb["sweep"][0],
                   f"{key}_bound_by": eb["sweep"][1],
                   f"{key}_ncyc": ncyc}, **(extra or {}))
    KERNELS["eam_total"].update(
        common, **{f"{key}_ms": tot[0], f"{key}_ms_virial": tot[1],
                   f"{key}_plain_ms": tot_plain,
                   f"{key}_bound_ms": eb["total"][0],
                   f"{key}_bound_ms_virial": eb["total_virial"][0],
                   f"{key}_bound_by": eb["total"][1]})
    log(f"[{tag}] K={geom.kcap}, cells {geom.ncell}, ncyc={ncyc}, R={r}, "
        f"B3 {eam_sweep_warps(geom)} warps for {geom.cw} cells a colour: "
        f"eam_sweep kernel {sweep_ms:.3f} ms, plain {sweep_plain:.3f} ms, "
        f"bound {eb['sweep'][0]:.4f} ms ({eb['sweep'][1]}); eam_total "
        f"kernel {tot[0]:.3f} ms ({tot[1]:.3f} with the virial), plain "
        f"{tot_plain:.3f} ms, bound {eb['total'][0]:.4f} ms "
        f"({eb['total_virial'][0]:.4f} with the virial; "
        f"{eb['total'][1]}); {eb['nbar']:.2f} neighbours inside rc an "
        f"atom (CUDA events after warm-up) on {name}")


def phase_eam_main(name, table):
    cfg = FULL["eam"]
    CE.reset_launches()
    res = melting_pipeline(cfg, setfl=table, nbins=64, model="cnn",
                           epochs=100, engine="cellmc")
    launches = dict(CE.LAUNCHES)
    for k in ("eam_sweep", "eam_total"):
        KERNELS[k]["launches"] = launches[k]
    s = res.seconds
    rate = res.moves_tried / s["sampling"]
    log(f"[eam-main] diag={res.diag} launches={launches} moves_tried="
        f"{res.moves_tried} T_m(P) first/last={res.tm[0]:.1f}/"
        f"{res.tm[-1]:.1f} K")
    log(f"[eam-main] attempted moves/s {rate:.4e} (sampling incl. setup "
        f"{s['sampling']:.3f} s, features {s['features']:.3f} s, classifier "
        f"{s['classifier']:.3f} s) on {name}")
    check(res.diag == 0, f"[eam-main] diag {res.diag}")
    check(all(v > 0 for v in launches.values()),
          f"[eam-main] a kernel never launched: {launches}")
    check(np.isfinite(res.tm).all() and np.isfinite(res.probs).all(),
          "[eam-main] non-finite T_m or probabilities")
    check(res.probs.shape == (16, 16) and res.g_slot.shape == (256, 64),
          "[eam-main] output shapes")
    check(np.isfinite(res.g_slot).all() and np.isfinite(res.sq_slot).all(),
          "[eam-main] non-finite features")
    pe = res.records.pe.cpu().numpy() / 4096
    check(np.isfinite(pe).all() and (pe < -2.5).all() and (pe > -3.5).all(),
          "[eam-main] record pe/N not finite or outside (-3.5, -2.5) eV")


# ---------------------------------------------------------------------------
# EAM on the gather engine (no TPU kernel: the same graphed torch stages,
# with the spline tables on the card and the density cache)
# ---------------------------------------------------------------------------

# 256 Al atoms on the rc 3.8 table (stride-2 cells at 2 rc: (2, 2, 2)),
# a 2x2 grid close enough for swaps, 2 records of 2 sweeps
EAM_GATHER_SMALL = dict(name="egsmall", element="AL", ncells=(4, 4, 4),
                        npress=2, ntemp=2, press=(1.0, 500.0),
                        temp=(900.0, 950.0), nsmpl=2, mod=2, ncut=0, seed=3,
                        dpos0=0.1, dvol0=0.01)


def rho_err(a, b):
    """Largest |a - b| of two density caches over the largest density."""
    return float((a.cpu() - b.cpu()).abs().max() / b.abs().max())


def phase_eam_gather_small(name, table):
    """EAM on gather at 256 atoms, R=4: a pass's draws, one pass and one
    tail (a volume trial and an HMC move) eager on the card against the
    port on the CPU from the same state, then one chunk: through CUDA
    graphs against eager on the card (bits), against the CPU (decisions
    equal, energies, frames and the density cache within the gather
    tests' limits)."""
    cfg = RunConfig(**EAM_GATHER_SMALL)
    g = runner.setup_run(cfg, setfl=table, device=DEV)
    c = runner.setup_run(cfg, setfl=table, device="cpu")
    cc = g.cellcfg
    check(cc.ncell == (2, 2, 2) and g.style == "eam",
          f"[eam-gather-small] cells {cc.ncell}, style {g.style}")
    err0 = rho_err(g.aux, c.aux)
    kd = J.fold_in(g.states.key, 3)
    dg = CB.pass_draws(kd, cc.ncolors, cc.cells_per_color, g.states.dpos)
    dc = CB.pass_draws(kd.cpu(), cc.ncolors, cc.cells_per_color,
                       c.states.dpos)
    for k, a, b in zip(("shift", "order", "u", "disp"), dg, dc):
        check(torch.equal(a.cpu(), b), f"[eam-gather-small] draws differ: "
              f"{k}")
    ln_ulps = f32_ulps(dg[4], dc[4])
    n_ulps = f32_ulps(J.normal(g.states.key, (256, 3)),
                      J.normal(c.states.key, (256, 3)))
    # one pass (the card's colour substeps compiled): each decision's margin
    one_pass = CB.make_cb_pass_fn(g.us.kb, cc, "eam")
    tg, tc = [], []
    sg, ag = one_pass(g.pot, g.table, g.states, g.nls, g.aux, g.states.dpos,
                      kd, trace=tg)
    sc, ac = one_pass(c.pot, c.table, c.states, c.nls, c.aux, c.states.dpos,
                      kd.cpu(), trace=tc)
    differ, margins = 0, []
    for (vg, a1, mg), (vc, a2, mc) in zip(tg, tc):
        bad = (a1.cpu() != a2) & vc
        differ += int(bad.sum())
        margins += mc[bad].abs().tolist()
    ndec = int(sum(int(v.sum()) for v, _, _ in tc))
    check(all(m < G_MARGIN for m in margins),
          f"[eam-gather-small] a decision differs beyond rounding: {margins}")
    err = {}
    if not differ:
        err["pass_pos"] = float((sg.pos.cpu() - sc.pos).abs().max()
                                / sc.box.max())
        err["pass_pe"] = float(((sg.pe.cpu() - sc.pe) / sc.pe).abs().max())
        err["pass_rho"] = rho_err(ag, ac)
        check(err["pass_pos"] <= G_POS and err["pass_pe"] <= G_RTOL
              and err["pass_rho"] <= G_RTOL,
              f"[eam-gather-small] the pass differs: {err}")
    compiled_against_eager("eam-gather-small", g, "eam", kd, sg, ag, tg)
    # the tail: a volume trial and an HMC move of 8 leapfrog steps
    tail = CB.make_cb_tail_fn(g.us.kb, g.us.p2e, nvol=1, nhmc=1, nstps=8,
                              mass=g.mass, style="eam")
    kt = J.split(g.states.key, 2)
    tg_s, tg_a = tail(g.pot, g.states, g.nls, g.aux, kt[:, 0], kt[:, 1])
    tc_s, tc_a = tail(c.pot, c.states, c.nls, c.aux, kt[:, 0].cpu(),
                      kt[:, 1].cpu())
    for f in ("nav", "ntv", "nah", "nth"):
        check(torch.equal(getattr(tg_s, f).cpu(), getattr(tc_s, f)),
              f"[eam-gather-small] tail decisions differ: {f}")
    check(torch.equal(tg_a, EE.rho_sums(g.pot, tg_s.pos, tg_s.box, g.nls)),
          "[eam-gather-small] the tail's density cache is not rho_sums of "
          "its configuration")
    err["tail_pe"] = float(((tg_s.pe.cpu() - tc_s.pe) / tc_s.pe).abs().max())
    err["tail_rho"] = rho_err(tg_a, tc_a)
    check(err["tail_pe"] <= G_RTOL and err["tail_rho"] <= G_RTOL,
          f"[eam-gather-small] the tail differs: {err}")
    log(f"[eam-gather-small] draws: shift, colour order, picks and "
        f"displacements equal bit for bit, ln u within {ln_ulps} f32 ulps, "
        f"HMC normals within {n_ulps}; rho at set-up rel {err0:.2e}; one "
        f"pass, {ndec} decisions: {differ} differ"
        + (f", margins {margins}" if differ else "")
        + f"; the tail (volume + HMC, accepted {int(tg_s.nav.sum())} + "
        f"{int(tg_s.nah.sum())} of 4 + 4) decisions equal; "
        + ", ".join(f"{k} {v:.2e}" for k, v in err.items()))
    # one chunk: graphs against eager on the card (bits), card against CPU
    ENS.reset_counts()
    a = gather_chunk(cfg, DEV, setfl=table)
    counts = dict(ENS.COUNTS)
    e = gather_chunk(cfg, DEV, graphs=False, setfl=table)
    for f in FIELDS:
        check(torch.equal(getattr(a[0].states, f), getattr(e[0].states, f)),
              f"[eam-gather-small] graphs against eager: {f} differs")
    check(torch.equal(a[0].states.key, e[0].states.key)
          and torch.equal(a[2][0], e[2][0]) and torch.equal(a[0].aux,
                                                            e[0].aux),
          "[eam-gather-small] graphs against eager: keys, frames or rho "
          "differ")
    b = gather_chunk(cfg, "cpu", setfl=table)
    # EAM's virial nearly cancels at low pressure: it is held to its
    # summed term magnitudes, as the CPU tests hold it
    bs = b[0].states
    err = hold_chunk(a, b, "eam-gather-small", scale={
        "virial": EE.virial_scale(b[0].pot, bs.pos, bs.box, b[0].nls)})
    err["rho"] = rho_err(a[0].aux, b[0].aux)
    st = a[0].states
    check(torch.equal(a[0].aux, EE.rho_sums(a[0].pot, st.pos, st.box,
                                            a[0].nls)),
          "[eam-gather-small] the chunk's density cache is not rho_sums")
    check(a[5] == 0 and err["rho"] <= G_RTOL,
          f"[eam-gather-small] diag {a[5]}, rho rel {err['rho']:.2e}")
    log(f"[eam-gather-small] chunk of 2 x 2 sweeps, xacc {a[4].tolist()}: "
        f"CUDA graphs equal eager bit for bit (rho too); against the CPU "
        f"hist, xacc and decisions equal, pe rel {err['pe']:.2e}, virial "
        f"{err['virial']:.2e} of its terms' magnitudes, vol {err['vol']:.2e},"
        f" frames {err['pos']:.2e}"
        f" of the box edge, rho {err['rho']:.2e}; rho equals rho_sums from "
        f"scratch; {counts} on {name}")


def phase_eam_gather_hmc(name, table):
    """A short HMC run at config 3's size (256 Al atoms, 10 temperatures),
    an HMC move of 8 leapfrog steps a sweep: diag 0 (no NL_STALE), HMC
    moves accepted, pe against a fresh list's total, and the forces
    against autograd of that total on the card."""
    cfg = dataclasses.replace(config3(5), name="eghmc", nsmpl=2, mod=4,
                              ncut=0, phmc=0.05, nstps=8)
    setup, recs, _, _, _, diag = runner.run_sampling(
        runner.setup_run(cfg, setfl=table, device=DEV), write_files=False)
    acc = recs.acc_hmc.cpu()
    check(diag == 0, f"[eam-gather-hmc] diag {diag} (8: NL_STALE)")
    check(float(acc.max()) > 0, "[eam-gather-hmc] no HMC move accepted")
    st, pot = setup.states, setup.pot
    nls, _ = ENS.build_ensemble_nl(pot, st, cfg.skin, capacity=setup.cap)
    pe_list, _ = EE.total_energy_virial(pot, st.pos, st.box, nls)
    e1 = float(((st.pe - pe_list).abs() / pe_list.abs()).max())
    f = EE.forces(pot, st.pos, st.box, nls)
    p = st.pos.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(
        EE.total_energy_virial(pot, p, st.box, nls)[0].sum(), p)
    fmax = float(f.abs().max())
    e2 = float((f + grad).abs().max()) / fmax
    log(f"[eam-gather-hmc] 10 replicas x 256 Al atoms, 2 x 4 sweeps, one HMC"
        f" move a sweep: acc_hmc by record {np.round(acc.numpy(), 3).tolist()}"
        f", diag {diag}; pe against a fresh list's total rel {e1:.2e} "
        f"(limit {G_RTOL}); forces against autograd max |f + grad| "
        f"{e2:.2e} of max |f| = {fmax:.3f} eV/A (limit 5e-3) on {name}")
    check(e1 <= G_RTOL, "[eam-gather-hmc] pe off its total")
    check(bool(torch.allclose(f, -grad, rtol=5e-3, atol=5e-3)),
          "[eam-gather-hmc] forces differ from autograd of the total")


def timed_ms(fn):
    """(fn(), its CUDA-event ms)."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def phase_eam_longrc(name):
    """Long-rc EAM (the rc 6.3 table, 7^3 = 1372 Al atoms): longrc_run at
    --fast's depth on the card (cellmc, B3 and B4 launched), B3 and B4 at
    its geometry (cells (3, 3, 3), one a colour, K=72) against their plain
    versions and timed, then a chunk on the default engine (gather, cells
    (2, 2, 2)) at R=8."""
    tmp = tempfile.mkdtemp(prefix="nm_longrc_")
    table = LRC.write_table(tmp)
    CE.reset_launches()
    res = LRC.run(fast=True, device=DEV, setfl=table)
    launches = {k: CE.LAUNCHES[k] for k in ("eam_sweep", "eam_total")}
    for k, v in launches.items():
        KERNELS[k]["launches_longrc"] = v
    log(f"[eam-longrc] longrc_run --fast: {json.dumps(res)}; launches "
        f"{launches}")
    check(res["diag"] == 0, f"[eam-longrc] cellmc diag {res['diag']}")
    check(res["geom_ncell"] == [3, 3, 3] and res["kcap"] >= 72,
          f"[eam-longrc] geometry {res['geom_ncell']} K={res['kcap']}")
    check(abs(res["pe_per_atom_initial"] - LRC_PE0) <= 1e-3,
          f"[eam-longrc] cellmc pe/N {res['pe_per_atom_initial']} vs "
          f"{LRC_PE0}")
    check(res["moves_per_sec"] > 0, "[eam-longrc] no attempted moves")
    check(all(v > 0 for v in launches.values()),
          f"[eam-longrc] a kernel never launched: {launches}")

    cfg = LRC.make_cfg()
    setup = runner.setup_run(cfg, setfl=table, engine="cellmc", device=DEV)
    geom = setup.geom
    check((geom.ncell, geom.kcap) == ((3, 3, 3), 72),
          f"[eam-longrc] set-up geometry {geom.ncell} K={geom.kcap}")
    r = setup.states.temp.shape[0]
    rt = SC.pick_rt(r)
    scal, series, _ = CE.eam_pack(setup.pot, DEV)
    # decisions and slabs exactly as the plain version's on one cycle
    # from jittered replicas
    jit = eam_small_case(setup.pot, r, cells=LRC.NCELLS, kcap=72)
    compare_eam_sweep(jit[0], jit[1], jit[2], jit[3], jit[4], scal, series,
                      rt, "eam-longrc", exact=True)
    timed_eam_pair(name, "eam-longrc", "k72", setup, rt,
                   SC.tile_seeds((1, 2), 0, -(-r // rt), DEV),
                   torch.ones(r, device=DEV))

    # the default engine at this table: gather on stride-2 cells at 2 rc
    cfg = dataclasses.replace(cfg, nsmpl=1, mod=2)
    g = runner.setup_run(cfg, setfl=table, device=DEV)
    pe0 = float(torch.mean(g.states.pe)) / g.natoms
    log(f"[eam-longrc] default engine {g.engine}: cells {g.cellcfg.ncell}, "
        f"list capacity {g.cap} (largest count "
        f"{int(g.nls.count.max())}), initial pe/N {pe0:.4f}")
    check(g.engine == "gather" and g.cellcfg.ncell == (2, 2, 2),
          f"[eam-longrc] default engine {g.engine}, cells "
          f"{g.cellcfg.ncell}")
    check(abs(pe0 - LRC_PE0) <= 1e-3,
          f"[eam-longrc] gather pe/N {pe0} vs {LRC_PE0}")
    sweeps = cfg.nsmpl * cfg.mod
    for k in range(2):
        ENS.reset_counts()
        out, ms = timed_ms(lambda: runner.run_sampling(
            g, write_files=False, write_traj=False))
        g, diag = out[0], out[5]
        c = dict(ENS.COUNTS)
        log(f"[eam-longrc] gather chunk {k} ("
            + ("the first: it compiles the colour substep and captures "
               "the CUDA graphs" if k == 0 else "graphs replayed")
            + f"), R={r}, 1 record x {sweeps} sweeps: {ms / sweeps:.1f} ms "
            f"a sweep, {c['rebuilds'] / sweeps:.2f} rebuilds, "
            f"{c['syncs'] / sweeps:.2f} host syncs, "
            f"{c['passes'] / sweeps:.0f} passes a sweep, diag {diag} on "
            f"{name}")
        check(diag == 0, f"[eam-longrc] gather chunk {k} diag {diag}")


def eam_gather_full_cfg():
    """eam-gather-full's configuration: eambench's physics (4096 Al atoms,
    16x8x8 fcc, the rc 3.8 table, seed 11) on the JAX CLI's default 4x16
    grid (R=64), chunks of 1 record x 2 sweeps."""
    lin = lambda a, b, n: tuple(float(v) for v in np.linspace(a, b, n))
    return dataclasses.replace(FULL["eam"], name="egfull", npress=4,
                               ntemp=16, press=lin(1.0, 5000.0, 4),
                               temp=lin(600.0, 1400.0, 16), nsmpl=1, mod=2)


def phase_eam_gather_full(name, table):
    """eambench's physics on the gather engine: 4096 Al atoms (16x8x8 fcc,
    the rc 3.8 table) on the JAX CLI's default 4x16 grid (R=64), two
    chunks of 1 record x 2 sweeps through setup_run (the first captures
    the CUDA graphs), timed with CUDA events only."""
    cfg = eam_gather_full_cfg()
    sweeps = cfg.nsmpl * cfg.mod
    torch.cuda.reset_peak_memory_stats()
    setup, ms_setup = timed_ms(lambda: runner.setup_run(cfg, setfl=table,
                                                        device=DEV))
    for k in range(2):
        ENS.reset_counts()
        moves0 = float(setup.moves_tried)
        out, ms = timed_ms(lambda: runner.run_sampling(setup,
                                                       write_files=False))
        setup, diag = out[0], out[5]
        check(diag == 0, f"[eam-gather-full] chunk {k} diag {diag}")
        c = dict(ENS.COUNTS)
        rate = (float(setup.moves_tried) - moves0) / (ms / 1e3)
        log(f"[eam-gather-full] chunk {k} ("
            + ("the first: it captures the CUDA graphs" if k == 0 else
               "graphs replayed") + f"): {ms / sweeps:.1f} ms a sweep, "
            f"{rate:.4e} attempted moves/s; a sweep {c['rebuilds'] / sweeps:.2f}"
            f" rebuilds, {c['syncs'] / sweeps:.2f} host syncs, "
            f"{c['replays'] / sweeps:.2f} graph replays, {c['passes'] / sweeps:.0f}"
            f" passes")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[eam-gather-full] R=64 x 4096 Al atoms, cells {setup.cellcfg.ncell}"
        f" (stride 2 at 2 rc), K={setup.cap}, set-up {ms_setup:.1f} ms, peak "
        f"memory {peak:.2f} GiB (CUDA events; no profiler) on {name}")


# ---------------------------------------------------------------------------
# the CLI stages and the bench
# ---------------------------------------------------------------------------

def run_stage(main, argv):
    """Call a CLI stage's main(argv) in-process; echo and return what it
    printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    text = buf.getvalue()
    for line in text.strip().splitlines():
        log(f"[cli]   | {line}")
    return text


def slot_pe(outdir, prefix, natoms):
    """(slots, nrec) pe/N from the .thrm files of a remcmc run."""
    paths = sorted(glob.glob(os.path.join(outdir, prefix + ".*.thrm")))
    return np.stack([thermo.read(p)[1]["pe"] / natoms for p in paths])


def phase_cli(name):
    """The five CLI stages at 4096 atoms on an 8x8 grid, then a restart."""
    tmp = tempfile.mkdtemp(prefix="nm_cli_")
    out, out2 = os.path.join(tmp, "out"), os.path.join(tmp, "restart")
    argv = ["-n", "cli", "-e", "LJ", "-ss", "16", "8", "8", "-pn", "8",
            "-pr", "1", "8", "-tn", "8", "-tr", "0.7", "1.3", "-sn", "4",
            "-sm", "8", "-sc", "1", "-sd", "1234", "--engine", "cellmc"]
    prefix = "cli.lj.fcc.16x8x8"
    secs = {}
    CK.reset_launches()
    t = time.perf_counter()
    summary = json.loads(run_stage(CLI_REMCMC.main, argv + ["-o", out])
                         .strip().splitlines()[-1])
    secs["remcmc"] = time.perf_counter() - t
    launches = dict(CK.LAUNCHES)
    for k in ("sweep", "total"):
        KERNELS[k]["launches_cli"] = launches[k]
    ckpt = os.path.join(out, "cli.lj.ckpt.npz")
    thrm = glob.glob(os.path.join(out, prefix + ".*.thrm"))
    trj = glob.glob(os.path.join(out, prefix + ".*.traj"))
    events = MetricsLogger.read(os.path.join(out, "metrics.jsonl"))
    log(f"[cli] remcmc: diag={summary['diag']} launches={launches} "
        f"{len(thrm)} .thrm, {len(trj)} .traj, text "
        f"{sum(os.path.getsize(p) for p in thrm + trj) / 1e6:.1f} MB, "
        f"writer {native.writer()}; {secs['remcmc']:.2f} s on {name}")
    check(summary["diag"] == 0, f"[cli] remcmc diag {summary['diag']}")
    check(launches["sweep"] > 0 and launches["total"] > 0,
          f"[cli] a kernel never launched: {launches}")
    check(len(thrm) == 64 and len(trj) == 64,
          f"[cli] {len(thrm)} .thrm and {len(trj)} .traj files, not 64")
    check(os.path.exists(ckpt), "[cli] no checkpoint")
    check([e["event"] for e in events] == ["sampling_chunk"],
          f"[cli] metrics events {[e['event'] for e in events]}")

    t = time.perf_counter()
    run_stage(CLI_PARSE.main, ["-i", out, "-n", "cli", "-e", "LJ"])
    secs["parse"] = time.perf_counter() - t
    parsed = os.path.join(out, prefix + ".parsed.npz")
    with np.load(parsed) as z:
        shape = z["positions"].shape
    check(shape == (8, 8, 4, 4096, 3), f"[cli] parsed positions {shape}")

    t = time.perf_counter()
    run_stage(CLI_RDF.main, ["-i", parsed, "--nbins", "64", "--cut", "1"])
    secs["rdf"] = time.perf_counter() - t
    rdfz = parsed.replace(".parsed.npz", ".rdf.npz")
    with np.load(rdfz, allow_pickle=True) as z:
        shape = z["g_mean"].shape
        check(np.isfinite(z["g_mean"]).all(), "[cli] non-finite g(r)")
    check(shape == (8, 8, 64), f"[cli] g_mean {shape}")

    t = time.perf_counter()
    run_stage(CLI_NEURAL.main, ["-i", rdfz, "--epochs", "100"])
    secs["neural"] = time.perf_counter() - t
    meltz = rdfz.replace(".rdf.npz", ".melt.npz")
    with np.load(meltz) as z:
        tm = z["tm"]
    check(tm.shape == (8,) and np.isfinite(tm).all(), f"[cli] T_m {tm}")

    t = time.perf_counter()
    post_out = run_stage(CLI_POST.main, ["-i", meltz, "--no-plot"])
    secs["post"] = time.perf_counter() - t
    check(post_out.count("T_m=") == 8, "[cli] post: not one row a pressure")

    t = time.perf_counter()
    summary2 = json.loads(run_stage(
        CLI_REMCMC.main, argv + ["-sn", "2", "-o", out2, "--restart", ckpt])
        .strip().splitlines()[-1])
    secs["restart"] = time.perf_counter() - t
    last = slot_pe(out, prefix, 4096)[:, -1]
    first = slot_pe(out2, prefix, 4096)[:, 0]
    gap = float(np.max(np.abs(first - last)))
    pos, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0), (16, 8, 8))
    lattice = float(pair_energy_virial(
        LJCut.create(), torch.as_tensor(pos, dtype=torch.float32, device=DEV),
        torch.as_tensor(box, dtype=torch.float32, device=DEV))[0]) / 4096
    log(f"[cli] restart: diag={summary2['diag']}; per slot |first pe/N - "
        f"checkpointed last| <= {gap:.4f} (limit {RESTART_TOL}); the "
        f"lattice's pe/N {lattice:.4f} against the last "
        f"{last.min():.4f}..{last.max():.4f}")
    check(summary2["diag"] == 0, f"[cli] restart diag {summary2['diag']}")
    check(gap <= RESTART_TOL, f"[cli] restart pe/N moved by {gap}")
    log(f"[cli] seconds: " + ", ".join(f"{k} {v:.2f}"
                                       for k, v in secs.items())
        + f"; text writer: {native.writer()} on {name}")
    # remcmc with no --engine runs gather (the JAX package's default) at a
    # small configuration, then resumes from its checkpoint
    outg = os.path.join(tmp, "gather")
    argv = ["-n", "clig", "-e", "LJ", "-ss", "4", "-pn", "2", "-pr", "1", "4",
            "-tn", "4", "-tr", "0.6", "1.2", "-sn", "4", "-sm", "4", "-sd",
            "5"]
    ENS.reset_counts()
    t = time.perf_counter()
    sg = json.loads(run_stage(CLI_REMCMC.main, argv + ["-o", outg])
                    .strip().splitlines()[-1])
    tg = time.perf_counter() - t
    sweeps = ENS.COUNTS["sweeps"]
    sg2 = json.loads(run_stage(CLI_REMCMC.main, argv + [
        "-sn", "2", "-o", outg + "2", "--restart",
        os.path.join(outg, "clig.lj.ckpt.npz")]).strip().splitlines()[-1])
    first = slot_pe(outg + "2", "clig.lj.fcc.4x4x4", 256)[:, 0]
    last = slot_pe(outg, "clig.lj.fcc.4x4x4", 256)[:, -1]
    gap = float(np.max(np.abs(first - last)))
    log(f"[cli] remcmc, default engine (gather), 8 x 256 atoms, 4 x 4 sweeps:"
        f" diag {sg['diag']}, {sweeps} gather sweeps, {tg:.2f} s; --restart "
        f"for 2 records: diag {sg2['diag']}, per slot |first pe/N - "
        f"checkpointed last| <= {gap:.4f} (limit {RESTART_TOL})")
    check(sg["diag"] == 0 and sg2["diag"] == 0 and sweeps == 16,
          f"[cli] gather remcmc: {sg}, {sg2}, {sweeps} sweeps")
    check(gap <= RESTART_TOL, f"[cli] gather restart pe/N moved by {gap}")


def phase_bench(name):
    CK.reset_launches()
    CE.reset_launches()
    t = time.perf_counter()
    row = BENCH.main([])
    launches = {**CK.LAUNCHES, **CE.LAUNCHES}
    for k, v in launches.items():
        KERNELS[k]["launches_bench"] = v
    log(f"[bench] launches={launches}; {time.perf_counter() - t:.1f} s on "
        f"{name}")
    for k in ("lj_kernel_diag", "lj_e2e_diag", "eam_diag"):
        check(row[k] == 0, f"[bench] {k} {row[k]}")
    for k in ("lj_kernel_moves_per_sec", "lj_e2e_moves_per_sec",
              "eam_moves_per_sec"):
        check(row[k] > 0, f"[bench] {k} {row[k]}")
    check(all(v > 0 for v in launches.values()),
          f"[bench] a kernel never launched: {launches}")


# ---------------------------------------------------------------------------
# the production drivers: north star, coexistence, the EAM melting sweep
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def watch_sampling(stop_at=None):
    """Record every runner.run_sampling chunk of the block (replicas,
    hist, xacc on the host, record pe); raise StopRun at call
    ``stop_at`` (1-based) instead of sampling it."""
    calls = []
    inner = runner.run_sampling

    def watched(*a, **kw):
        if stop_at is not None and len(calls) + 1 == stop_at:
            raise StopRun(f"stopped before chunk {stop_at}")
        out = inner(*a, **kw)
        _setup, recs, _frames, hist, xacc, diag = out
        calls.append(SimpleNamespace(
            replicas=int(hist.shape[1]), hist=hist.cpu().numpy(),
            xacc=xacc.cpu().numpy(), pe=recs.pe.double().cpu().numpy(),
            diag=diag))
        return out

    runner.run_sampling = watched
    try:
        yield calls
    finally:
        runner.run_sampling = inner


class StopRun(RuntimeError):
    pass


def rdf_variants(name):
    """C7 on the card: g(r) pair counts of the compiled bin pass (the
    production path) equal its eager form's on 64 frames of jittered
    4096-atom fcc; times of both a frame (CUDA events, after a warm-up),
    and what the eager form would add to [main]'s features seconds."""
    pos, box = make_supercell("fcc", 2.0 ** (2.0 / 3.0) * 1.03, (16, 8, 8))
    gen = torch.Generator(device=DEV).manual_seed(9)
    p = torch.as_tensor(pos, device=DEV)[None] + 0.12 * torch.randn(
        (64,) + pos.shape, generator=gen, device=DEV)
    b = torch.as_tensor(box, dtype=torch.float32, device=DEV)
    p = torch.remainder(p, b)
    b = b.expand(64, 3).contiguous()
    rmax = 0.48 * float(box.min())
    fused = RDF._pair_counts(p, b, 64, rmax, 1 << 25)
    eager = RDF._pair_counts(p, b, 64, rmax, 1 << 25, compiled=False)
    check(torch.equal(fused, eager), "[northstar] C7: compiled and eager "
          "g(r) pair counts differ on the card")
    ms = {}
    for tag, comp in (("compiled", True), ("eager", False)):
        # in rdf_frames' batches of 16 frames
        ms[tag] = cuda_ms(lambda: [RDF._pair_counts(
            p[i:i + 16], b[i:i + 16], 64, rmax, 1 << 25, comp)
            for i in range(0, 64, 16)], 3) / 64
    frames, feat_s = STAGE_S["main_frames"], STAGE_S["main_features"]
    extra = (ms["eager"] - ms["compiled"]) * frames / 1e3
    log(f"[northstar] C7 g(r) a 4096-atom frame (64 frames, CUDA events): "
        f"compiled {ms['compiled']:.4f} ms, eager {ms['eager']:.4f} ms; "
        f"the eager form over [main]'s {frames} frames adds {extra:.3f} s "
        f"= {100 * extra / feat_s:.1f}% of its features {feat_s:.3f} s; "
        f"counts equal on {name}")


def launches_of(keys):
    return {k: {**CK.LAUNCHES, **CE.LAUNCHES}[k] for k in keys}


def phase_northstar(name):
    """python -m neuralmelting_tpu_torch.northstar at full scale: the
    heating leg (32x32 x 4096 LJ atoms, 600 + 400 sweeps), then --cool at
    full width cut to 1 eq + 1 samp chunk, then a stopped and resumed
    --fast run."""
    tmp = tempfile.mkdtemp(prefix="nm_ns_")
    with open(os.path.join(HERE, "northstar_result.json")) as f:
        jax_ref = json.load(f)
    CK.reset_launches()
    t = time.perf_counter()
    res = NS.run(NS.make_cfg(), os.path.join(tmp, "st"),
                 os.path.join(tmp, "ns.json"), device=DEV,
                 **NS.schedule())
    dt = time.perf_counter() - t
    launches = launches_of(("sweep", "total"))
    for k, v in launches.items():
        KERNELS[k]["launches_northstar"] = v
    bd = res["breakdown"]
    log(f"[northstar] diag={res['diag']} launches={launches}; "
        f"{res['points_per_hour']:.1f} (P,T)-points/hour "
        f"({res['points_per_hour_steady']:.1f} steady), total "
        f"{res['total_seconds']} s: eq {res['eq_seconds']} s, samp "
        f"{res['sample_seconds']} s (sampling {bd['kernel_seconds']} s all "
        f"chunks, featurize {bd['featurize_seconds']} s, checkpoint "
        f"{bd['checkpoint_seconds']} s x {bd['checkpoint_count']}), train "
        f"{bd['train_seconds']} s, preflight {res['preflight_seconds']} s, "
        f"first-chunk excess {bd['first_chunk_excess_seconds']} s; "
        f"{res['moves_per_sec_nominal']:.4e} nominal moves/s; {dt:.1f} s "
        f"in all on {name}")
    log("[northstar] chunk log: " + json.dumps(bd["chunk_log"]))
    ref_tm = jax_ref["tm_by_pressure"]
    log("[northstar] T_m(P*) port / JAX package's northstar_result.json "
        "(physics, not speed): " + ", ".join(
            f"{p} {tm:.4f}/{ref_tm.get(p, float('nan')):.4f}"
            for p, tm in res["tm_by_pressure"].items()))
    log(f"[northstar] T_m(P*=1) {res['tm_p1']:.4f}, |T_m/0.78 - 1| "
        f"{res['tm_p1_rel_err']:.4f} (gate 0.02), resolved rows "
        f"{res['heat_resolved_rows']}/32")
    check(res["diag"] == 0, f"[northstar] diag {res['diag']}")
    check(res["heat_resolved_rows"] == 32,
          f"[northstar] {res['heat_resolved_rows']} resolved rows, not 32")
    check(res["pass_2pct"], f"[northstar] T_m(P*=1)={res['tm_p1']} misses "
          "the 2% gate")
    check(all(v > 0 for v in launches.values()),
          f"[northstar] a kernel never launched: {launches}")
    rdf_variants(name)

    t = time.perf_counter()
    cool = NS.run(NS.make_cfg(), os.path.join(tmp, "st_cool"),
                  os.path.join(tmp, "ns_cool.json"), eq_chunks=1,
                  samp_chunks=1, records=5, cool=True, device=DEV)
    br = cool["bracket"]
    log(f"[northstar] --cool, 1 eq + 1 samp chunk a leg: diag "
        f"{br['diag']}; T_m(P*=1) heat {cool['tm_p1']:.4f}, bracket "
        f"{br['tm_bracket_p1']}, cool resolved rows "
        f"{br['cool_resolved_rows']}/32, T_cool by P* "
        f"{br['tm_cool_by_pressure']}; cool leg {br['cool_seconds']} s, "
        f"{time.perf_counter() - t:.1f} s in all")
    check(br["diag"] == 0, f"[northstar] --cool diag {br['diag']}")

    state = os.path.join(tmp, "st_fast")
    out = os.path.join(tmp, "ns_fast.json")
    eq = NS.schedule(fast=True)["eq_chunks"]
    with watch_sampling(stop_at=eq + 1):
        try:
            NS.run(NS.make_cfg(fast=True), state, out, device=DEV,
                   **NS.schedule(fast=True))
            check(False, "[northstar] the first --fast attempt was not "
                  "stopped")
        except StopRun:
            pass
    with open(os.path.join(state, "progress.json")) as f:
        prog = json.load(f)
    fast = NS.run(NS.make_cfg(fast=True), state, out, device=DEV,
                  **NS.schedule(fast=True))
    log(f"[northstar] --fast stopped after its eq stage (eq_done "
        f"{prog['eq_done']}, samp_done {prog['samp_done']}) and resumed: "
        f"attempts_to_complete {fast['attempts_to_complete']}, diag "
        f"{fast['diag']}, T_m(P*=1) {fast['tm_p1']:.4f}")
    check((prog["eq_done"], prog["samp_done"]) == (eq, 0),
          f"[northstar] progress after the stop {prog}")
    check(fast["attempts_to_complete"] == 2 and fast["diag"] == 0,
          f"[northstar] resume: attempts {fast['attempts_to_complete']}, "
          f"diag {fast['diag']}")


def coexist_gates(tag, calls, out):
    """diag 0; xacc 0 and hist the identity in every coexistence chunk;
    finite liquid fractions; in the first chunk after the splice, the
    solid row's PE/atom below the liquid row's at every T. The liquid
    row's gap over the solid row is printed for that chunk and for the
    first measured one, where no gate can hold: the reference protocol's
    prepared liquid keeps nearly the lattice's density and its row
    freezes during the relaxation (ROADMAP C9). The JAX package's own
    chains show it on the CPU at the --fast size, gap -0.02..+0.05 in
    the first measured chunk (tests/golden/coexist_relax_jax.json), and
    tests/test_torch_coexist_relax.py holds the port's chains to
    them."""
    ntemp, relax = out["ntemp"], out["relax_chunks"]
    chunks = [c for c in calls if c.replicas == 3 * ntemp]
    ident = np.arange(3 * ntemp)
    check(out["diag"] == 0 and all(c.diag == 0 for c in calls),
          f"[coexist] {tag} diag {out['diag']}")
    check(len(chunks) == relax + out["measured_chunks"],
          f"[coexist] {tag}: {len(chunks)} chunks")
    check(all(int(c.xacc.sum()) == 0 and (c.hist == ident).all()
              for c in chunks), f"[coexist] {tag}: a swap or a moved slot")
    gap = {}
    for i in (0, relax):
        rows = CX.row_pe_per_atom(chunks[i].pe, chunks[i].hist,
                                  out["natoms"], ntemp)
        gap[i] = rows[CX.ROW_LIQUID] - rows[CX.ROW_SOLID]
    log(f"[coexist] {tag}: liquid - solid PE/atom by T, first chunk "
        f"{np.round(gap[0], 4).tolist()}; first measured chunk (after "
        f"{relax} relax) {np.round(gap[relax], 4).tolist()}")
    check((gap[0] > 0).all(), f"[coexist] {tag}: first chunk's solid "
          f"PE/atom not below the liquid's: gap {gap[0]}")
    check(np.isfinite(out["liquid_fraction_series"]).all(),
          f"[coexist] {tag}: non-finite liquid fractions")


def phase_coexist(name):
    """coexist_run: LJ at its defaults (16x8x8 = 4096 atoms, 13 T x 3
    rows, prep at 8x8x8, relax 3, up to 40 chunks with the early stop),
    then EAM Al at full width cut to --relax 1 --chunks 4."""
    tmp = tempfile.mkdtemp(prefix="nm_cx_")
    for tag, argv, keys in (
            ("LJ", [], ("sweep", "total")),
            ("AL", ["--element", "AL", "--relax", "1", "--chunks", "4"],
             ("eam_sweep", "eam_total"))):
        CK.reset_launches()
        CE.reset_launches()
        t = time.perf_counter()
        with watch_sampling() as calls:
            out = COEXIST_RUN.main(argv + ["--out", os.path.join(
                tmp, f"{tag}.json")])
        launches = launches_of(keys)
        for k, v in launches.items():
            KERNELS[k]["launches_coexist"] = v
        r = out["result"]
        log(f"[coexist] {tag}: {out['natoms']} atoms, {out['ntemp']} T x 3 "
            f"rows, {out['relax_chunks']} relax + {out['measured_chunks']} "
            f"measured chunks of {out['sweeps_per_chunk']} sweeps; bracket "
            f"{out['tm_bracket']} consistent {r['consistent']}, frozen "
            f"{r['frozen_temps']}, melted {r['melted_temps']}, unresolved "
            f"{r['unresolved_temps']}; tail liquid fraction "
            f"{np.round(r['liquid_fraction'], 3).tolist()}; prep "
            f"{out['prep_seconds']} s, build {out['build_seconds']} s, "
            f"sample {out['sample_seconds']} s, total {out['total_seconds']}"
            f" s ({time.perf_counter() - t:.1f} s in all); launches "
            f"{launches} on {name}")
        coexist_gates(tag, calls, out)
        check(all(v > 0 for v in launches.values()),
              f"[coexist] {tag}: a kernel never launched: {launches}")


def phase_sweep(name):
    """bench.melting_sweep at full size (config 3: 256 Al atoms, 10 T,
    30 records of 15 sweeps)."""
    CE.reset_launches()
    row = BENCH.melting_sweep(DEV)
    launches = launches_of(("eam_sweep", "eam_total"))
    for k, v in launches.items():
        KERNELS[k]["launches_sweep"] = v
    log(f"[sweep] {row['sweep_points_per_hour']:.1f} (P,T)-points/hour, "
        f"{row['sweep_seconds']} s for {row['sweep_points']} points; T_m "
        f"{row['sweep_tm_K']:.1f} K (the JAX gather engine's "
        f"{row['sweep_tm_gather_engine_K']} K); diag {row['sweep_diag']}; "
        f"P(liquid) {row['sweep_probs']}; launches {launches} on {name}")
    check(row["sweep_diag"] == 0, f"[sweep] diag {row['sweep_diag']}")
    check(math.isfinite(row["sweep_tm_K"]), "[sweep] non-finite T_m")
    check(all(v > 0 for v in launches.values()),
          f"[sweep] a kernel never launched: {launches}")


def config3(seed):
    """docs/VALIDATION.md config 3, the heating leg as scripts/eam_tm_ab.py
    pins it, with the chain seed given."""
    return RunConfig(name="eamval", element="AL", ncells=(4, 4, 4),
                     npress=1, ntemp=10, press=(1.0,),
                     temp=tuple(float(t) for t in np.linspace(400.0, 2200.0,
                                                              10)),
                     nsmpl=40, mod=20, ncut=15, dpos0=0.1, dvol0=0.01,
                     seed=seed)


def slot_batches(res, ncut, nbatch, natoms):
    """Per temperature slot, batch means (nbatch, ntemp) of pe/N, V and
    the virial pressure (N kB T + W/3)/V over the records after the
    burn-in, as scripts/eam_config3_reference.py takes them."""
    rec = res.records
    order = torch.argsort(rec.temp, dim=1)

    def take(v):
        return torch.gather(v, 1, order)[ncut:].double().cpu().numpy()

    temp, vol = take(rec.temp), take(rec.vol)
    vals = {"pe_per_atom_eV": take(rec.pe) / natoms, "vol_A3": vol,
            "pvir_eV_per_A3": (natoms * KB_EV * temp + take(rec.virial) / 3.0)
            / vol}
    return {k: np.stack([c.mean(0) for c in np.array_split(v, nbatch)])
            for k, v in vals.items()}


def classifier_tm(g_slot, temp, seeds):
    """Mean T_m over the port's classifier trained on these features from
    each initial-weight seed (the pipeline's recipe: tanh scaler, CNN,
    extreme-T labels, 400 epochs)."""
    x = get_scaler("tanh").fit_transform(
        torch.as_tensor(np.asarray(g_slot), dtype=torch.float32, device=DEV))
    mask, labels = extreme_t_labels(len(temp), 1, device=DEV)
    out = []
    for seed in seeds:
        net = PhaseCNN(x.shape[1]).to(DEV)
        init_params(net, torch.Generator().manual_seed(seed))
        fit = train_classifier(net, x, mask, labels, epochs=400, lr=2e-3)
        tm, _ = melting_curve(temp, fit.probs.cpu().numpy().reshape(1, -1))
        out.append(float(tm[0]))
    return float(np.mean(out))


def phase_eam_physics(name, table):
    """docs/VALIDATION.md config 3 against the JAX gather engine's chains
    of it (eam_config3_gather.json, from scripts/eam_config3_reference.py:
    the same seeds, on the CPU), through melting_pipeline on both
    engines: cellmc (tag eam-physics) and the default, gather (tag
    eam-gather-physics, like for like with the reference). The 16 chains
    run in spawned processes (``physics_chains``) while this process
    trains the classifiers: on the JAX chains' features first, once for
    both engines' gates, then on each chain's as it comes
    (``eam_gates``)."""
    with open(REFERENCE) as f:
        ref = json.load(f)
    seeds = ref["chain_seeds"]
    temp = np.asarray(ref["temp_K"], np.float32)
    t = time.perf_counter()
    tm_p = {}

    def train(key, outcome):
        tm_p[key] = classifier_tm(outcome[0].g_slot, temp, CLF_SEEDS)

    chains, tm_j = physics_chains(
        "eam-physics",
        [(f"{engine} {s}", config3(s),
          dict(setfl=table, engine=engine, nbins=ref["nbins"]))
         for engine in ("cellmc", "gather") for s in seeds],
        meanwhile=lambda: np.array([classifier_tm(c["g_slot"], temp,
                                                  CLF_SEEDS)
                                    for c in ref["chains"]]),
        on_result=train)
    for engine in ("cellmc", "gather"):
        keys = [f"{engine} {s}" for s in seeds]
        eam_gates(name, ref, engine, {s: chains[k] for s, k in
                                      zip(seeds, keys)},
                  np.array([tm_p[k] for k in keys]), tm_j, t)


def eam_gates(name, ref, engine, chains, tm_p, tm_j, t):
    """The gates of one engine's config-3 chains (``chains`` by seed:
    melting_pipeline's result, ENS.COUNTS, seconds; ``tm_p`` and
    ``tm_j`` the classifiers' T_m on them and on the JAX chains), with
    nothing melting in this protocol, so that T_m of one chain and one
    classifier is mostly the classifier's initial weights (PERF.md):
    - every chain diag 0 with T_m inside the grid;
    - sampling, no classifier: per slot, pe/N, V and the virial pressure
      pooled over the chains within Z_PHYS standard errors of the JAX
      chains' (batch means of 5 x 5 records per chain on both sides);
    - T_m, one classifier: the port's classifier, trained from seeds 0-3
      on each chain's features, gives the same mean T_m on the port's
      chains as on the JAX chains (``tm_j``) within Z_PHYS standard
      errors (from the chain-to-chain spread, pooled over both sides).
    On gather it also prints each chain's seconds, ms a sweep, rebuilds
    and host syncs."""
    tag = "eam-physics" if engine == "cellmc" else "eam-gather-physics"
    seeds = ref["chain_seeds"]
    temp = np.asarray(ref["temp_K"], np.float32)
    runs = [chains[s][0] for s in seeds]
    for s in seeds:
        res, c, secs = chains[s]
        if engine == "gather":
            log(f"[{tag}] chain {s}: {secs:.1f} s "
                f"(sampling {res.seconds['sampling']:.1f} s, "
                f"{1e3 * res.seconds['sampling'] / c['sweeps']:.2f} ms a "
                f"sweep over {c['sweeps']} sweeps), {c['rebuilds']} "
                f"rebuilds, {c['syncs']} host syncs, {c['passes']} passes, "
                f"{c['replays']} graph replays")
    for s, res in zip(seeds, runs):
        check(res.diag == 0 and math.isfinite(float(res.tm[0]))
              and temp[0] <= float(res.tm[0]) <= temp[-1],
              f"[{tag}] chain {s}: diag {res.diag}, T_m {res.tm}")
    batches = [slot_batches(res, config3(0).ncut, ref["batches_per_chain"],
                            ref["natoms"]) for res in runs]
    worst = 0.0
    for key in ("pe_per_atom_eV", "vol_A3", "pvir_eV_per_A3"):
        b = np.concatenate([bt[key] for bt in batches])
        m, se = b.mean(0), b.std(0, ddof=1) / math.sqrt(len(b))
        rm, rse = np.asarray(ref[key]), np.asarray(ref[key + "_se"])
        z = (m - rm) / np.sqrt(se ** 2 + rse ** 2)
        worst = max(worst, float(np.abs(z).max()))
        log(f"[{tag}] {key} by slot, port {m.tolist()} (se "
            f"{se.tolist()}); JAX gather {rm.tolist()}; z "
            f"{np.round(z, 2).tolist()}")
    log(f"[{tag}] sampling: max |z| {worst:.2f} over 3 x "
        f"{len(temp)} slots, {len(seeds)} chains a side (limit {Z_PHYS})")
    check(worst < Z_PHYS, f"[{tag}] sampling differs from the JAX "
          f"gather chains: max |z| {worst:.2f}")
    spread = math.sqrt((tm_p.var(ddof=1) + tm_j.var(ddof=1)) / 2.0)
    se = spread * math.sqrt(2.0 / len(seeds))
    diff = float(tm_p.mean() - tm_j.mean())
    dt = time.perf_counter() - t
    log(f"[{tag}] T_m, the port's classifier (seeds "
        f"{list(CLF_SEEDS)}) by chain: on the port's chains "
        f"{np.round(tm_p, 1).tolist()}, mean {tm_p.mean():.1f} K; on the "
        f"JAX chains {np.round(tm_j, 1).tolist()}, mean {tm_j.mean():.1f} "
        f"K; difference {diff:.1f} K, z {diff / se:.2f} (limit {Z_PHYS})")
    tm_pipe = [round(float(res.tm[0]), 1) for res in runs]
    tm_jax = [c["tm_K"] for c in ref["chains"]]
    log(f"[{tag}] the pipeline's T_m by chain (classifier seed 0): "
        f"port {tm_pipe}, JAX gather {np.round(tm_jax, 1).tolist()}; chain "
        f"{seeds[0]}: port {tm_pipe[0]} K against the JAX cellmc leg's "
        f"1766.3 K (eam_tm_ab.json clong): {abs(tm_pipe[0] / 1766.3 - 1):.4f};"
        f" {dt:.1f} s since the chains started on {name}")
    check(abs(diff) < Z_PHYS * se, f"[{tag}] T_m on the port's chains "
          f"differs from T_m on the JAX chains: {diff:.1f} K, se {se:.1f}")


# ---------------------------------------------------------------------------
# serial path (B5) and the probe (P1)
# ---------------------------------------------------------------------------

def b5_case(r, ncells, m, seed, lattice=1.6, jitter=0.04, step=0.15):
    """R jittered fcc replicas, M distinct movers each, displaced by up to
    +-step per axis: (pos, box, ids, old_r, new_r) on the card."""
    pos, box = make_supercell("fcc", lattice, ncells)
    n = pos.shape[0]
    g = np.random.default_rng(seed)
    pos = np.stack([(pos + jitter * g.standard_normal(pos.shape)) % box
                    for _ in range(r)]).astype(np.float32)
    ids = np.stack([g.choice(n, m, replace=False) for _ in range(r)])
    old = np.take_along_axis(pos, ids[..., None], axis=1)
    new = (old + g.uniform(-step, step, old.shape)).astype(np.float32)
    boxes = np.repeat(np.asarray(box, np.float32)[None], r, 0)
    return tuple(torch.as_tensor(x, device=DEV) for x in
                 (pos, boxes, ids.astype(np.int32), old, new))


def b5_terms(pot, case):
    """Per mover, the summed magnitudes of its e and w terms (both sides),
    and the number of (mover, atom, side) terms inside rc."""
    pos, box, ids, old, new = case
    _, rc2, _, _ = pot.f32_consts()
    col = torch.arange(pos.shape[1], device=DEV)
    notself = col[None, None, :] != ids[:, :, None]
    se = sw = 0.0
    n_in = 0
    for r in (old, new):
        d = min_image(r[:, :, None, :] - pos[:, None, :, :],
                      box[:, None, None, :])
        r2 = (d * d).sum(-1)
        ok = notself & (r2 < rc2)
        e, w = pot.pair_e_w(torch.clamp(r2, min=LD.R2_FLOOR))
        se = se + torch.where(ok, e.abs(), 0.0).sum(-1)
        sw = sw + torch.where(ok, w.abs(), 0.0).sum(-1)
        n_in += int(ok.sum())
    return se, sw, n_in


def compare_b5(pot, case, tag):
    pos, _, ids, _, _ = case
    (r, n, _), m = pos.shape, ids.shape[1]
    dek, dwk = LD.delta_moves(pot, *case)
    dep, dwp = LD.delta_moves_plain(pot, *case)
    torch.cuda.synchronize()
    se, sw, n_in = b5_terms(pot, case)
    for nm, k, p, mag in (("dE", dek, dep, se), ("dW", dwk, dwp, sw)):
        err = (k - p).abs()
        worst = float((err / mag.clamp(min=1e-30)).max())
        log(f"[{tag}] B5 R={r} N={n} M={m} {nm}: max |k - p| "
            f"{float(err.max()):.3e}, max |k - p| / sum|terms| {worst:.3e} "
            f"(limit {B5_RTOL:g}); |{nm}| up to {float(p.abs().max()):.3e}")
        check(bool((err <= B5_RTOL * mag + 1e-6).all()),
              f"[{tag}] B5 {nm} disagrees with its plain version")
        check(bool(torch.isfinite(k).all()), f"[{tag}] B5 {nm} not finite")
    ERR["delta_batched"] = max(ERR["delta_batched"],
                               float((dek - dep).abs().max()))
    return n_in


def b5_bound(r, n, m, n_in):
    nbytes = 4 * (r * n * 3 + r * 3 + r * m + 2 * r * m * 3 + 2 * r * m)
    return bound(nbytes, 2 * r * m * (n - 1) * OPS_B5_PAIR + n_in * OPS_B5_IN)


def phase_serial_small():
    pot = LJCut.create()
    for r, ncells, m, seed in ((1, 4, 4, 0), (2, 3, 2, 1)):
        compare_b5(pot, b5_case(r, ncells, m, seed), "serial-small")


def phase_serial_full(name):
    pot = LJCut.create()
    lat = 2.0 ** (2.0 / 3.0)
    # the serial engine's own launch: one mover of config 1's crystal
    case = b5_case(1, 4, 1, 2, lattice=lat, jitter=0.03, step=0.1)
    n_in = compare_b5(pot, case, "serial-full")
    # a launch this small takes less time on the card than the host needs
    # to issue it: the kernel's own time comes from torch.profiler, the
    # CUDA-event time per call back to back is the issue rate
    ms1 = P1.device_ms(lambda: LD.delta_moves(pot, *case), 200, "delta_")
    ev1 = cuda_ms(lambda: LD.delta_moves(pot, *case), 200)
    pms1 = cuda_ms(lambda: LD.delta_moves_plain(pot, *case), 50)
    b1, by1 = b5_bound(1, 256, 1, n_in)
    # batched: BASELINE config 2's 8x8 grid of 4096-atom LJ, 32 movers each
    big = b5_case(64, (16, 8, 8), 32, 3, lattice=lat, jitter=0.03, step=0.1)
    n_in_big = compare_b5(pot, big, "serial-full")
    ms = P1.device_ms(lambda: LD.delta_moves(pot, *big), 20, "delta_")
    ev = cuda_ms(lambda: LD.delta_moves(pot, *big), 20)
    pms = cuda_ms(lambda: LD.delta_moves_plain(pot, *big), 3)
    bms, by = b5_bound(64, 4096, 32, n_in_big)
    TIMES["delta_batched"] = (ms, pms)
    BOUND["delta_batched"] = (bms, by)
    log(f"[serial-full] B5 R=1 N=256 M=1: kernel {ms1:.4f} ms on the "
        f"device ({ev1:.4f} ms per call as issued), plain {pms1:.4f} ms, "
        f"bound {b1:.6f} ms ({by1}); R=64 "
        f"N=4096 M=32: kernel {ms:.4f} ms on the device ({ev:.4f} as "
        f"issued), plain {pms:.4f} ms, bound {bms:.6f} ms ({by}), "
        f"{n_in_big} terms inside rc (after warm-up) on {name}")


def recording_backend(runs):
    """brute_backend() whose position_run also keeps each run's draws
    (ids, disp, ln u, nbeta), as the sweep hands them over."""
    be = moves.brute_backend()

    def position_run(pot, pos, box, ids, disp, ln_u, nbeta, pe, virial):
        runs.append(tuple(t.clone() for t in (ids, disp, ln_u, nbeta)))
        return be.position_run(pot, pos, box, ids, disp, ln_u, nbeta, pe,
                               virial)

    return moves.EnergyBackend(be.total, be.delta_move, be.forces,
                               position_run)


def chain_of(pos, box, pe, virial):
    """A copy of one chain's state, as moves.position takes it."""
    return SimpleNamespace(pos=pos.clone(), box=box.clone(), pe=pe.clone(),
                           virial=virial.clone())


def apply_runs(pot, chain, runs, per_attempt=False, run=LD.position_run):
    """Apply the runs to ``chain`` in order: one ``run`` call each, or
    (per_attempt) one moves.position call, one batched B5 launch, an
    attempt. Returns (acc, weight), each over all attempts, and when
    per_attempt, per attempt b5_terms' (summed |e|, summed |w|, terms
    inside rc)."""
    be = moves.brute_backend()
    acc, wgt, terms = [], [], []
    for ids, disp, lnu, nbeta in runs:
        if not per_attempt:
            ok, w = run(pot, chain.pos, chain.box, ids, disp, lnu, nbeta,
                        chain.pe, chain.virial)
            acc.append(ok)
            wgt.append(w)
            continue
        for k, i in enumerate(ids.tolist()):
            old = chain.pos[i].reshape(1, 1, 3)
            case = (chain.pos[None], chain.box[None], ids[k].reshape(1, 1),
                    old, old + disp[k])
            se, sw, k_in = b5_terms(pot, case)
            terms.append((float(se), float(sw), k_in))
            ok, w = moves.position(pot, be, chain, nbeta, i, ids[k],
                                   disp[k], lnu[k])
            acc.append(ok.reshape(1))
            wgt.append(w.reshape(1))
    return torch.cat(acc), torch.cat(wgt), terms


def run_bound(n, nacc, n_in):
    """Least ms of a run of len(n_in) attempts at N atoms: each attempt's
    B5 operations, the run's bytes (pos, box, 20 B of draws an attempt,
    nbeta, pe, virial in; acc and weight, pe, virial and the accepted
    positions out)."""
    a = len(n_in)
    nbytes = 12 * n + 12 + 20 * a + 12 + 5 * a + 8 + 12 * nacc
    return bound(nbytes, sum(2 * (n - 1) * OPS_B5_PAIR + k * OPS_B5_IN
                             for k in n_in))


def same_bits(x, y):
    if x.dtype == torch.float32:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))
    return torch.equal(x, y)


def compare_runs(pot, start, runs, tag):
    """Hold position_run to the per-attempt path from one start state, bit
    for bit, and to position_run_plain on the CPU (``hold_to_plain``);
    returns (acc, the per-attempt path's b5_terms)."""
    ka = chain_of(*start)
    LD.reset_launches()
    acc_k, w_k, _ = apply_runs(pot, ka, runs)
    nrun = LD.LAUNCHES["delta"]
    natt = LD.LAUNCHES["delta_attempts"]
    kb = chain_of(*start)
    LD.reset_launches()
    acc_b, w_b, terms = apply_runs(pot, kb, runs, per_attempt=True)
    torch.cuda.synchronize()
    check(nrun == len(runs) and natt == len(acc_b)
          and LD.LAUNCHES["delta"] == len(acc_b),
          f"[{tag}] {nrun} launches, {natt} attempts for {len(runs)} runs "
          f"of {len(acc_b)} attempts; {LD.LAUNCHES['delta']} per-attempt "
          f"launches")
    for nm, x, y in (("acc", acc_k, acc_b), ("weight", w_k, w_b),
                     ("pos", ka.pos, kb.pos), ("pe", ka.pe, kb.pe),
                     ("virial", ka.virial, kb.virial)):
        check(same_bits(x, y), f"[{tag}] position_run's {nm} differs from "
              f"the per-attempt B5 launches")
    log(f"[{tag}] {len(runs)} runs of {len(acc_b)} attempts "
        f"({int(acc_k.sum())} accepted) at N={start[0].shape[0]}: pos, pe, "
        f"virial, acc and weight bit for bit equal to {len(acc_b)} "
        f"per-attempt B5 launches")
    hold_to_plain(pot, start, runs, (ka, acc_k, w_k), terms, tag)
    return ka, acc_k, w_k, terms


def hold_to_plain(pot, start, runs, got, terms, tag):
    """Hold the run kernel's result ``got`` (chain, acc, weight) to
    position_run_plain on the CPU from the same start. Decisions equal up
    to a rounding tie (margin < 1e-4). Up to the first decision that
    differs, every weight within |nbeta| (B5_RTOL x the attempt's summed
    |e| terms + 1e-6) + 2^-22 |weight|: dE to B5's tolerance, then each
    side's rounding of the product. With no decision differing, pe and
    virial within the sum over accepted attempts of B5_RTOL x summed
    |terms| + 1e-6, plus 2^-23 (|pe| + those magnitudes) an accepted
    attempt (each side's rounding of an add, at most 2^-24 of the sum), and
    the positions within 1e-5. The largest error goes to ERR["delta"]."""
    chain, acc_k, w_k = got
    kc = chain_of(*(t.cpu() for t in start))
    acc_c, w_c = apply_runs(pot, kc, [tuple(t.cpu() for t in r)
                                      for r in runs])[:2]
    acc_k, w_k = acc_k.cpu(), w_k.cpu()
    nb = torch.cat([r[3].cpu().abs().expand(len(r[0])) for r in runs])
    se, sw = (torch.tensor([t[j] for t in terms], dtype=torch.float64)
              for j in (0, 1))
    diff = torch.nonzero(acc_c != acc_k).reshape(-1)
    upto = int(diff[0]) + 1 if len(diff) else len(acc_c)
    if len(diff):
        a = int(diff[0])
        lnu = torch.cat([r[2].cpu() for r in runs])
        mk = float((lnu[a] - w_k[a]).abs())
        check(mk < 1e-4, f"[{tag}] decision {a} differs from "
              f"position_run_plain's at margin {mk:.3e} (not a rounding tie)")
        log(f"[{tag}] first decision that differs from position_run_plain "
            f"on the CPU: attempt {a}, margin {mk:.3e}; weights held up to "
            f"it, pe, virial and positions not held")
    dw = (w_k[:upto].double() - w_c[:upto].double()).abs()
    lim = nb[:upto] * (B5_RTOL * se[:upto] + 1e-6) \
        + 2.0 ** -22 * w_c[:upto].double().abs()
    check(bool((dw <= lim).all()), f"[{tag}] weight differs from "
          f"position_run_plain's by up to {float(dw.max()):.3e}")
    errs = {"weight": float(dw.max())}
    msg = f"weight {errs['weight']:.3e} (limit {float(lim.min()):.3e}-" \
        f"{float(lim.max()):.3e})"
    if not len(diff):
        ok = acc_c.double()
        for nm, mag in (("pe", se), ("virial", sw)):
            k, p = getattr(chain, nm).double().cpu(), getattr(kc, nm).double()
            errs[nm] = float((k - p).abs())
            lim_s = float((ok * (B5_RTOL * mag + 1e-6)).sum()) \
                + int(acc_c.sum()) * 2.0 ** -23 * (float(p.abs())
                                                   + float((ok * mag).sum()))
            check(errs[nm] <= lim_s, f"[{tag}] {nm} differs from "
                  f"position_run_plain's by {errs[nm]:.3e} (limit "
                  f"{lim_s:.3e})")
            msg += f", {nm} {errs[nm]:.3e} (limit {lim_s:.3e})"
        errs["pos"] = float((chain.pos.cpu() - kc.pos).abs().max())
        check(errs["pos"] <= 1e-5, f"[{tag}] positions differ from "
              f"position_run_plain's by {errs['pos']:.3e}")
        msg += f", pos {errs['pos']:.3e} (limit 1e-5)"
    ERR["delta"] = max(ERR["delta"], *errs.values())
    log(f"[{tag}] against position_run_plain on the CPU, {upto} attempts "
        f"of {len(acc_c)} held: max |kernel - plain| {msg}")


def phase_serial_run(name):
    pot, state, sweep = GOLD.setup_chain(DEV)
    start = (state.pos, state.box, state.pe, state.virial)
    runs = []
    serial.make_sweep_fn(1.0, 1.0, recording_backend(runs), 0.96875,
                         0.03125, 16, 1.0)(pot, GOLD.setup_chain(DEV)[1])
    _, acc_k, _, terms = compare_runs(pot, start, runs, "serial-run")
    n_in = [t[2] for t in terms]
    # batched B5 is off the main path: its launches are the per-attempt
    # path's, one an attempt
    KERNELS["delta_batched"]["launches"] = len(n_in)
    # times: the sweep's runs replayed on a copy, per launch and attempt
    work = chain_of(*start)
    replay = lambda: apply_runs(pot, work, runs)          # noqa: E731
    dev_ms = P1.device_ms(replay, 20, "delta_run")        # per launch
    ev_ms = cuda_ms(replay, 20)                           # per replay
    plain = chain_of(*start)
    pms = cuda_ms(lambda: apply_runs(pot, plain, runs,
                                     run=LD.position_run_plain), 2)
    npos = len(n_in)
    bms, by = run_bound(256, int(acc_k.sum()), n_in)
    TIMES["delta"] = (dev_ms, pms / len(runs))
    BOUND["delta"] = (bms / len(runs), by)
    log(f"[serial-run] config 1's {len(runs)} runs ({npos} attempts): "
        f"{dev_ms:.4f} ms a launch on the device, "
        f"{dev_ms * len(runs) / npos * 1e3:.3f} us an attempt; "
        f"{ev_ms:.4f} ms the runs as issued; plain {pms:.3f} ms; bound "
        f"{bms:.6f} ms ({by}) summed over the runs, "
        f"{100 * bms / (dev_ms * len(runs)):.2f}% of the device time, on "
        f"{name}")
    # a run of 256 attempts at N=4096: 48 KB of shared memory
    lat = 2.0 ** (2.0 / 3.0)
    pos, box, _, _, _ = b5_case(1, (16, 8, 8), 1, 4, lattice=lat,
                                jitter=0.03)
    pos, box = pos[0].contiguous(), box[0].contiguous()
    pe, vir = pair_energy_virial(pot, pos, box)
    g = np.random.default_rng(5)
    big = [(torch.as_tensor(g.integers(0, 4096, 256).astype(np.int32),
                            device=DEV),
            torch.as_tensor(g.uniform(-0.12, 0.12, (256, 3))
                            .astype(np.float32), device=DEV),
            torch.as_tensor(np.log(g.uniform(1e-6, 1.0, 256))
                            .astype(np.float32), device=DEV),
            torch.tensor(-1.0 / 0.8, dtype=torch.float32, device=DEV))]
    _, acc_b, _, terms_b = compare_runs(pot, (pos, box, pe, vir), big,
                                        "serial-run")
    work = chain_of(pos, box, pe, vir)
    ms_b = P1.device_ms(lambda: apply_runs(pot, work, big), 5, "delta_run")
    bms_b, by_b = run_bound(4096, int(acc_b.sum()),
                            [t[2] for t in terms_b])
    log(f"[serial-run] N=4096, 256 attempts ({12 * 4096} B of shared "
        f"memory): {ms_b:.4f} ms a launch on the device, "
        f"{ms_b / 256 * 1e3:.3f} us an attempt, bound {bms_b:.6f} ms "
        f"({by_b}) on {name}")


def golden_records(recs, frames, nrec, tag):
    """Hold the first nrec records and frames to tests/golden/config1.*."""
    _, want = thermo.read(os.path.join(GOLDEN, "config1.thrm"))
    gpos, gbox, gsweep = traj.read(os.path.join(GOLDEN, "config1.traj"))
    got = {c: getattr(recs, c)[:nrec].cpu().numpy() for c in thermo.COLUMNS}
    for c in ("sweep", "acc_pos", "acc_vol", "dpos", "dvol"):
        w = want[c][:nrec].astype(got[c].dtype)
        check(np.array_equal(got[c], w),
              f"[{tag}] {c} differs from the golden file: {got[c]} vs {w}")
    worst = {}
    for c, rtol, atol in (("pe", 2e-4, 5e-3), ("virial", 2e-4, 5e-3),
                          ("vol", 1e-5, 0.0)):
        d = np.abs(got[c].astype(np.float64) - want[c][:nrec])
        worst[c] = float((d / np.abs(want[c][:nrec])).max())
        check(bool((d <= atol + rtol * np.abs(want[c][:nrec])).all()),
              f"[{tag}] {c} differs from the golden file: {got[c]} vs "
              f"{want[c][:nrec]}")
    dx = float(np.abs(frames[0][:nrec].cpu().numpy() - gpos[:nrec]).max())
    db = float(np.abs(frames[1][:nrec].cpu().numpy() - gbox[:nrec]).max())
    check(max(dx, db) <= 5e-4, f"[{tag}] frames differ: |dx| {dx}, |dbox| "
          f"{db}")
    log(f"[{tag}] records 1-{nrec}: sweep, acc_pos, acc_vol, dpos, dvol "
        f"equal to tests/golden/config1.thrm; max rel err pe "
        f"{worst['pe']:.2e}, virial {worst['virial']:.2e} (limit 2e-4 + "
        f"5e-3 abs), vol {worst['vol']:.2e} (limit 1e-5); frames |dx| "
        f"{dx:.2e}, |dbox| {db:.2e} (limit 5e-4)")


def first_divergence(tr_a, tr_b):
    """(sweep, attempt, margin a, margin b, move type) of the first decision
    that differs between two traced chains of the same key, or None."""
    for s, ((ta, aa, ma), (tb, ab, mb)) in enumerate(zip(tr_a, tr_b)):
        check(torch.equal(ta, tb), f"move types differ in sweep {s}")
        diff = torch.nonzero(aa.cpu() != ab.cpu()).reshape(-1)
        if len(diff):
            a = int(diff[0])
            return s, a, float(ma[a]), float(mb[a]), int(ta[a])
    return None


def phase_golden(name):
    n = 256
    LD.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, recs, frames = GOLD.run_chain()          # the default device
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = LD.LAUNCHES["delta"]
    attempts = LD.LAUNCHES["delta_attempts"]
    KERNELS["delta"]["launches"] = launches
    check(recs.pe.device.type == "cuda", "[golden] did not run on the card")
    # every decision against the port's CPU run (tier-1 holds that run to
    # the JAX chain); a traced chain computes each attempt's margin
    tr_k, tr_c = [], []
    _, recs_k, frames_k = GOLD.run_chain(DEV, trace=tr_k)
    GOLD.run_chain("cpu", trace=tr_c)
    nsw = len(tr_k)
    npos = sum(int((mt == 0).sum()) for mt, _, _ in tr_k)
    nruns = sum(t == serial.POS for mt, _, _ in tr_k
                for t, _, _ in serial.attempt_runs(mt.tolist()))
    margin = min(float(m.abs().min()) for _, _, m in tr_k)
    log(f"[golden] config 1: {nsw} sweeps of {n} attempts in {secs:.3f} s, "
        f"{secs / nsw * 1e3:.2f} ms per sweep (106.01 with one B5 launch "
        f"an attempt), {nsw * n / secs:.4e} attempted moves/s on "
        f"{name}; B5 launches {launches} for {nruns} runs of position "
        f"attempts, attempts through the run kernel {attempts} for {npos} "
        f"position attempts; smallest decision margin |ln u - ln w| "
        f"{margin:.3e}")
    check(launches == nruns, f"[golden] B5 launched {launches} times for "
          f"{nruns} runs of position attempts")
    check(attempts == npos, f"[golden] {attempts} attempts went through "
          f"the run kernel for {npos} position attempts")
    check(torch.equal(recs.acc_pos, recs_k.acc_pos)
          and torch.equal(recs.acc_vol, recs_k.acc_vol),
          "[golden] the traced run made other decisions")
    nrec = 4
    div = first_divergence(tr_k, tr_c)
    if div is None:
        log("[golden] every decision equals the port's CPU run")
    else:
        s, a, mk, mc, mt = div
        log(f"[golden] first decision that differs from the port's CPU run: "
            f"sweep {s}, attempt {a} (move type {mt}), margin |ln u + "
            f"beta dE| {abs(mk):.3e} on the card, {abs(mc):.3e} on the CPU")
        check(abs(mk) < 1e-4, f"[golden] decision differs at margin "
              f"{abs(mk):.3e} (not a rounding tie)")
        nrec = s // 4                   # config 1: 4 sweeps a record
        log(f"[golden] a rounding tie between two f32 summation orders: "
            f"holding the {nrec} records before sweep {s}")
    if nrec:
        golden_records(recs, frames, nrec, "golden")
    golden_cpu_ref(name)
    profile_sweep(name)


def golden_cpu_ref(name):
    """tests/test_golden.py's cold case (32 atoms, T* 0.5, P* 1, seed 11,
    2 records of 3 sweeps) on the card against the port's loop-based CPU
    reference (refimpl/cpu_ref.py): every attempt's move type and
    decision equal; positions, box and pe within that test's
    tolerances."""
    kw = dict(ncells=2, seed=11, temp=0.5, press=1.0, dpos0=0.1,
              dvol_frac0=0.01, dt0=0.005, nstps=4, mass=1.0)
    tr_k, tr_r = [], []
    st, recs, _ = GOLD.run_chain(DEV, mod=3, nrecords=2, trace=tr_k, **kw)
    pos, box = make_supercell("fcc", 2.0 ** (2 / 3), 2)
    ref = CPU_REF.init_ref_state(pos, box, J.key(11), 0.5, 1.0, dpos0=0.1,
                                 dvol_frac0=0.01, dt0=0.005)
    ref, rrecs = CPU_REF.run_records(ref, 2, 3, 1.0, 1.0, 0.96875, 0.03125,
                                     nstps=4, mass=1.0, trace=tr_r)
    same = all(torch.equal(mt.cpu(), torch.as_tensor(rt))
               and torch.equal(acc.cpu(), torch.as_tensor(ra))
               for (mt, acc, _), (rt, ra) in zip(tr_k, tr_r))
    dx = float(np.abs(st.pos.cpu().numpy() - ref.pos).max())
    dbox = float(np.abs(st.box.cpu().numpy() / ref.box - 1.0).max())
    pe_k = recs.pe.cpu().numpy().astype(np.float64)
    pe_r = np.array([r[0] for r in rrecs])
    vol_r = np.array([r[1] for r in rrecs])
    dvol = float(np.abs(recs.vol.cpu().numpy() / vol_r - 1.0).max())
    pe_ok = bool((np.abs(pe_k - pe_r) <= 5e-3 + 2e-4 * np.abs(pe_r)).all()
                 and abs(float(st.pe) - ref.pe) <= 5e-3 + 2e-4
                 * abs(ref.pe))
    log(f"[golden] test_golden's cold case on the card against the port's "
        f"CPU reference (refimpl/cpu_ref.py): {len(tr_k)} sweeps, every "
        f"decision equal {same}; max |dx| {dx:.2e} (limit 5e-4), box rel "
        f"{dbox:.2e} (1e-5), record vol rel {dvol:.2e} (1e-5), record pe "
        f"{pe_k.tolist()} vs {pe_r.tolist()} (rtol 2e-4, atol 5e-3) on "
        f"{name}")
    check(len(tr_k) == len(tr_r) == 6 and same,
          "[golden] a decision differs from the CPU reference")
    check(dx <= 5e-4 and dbox <= 1e-5 and dvol <= 1e-5 and pe_ok,
          "[golden] the card's chain leaves test_golden's tolerances")


def profile_sweep(name):
    """One config-1 sweep on the card under torch.profiler, after one
    warm-up sweep: wall, device busy and idle share, device operations an
    attempt and B5's device time."""
    from torch.profiler import ProfilerActivity, profile
    pot, state, sweep = GOLD.setup_chain(DEV)
    sweep(pot, state)
    torch.cuda.synchronize()
    # a session that records no launch at all (as probe.device_ms meets
    # on the card) is followed by another sweep in a new one, three in all
    for _ in range(3):
        LD.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            sweep(pot, state)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy = kernels = b5 = 0.0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(ev, "self_device_time_total", None)
            t = (ev.self_cuda_time_total if t is None else t) / 1e3
            if t <= 0:
                continue
            busy += t
            kernels += ev.count
            if "delta_" in ev.key:
                b5 += t
        if busy > 0:
            break
        log("[golden] the profiler saw no device time in a sweep's session")
    nruns, npos = LD.LAUNCHES["delta"], LD.LAUNCHES["delta_attempts"]
    n = state.pos.shape[0]
    check(busy > 0, "[golden] the profiler saw no device time")
    # config 1 has no HMC: every other attempt is a volume trial
    log(f"[golden] one sweep under torch.profiler ({nruns} runs of position "
        f"attempts, {n - npos} volume trials): wall {wall:.3f} ms, device "
        f"busy {busy:.3f} ms (B5 {b5:.3f} ms), idle share "
        f"{1.0 - busy / wall:.4f} (0.9605 with one B5 launch an attempt), "
        f"{kernels / n:.2f} device operations per attempt (20.7) on {name}")


def phase_golden_hmc(name):
    kw = dict(ncells=2, seed=9, temp=0.8, press=1.0, dpos0=0.1,
              dvol_frac0=0.01, dt0=0.005, ppos=0.7, pvol=0.05, nstps=4,
              mass=1.0, mod=1, nrecords=2)
    tr_k = []
    sk, rk, _ = GOLD.run_chain(DEV, trace=tr_k, **kw)
    sc, rc, _ = GOLD.run_chain("cpu", **kw)
    nh = sum(int((mt == 2).sum()) for mt, _, _ in tr_k)
    dx = float((sk.pos.cpu() - sc.pos).abs().max())
    log(f"[golden-hmc] 32 atoms, 2 sweeps, {nh} HMC trials: acc_pos "
        f"{rk.acc_pos.tolist()} / {rc.acc_pos.tolist()}, acc_vol "
        f"{rk.acc_vol.tolist()} / {rc.acc_vol.tolist()}, acc_hmc "
        f"{rk.acc_hmc.tolist()} / {rc.acc_hmc.tolist()} (card / CPU); max "
        f"|dx| {dx:.3e} (limit 1e-2) on {name}")
    check(nh > 0, "[golden-hmc] no HMC trial")
    for c in ("acc_pos", "acc_vol", "acc_hmc"):
        check(torch.equal(getattr(rk, c).cpu(), getattr(rc, c)),
              f"[golden-hmc] {c} differs between the card and the CPU")
    check(dx <= 1e-2, f"[golden-hmc] positions differ by {dx}")


# ---------------------------------------------------------------------------
# multi-process: the cellmc engines per replica shard (parallel/mesh.py,
# parallel/cellmc_sharded.py) and the gather engine over the process group
# (parallel/ensemble.py), two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

SHARD_RANKS = 2
SHARD_TIMEOUT = 600         # seconds for both ranks, set-up included


def brute_pe(style, pot, pos, box):
    """O(N^2) minimum-image total energy of one configuration: LJ through
    ops/energy.py; EAM from the setfl splines the gather engine samples
    (``models.eam.EAMTables``) or from the Chebyshev series the kernels
    sample."""
    if style == "pair":
        return float(pair_energy_virial(pot, pos, box)[0])
    d = min_image(pos[None, :, :] - pos[:, None, :], box)
    u = (d * d).sum(-1)
    n = pos.shape[0]
    rc = float(np.float32(float(pot.rc)))
    mask = (u < rc * rc) & ~torch.eye(n, dtype=torch.bool, device=pos.device)
    if isinstance(pot, eam_mod.EAMTables):
        r = torch.sqrt(torch.where(mask, u, 1.0))
        rphi, _ = eam_mod.spline_eval_t(pot.rphi_coef, pot.dr, r)
        rho_r, _ = eam_mod.spline_eval_t(pot.rho_coef, pot.dr, r)
        rho = torch.where(mask, rho_r, 0.0).double().sum(-1)
        f, _ = eam_mod.spline_eval_t(pot.f_coef, pot.drho, rho.float())
        return float(0.5 * torch.where(mask, rphi / r, 0.0).double().sum()
                     + f.double().sum())
    phi = torch.where(mask, eam_cheb.cheb_eval(pot.c_phi, pot.u_lo,
                                               pot.u_hi, u), 0.0)
    rho = torch.where(mask, eam_cheb.cheb_eval(pot.c_rho, pot.u_lo,
                                               pot.u_hi, u), 0.0).sum(-1)
    q = torch.sqrt(torch.clamp(rho, 0.0, float(pot.rho_hi)))
    f = eam_cheb.cheb_eval(pot.c_f, pot.q_lo,
                           np.sqrt(np.float32(pot.rho_hi)), q)
    return float(0.5 * phi.double().sum() + f.double().sum())


def two_chunks(cfg, setfl, dev, checkpoint=None, engine="cellmc"):
    """set-up, one chunk (checkpointed into ``checkpoint`` if given), then
    a timed one with ENS.COUNTS from 0 (the gather engine's, whose chunks
    keep their frames): (setup, outputs of the timed chunk, its seconds,
    its attempted moves, the first chunk's diag)."""
    traj = engine == "gather"       # both chunks: one run function
    setup = runner.setup_run(cfg, setfl=setfl, engine=engine, device=dev)
    setup, *_, d0 = runner.run_sampling(setup, write_files=False,
                                        write_traj=traj,
                                        checkpoint_path=checkpoint)
    m0 = int(setup.moves_tried)
    # the ranks meet first: rank 0's checkpoint write stays out of the
    # other ranks' timed chunk
    mesh.barrier()
    ENS.reset_counts()
    t = runner.timed(setup.device)
    out = runner.run_sampling(setup, write_files=False, write_traj=traj)
    secs = runner.timed(setup.device) - t
    return out[0], out[1:], secs, int(out[0].moves_tried) - m0, d0


def sharded_style(style, rank, dev, table, ckdir):
    """One rank's share of the sharded phase for the bench's LJ or EAM
    configuration: its first B2/B3 sweep and B1/B4 total at its own
    shard-folded seeds against their plain versions, then two chunks of
    run_sampling through the sharded runner, the first checkpointed into
    ``ckdir``, then the second again on a fresh set-up restored from
    that checkpoint."""
    cfg = BENCH.configs()["lj" if style == "pair" else "eam"]
    setfl = table if style == "eam" else None
    tag = f"sharded {style} rank {rank}"
    setup = runner.setup_run(cfg, setfl=setfl, engine="cellmc", device=dev)
    geom, r = setup.geom, setup.t_grid.shape[0]
    rl = setup.states.temp.shape[0]
    check(rl * SHARD_RANKS == r, f"[{tag}] shard of {rl} of {r} replicas")
    params = SC.params_of(setup.states, geom, setup.us.kb)
    # the chunk's first sweep's keys on this shard: seed word + rank
    keys = dict(seed0=(cfg.seed, cfg.seed + 7 + rank),
                sweep=int(setup.states.sweep[0]))
    ncyc = SC.default_ncyc(geom)
    if style == "pair":
        pot3 = setup.pot.pot3(dev)
        compare_total(geom, setup.slabs[:3], params, pot3, tag)
        compare_sweep(geom, setup.slabs[:3], setup.slabs[3],
                      setup.slab_count, params, pot3, SC.pick_rt(rl), tag,
                      exact=False, ncyc=ncyc, **keys)
    else:
        scal, series, _ = CE.eam_pack(setup.pot, dev)
        compare_eam_total(geom, setup.slabs[:3], setup.slabs[3], params,
                          scal, series, tag)
        compare_eam_sweep(geom, setup.slabs[:3], setup.slabs[3],
                          setup.slab_count, params, scal, series,
                          SC.pick_rt(rl), tag, exact=False, ncyc=ncyc,
                          **keys)
    del setup
    CK.reset_launches()
    CE.reset_launches()
    ck = os.path.join(ckdir, f"{style}.ckpt.npz")
    setup, (recs, _, hist, xacc, diag), secs, moves, d0 = two_chunks(
        cfg, setfl, dev, checkpoint=ck)
    launches = {**CK.LAUNCHES, **CE.LAUNCHES}
    check(d0 == 0 and diag == 0, f"[{tag}] diag {d0}, {diag} (16 = "
          "SHIFT_DESYNC)")
    check(tuple(recs.pe.shape) == (cfg.nsmpl, r),
          f"[{tag}] records {tuple(recs.pe.shape)}, not whole")
    for row in hist.cpu().numpy():
        check(sorted(row.tolist()) == list(range(r)),
              f"[{tag}] a hist row is no permutation")
    st = mesh.host_fetch(setup.states, r)            # a collective
    errs = []
    if rank == 0:
        for rr in (0, r - 1):
            want = brute_pe(style, setup.pot, st.pos[rr], st.box[rr])
            got = float(st.pe[rr])
            lim = (0.05 + 5e-4 * abs(want) if style == "pair"
                   else 0.02 + 1e-4 * abs(want))
            errs.append(abs(got - want))
            check(abs(got - want) < lim, f"[{tag}] replica {rr}: record pe "
                  f"{got} against brute force {want} (limit {lim})")
    keep = ("sweep", "total") if style == "pair" else ("eam_sweep",
                                                      "eam_total")
    check(all(launches[k] > 0 for k in keep),
          f"[{tag}] a kernel never launched: {launches}")
    # the restart: a fresh set-up restored from the first chunk's
    # checkpoint runs the timed chunk again, bit for bit
    fresh = runner.setup_run(cfg, setfl=setfl, engine="cellmc", device=dev)
    CK.reset_launches()
    CE.reset_launches()
    t = runner.timed(fresh.device)
    fresh = runner.restore_setup(fresh, ck)
    restore_s = runner.timed(fresh.device) - t
    fresh, rrecs, _, rhist, rxacc, rdiag = runner.run_sampling(
        fresh, write_files=False, write_traj=False)
    rlaunches = {**CK.LAUNCHES, **CE.LAUNCHES}
    check(all(rlaunches[k] > 0 for k in keep),
          f"[{tag}] a kernel never launched after the restart: {rlaunches}")
    check(rdiag == diag, f"[{tag}] resumed diag {rdiag}, timed {diag}")
    for f in dataclasses.fields(recs):
        check(torch.equal(getattr(rrecs, f.name), getattr(recs, f.name)),
              f"[{tag}] the resumed chunk's records differ in {f.name}")
    check(torch.equal(rhist, hist) and torch.equal(rxacc, xacc),
          f"[{tag}] the resumed chunk's hist or xacc differ")
    rst, rslots = mesh.host_fetch((fresh.states, fresh.slot_of), r)
    slots = mesh.host_fetch(setup.slot_of, r)
    for f in ("pos", "box", "pe"):
        check(torch.equal(getattr(rst, f), getattr(st, f)),
              f"[{tag}] the resumed chunk's {f} differ")
    check(torch.equal(rslots, slots),
          f"[{tag}] the resumed chunk's slot_of differ")
    return dict(secs=secs, moves=moves, launches=launches, rl=rl, r=r,
                pe_err=errs, xacc=xacc.tolist(), restore_s=restore_s,
                ck_mb=os.path.getsize(ck) / 1e6, rlaunches=rlaunches)


def sharded_gather_cfgs():
    """The sharded phase's gather configurations, at full width: gather-
    full's LJ one in chunks of 1 record x 2 sweeps, eam-gather-full's EAM
    one in chunks of 1 record x 1 sweep."""
    return {"pair": dataclasses.replace(gather_full_cfg(), nsmpl=1, mod=2),
            "eam": dataclasses.replace(eam_gather_full_cfg(), nsmpl=1,
                                       mod=1)}


def host_chunk(recs, frames, hist, xacc, diag):
    """A chunk's outputs on the host, as ``hold_chunk`` takes them."""
    return (None, host_record(recs), (frames[0].cpu(), frames[1].cpu()),
            hist.cpu(), xacc.cpu(), diag)


def sharded_gather_style(style, rank, dev, table, ckdir):
    """One rank's share of the sharded phase for the gather engine at full
    width (``sharded_gather_cfgs``): two chunks of run_sampling over the
    process group, the first checkpointed into ``ckdir``, then the second
    again on a fresh set-up restored from that checkpoint, bit for bit.
    Rank 0 also returns its timed chunk on the host, for the parent's
    one-process run of it."""
    cfg = sharded_gather_cfgs()[style]
    setfl = table if style == "eam" else None
    tag = f"sharded gather {style} rank {rank}"
    ck = os.path.join(ckdir, f"gather-{style}.ckpt.npz")
    setup, (recs, frames, hist, xacc, diag), secs, moves, d0 = two_chunks(
        cfg, setfl, dev, checkpoint=ck, engine="gather")
    counts = dict(ENS.COUNTS)
    r, rl = setup.t_grid.shape[0], setup.states.pos.shape[0]
    check(rl * SHARD_RANKS == r, f"[{tag}] shard of {rl} of {r} replicas")
    check(d0 == 0 and diag == 0, f"[{tag}] diag {d0}, {diag}")
    check(tuple(recs.pe.shape) == (cfg.nsmpl, r),
          f"[{tag}] records {tuple(recs.pe.shape)}, not whole")
    for row in hist.cpu().numpy():
        check(sorted(row.tolist()) == list(range(r)),
              f"[{tag}] a hist row is no permutation")
    st = mesh.host_fetch(setup.states, r)            # a collective
    errs = []
    if rank == 0:
        for rr in (0, r - 1):
            want = brute_pe(style, setup.pot, st.pos[rr], st.box[rr])
            got = float(recs.pe[-1, rr])
            lim = (0.05 + 5e-4 * abs(want) if style == "pair"
                   else 0.02 + 1e-4 * abs(want))
            errs.append(abs(got - want))
            check(abs(got - want) < lim, f"[{tag}] replica {rr}: record pe "
                  f"{got} against brute force {want} (limit {lim})")
    # the restart: a fresh set-up restored from the first chunk's
    # checkpoint runs the timed chunk again, bit for bit
    fresh = runner.setup_run(cfg, setfl=setfl, device=dev)
    t = runner.timed(fresh.device)
    fresh = runner.restore_setup(fresh, ck)
    restore_s = runner.timed(fresh.device) - t
    fresh, rrecs, _, rhist, rxacc, rdiag = runner.run_sampling(
        fresh, write_files=False)
    check(rdiag == diag, f"[{tag}] resumed diag {rdiag}, timed {diag}")
    for f in dataclasses.fields(recs):
        check(torch.equal(getattr(rrecs, f.name), getattr(recs, f.name)),
              f"[{tag}] the resumed chunk's records differ in {f.name}")
    check(torch.equal(rhist, hist) and torch.equal(rxacc, xacc),
          f"[{tag}] the resumed chunk's hist or xacc differ")
    rst, rslots = mesh.host_fetch((fresh.states, fresh.slot_of), r)
    slots = mesh.host_fetch(setup.slot_of, r)
    for f in ("pos", "box", "pe"):
        check(torch.equal(getattr(rst, f), getattr(st, f)),
              f"[{tag}] the resumed chunk's {f} differ")
    check(torch.equal(rslots, slots),
          f"[{tag}] the resumed chunk's slot_of differ")
    return dict(secs=secs, sweeps=cfg.nsmpl * cfg.mod, moves=moves,
                counts=counts, rl=rl, r=r, pe_err=errs, restore_s=restore_s,
                ck_mb=os.path.getsize(ck) / 1e6,
                chunk=host_chunk(recs, frames, hist, xacc, diag)
                if rank == 0 else None)


def sharded_rank(rank, port, table, ckdir, queue):
    """A spawned rank: both cellmc styles, then both gather styles, over
    the process group; puts (rank, result or the traceback) on
    ``queue``."""
    import traceback
    try:
        dev = mesh.rank_device("cuda", SHARD_RANKS, rank)
        backend = mesh.init_multihost(f"127.0.0.1:{port}", SHARD_RANKS,
                                      rank, device=dev)
        try:
            res = {s: sharded_style(s, rank, dev, table, ckdir)
                   for s in ("pair", "eam")}
            res.update({f"gather-{s}": sharded_gather_style(
                s, rank, dev, table, ckdir) for s in ("pair", "eam")})
        finally:
            mesh.shutdown()
        res["backend"] = backend
        res["foreign"] = sorted(m for m in sys.modules if m.split(".")[0]
                                in ("jax", "neuralmelting_tpu"))
        # pickled by value: the queue's own pickler would share the
        # tensors' storage with this process, which exits first
        queue.put((rank, pickle.dumps(res)))
    except Exception:
        queue.put((rank, traceback.format_exc()))


def phase_sharded(name, table):
    import multiprocessing as mp
    import queue as queue_mod
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    # rank 0 writes the checkpoints here, both ranks restore from them
    ckdir = tempfile.mkdtemp(prefix="nm_sharded_")
    procs = [ctx.Process(target=sharded_rank,
                         args=(i, port, table, ckdir, q))
             for i in range(SHARD_RANKS)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    res, gone = {}, set()
    try:
        while len(res) < SHARD_RANKS:
            try:
                rank, out = q.get(timeout=5.0)
            except queue_mod.Empty:
                late = sorted(set(range(SHARD_RANKS)) - set(res))
                # a rank found dead at the last wait had flushed all it
                # put before it exited
                check(not gone & set(late), f"[sharded] ranks "
                      f"{sorted(gone & set(late))} exited (codes "
                      f"{[procs[i].exitcode for i in gone]}) with no result")
                gone = {i for i in late if not procs[i].is_alive()}
                check(time.perf_counter() - t < SHARD_TIMEOUT,
                      f"[sharded] ranks {late} passed {SHARD_TIMEOUT} s")
                continue
            check(isinstance(out, bytes), f"[sharded] rank {rank} failed:\n"
                  f"{out}")
            res[rank] = pickle.loads(out)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(ckdir, ignore_errors=True)
    ranks_s = time.perf_counter() - t
    for k in ("sweep", "total", "eam_sweep", "eam_total"):
        KERNELS[k]["launches_sharded"] = sum(
            v[st]["launches"][k] for v in res.values()
            for st in ("pair", "eam"))
    for rank, out in res.items():
        check(not out["foreign"], f"[sharded] rank {rank} imported "
              f"{out['foreign']}")
    # the same chunks on this one process, whole R
    for style in ("pair", "eam"):
        cfg = BENCH.configs()["lj" if style == "pair" else "eam"]
        _, (_, _, _, _, diag), secs, moves, d0 = two_chunks(
            cfg, table if style == "eam" else None, DEV)
        check(d0 == 0 and diag == 0, f"[sharded] one process {style}: "
              f"diag {d0}, {diag}")
        per = "; ".join(
            f"rank {k} {v[style]['secs']:.4f} s a chunk, "
            f"{v[style]['moves'] / v[style]['secs']:.4e} moves/s "
            f"({v[style]['rl']} replicas, launches {v[style]['launches']})"
            for k, v in sorted(res.items()))
        errs = res[0][style]["pe_err"]
        log(f"[sharded] {style} R={res[0][style]['r']} ({cfg.ncells} fcc "
            f"cells, {cfg.mod} sweeps a chunk) over {SHARD_RANKS} ranks on "
            f"one card ({res[0]['backend']}): diag 0, hist rows "
            f"permutations, record pe against brute force |err| "
            + ", ".join(f"{e:.3e}" for e in errs)
            + f"; {per}; one process {secs:.4f} s a chunk, "
            f"{moves / secs:.4e} moves/s on {name}")
        log(f"[sharded] {style} restart: a {res[0][style]['ck_mb']:.1f} MB "
            "checkpoint of the first chunk, restored on fresh set-ups in "
            + ", ".join(f"{v[style]['restore_s']:.4f} s on rank {k}"
                        for k, v in sorted(res.items()))
            + " (barrier, load and install); the resumed chunk equals the "
            "timed one bit for bit (records, hist, xacc, diag, pos, box, "
            "pe, slot_of); launches "
            + "; ".join(f"rank {k} {v[style]['rlaunches']}"
                        for k, v in sorted(res.items()))
            + f" on {name}")
    for style in ("pair", "eam"):
        hold_sharded_gather(name, table, style, res)
    log(f"[sharded] the second chunk of each, on the host's clock after "
        f"a device sync; the ranks share one card, so this is no scaling "
        f"figure; ranks {ranks_s:.1f} s")


def hold_sharded_gather(name, table, style, res):
    """The ranks' gather chunks (``res``, by rank) against the same chunks
    on this one process, whole R: the ranks make its decisions (the
    sharding folds nothing into any seed), their energies and frames
    within the gather limits (``hold_chunk``); the report of both."""
    cfg = sharded_gather_cfgs()[style]
    setup, out, secs, _, d0 = two_chunks(
        cfg, table if style == "eam" else None, DEV, engine="gather")
    counts = dict(ENS.COUNTS)
    check(d0 == 0 and out[4] == 0, f"[sharded] one process gather "
          f"{style}: diag {d0}, {out[4]}")
    scale = None
    if style == "eam":
        # EAM's virial nearly cancels: held to its terms' magnitudes
        st = setup.states
        scale = {"virial": EE.virial_scale(setup.pot, st.pos, st.box,
                                           setup.nls)}
    tag = f"sharded gather {style}"
    err = hold_chunk(res[0][f"gather-{style}"]["chunk"], (setup, *out),
                     tag, scale=scale)
    sweeps = cfg.nsmpl * cfg.mod
    g = {k: v[f"gather-{style}"] for k, v in sorted(res.items())}

    def a_sweep(c):
        return (f"rebuilds {c['rebuilds'] / sweeps:.2f}, host syncs "
                f"{c['syncs'] / sweeps:.2f}")

    per = "; ".join(
        f"rank {k} {v['secs']:.4f} s, {1e3 * v['secs'] / sweeps:.1f} ms"
        f" a sweep ({v['rl']} replicas): {a_sweep(v['counts'])} (each "
        f"a collective), remote rebuilds "
        f"{v['counts']['remote_rebuilds'] / sweeps:.2f} a sweep"
        for k, v in g.items())
    log(f"[{tag}] R={g[0]['r']} x {setup.natoms} atoms, 1 record x "
        f"{sweeps} sweeps a chunk, over {SHARD_RANKS} ranks on one card "
        f"({res[0]['backend']}): diag 0, hist rows permutations, record "
        f"pe against brute force |err| "
        + ", ".join(f"{e:.3e}" for e in g[0]["pe_err"])
        + f"; {per}; collectives a sweep: the host syncs + 1 shrink min"
        f" + {cfg.nsmpl / sweeps:.2f} exchange gathers; one process "
        f"{secs:.4f} s, {1e3 * secs / sweeps:.1f} ms a sweep, "
        f"{a_sweep(counts)} a sweep on {name}")
    log(f"[{tag}] the ranks' timed chunk against this process's: hist, "
        f"xacc and decisions equal, pe rel {err['pe']:.2e}, virial "
        f"{err['virial']:.2e}" + (" of its terms' magnitudes" if scale
                                   else "")
        + f", vol {err['vol']:.2e}, frames {err['pos']:.2e} of the box "
        f"edge; restart: a {g[0]['ck_mb']:.1f} MB checkpoint of the "
        "first chunk, restored on fresh set-ups in "
        + ", ".join(f"{v['restore_s']:.4f} s on rank {k}"
                    for k, v in g.items())
        + " (barrier, load, lists, cache and energies on the shard); "
        "the resumed chunk equals the timed one bit for bit (records, "
        f"hist, xacc, diag, pos, box, pe, slot_of) on {name}")


def compare_probe(a, b, passes):
    """Every P1 variant at ``passes[variant]`` passes against its plain
    version; max |kernel - plain| by variant."""
    errs = {}
    for v, reps in passes.items():
        dt = P1.dtype_of(v)
        av, bv = a.to(dt), b.to(dt)
        k, p = P1.probe(v, av, bv, reps), P1.probe_plain(v, av, bv, reps)
        torch.cuda.synchronize()
        errs[v] = float((k - p).abs().max())
        rel = errs[v] / float(p.abs().max())
        check(bool(torch.isfinite(k).all()) and rel <= PROBE_TOL.get(v, 1e-6),
              f"[probe] {v} at {reps} passes: rel err {rel:.3e} against the "
              f"plain version")
    return errs


def phase_probe(name):
    a, b = P1.inputs(DEV)
    errs = compare_probe(a, b, dict.fromkeys(P1.VARIANTS, P1.REPS))
    log(f"[probe] max |kernel - plain| by variant at {P1.REPS} passes: "
        + ", ".join(f"{v} {e:.2e}" for v, e in errs.items())
        + " (limit, relative to max |plain|: 1e-6; 1e-4 for rcp.approx and "
        "rsqrtf; 2^-5 for bf16)")
    P1.reset_launches()
    res = P1.measure(DEV)
    KERNELS["probe"]["launches"] = P1.LAUNCHES["probe"]
    errs = compare_probe(a, b, {v: r["reps"] for v, r in res.items()})
    ERR["probe"] = errs["pair_div"]
    log("[probe] max |kernel - plain| by variant at its timing passes: "
        + ", ".join(f"{v} {e:.2e} ({res[v]['reps']})"
                    for v, e in errs.items()))
    sass = P1.sass_counts()
    reps = res["pair_div"]["reps"]
    plain_ms = cuda_ms(lambda: P1.probe_plain("pair_div", a, b, reps), 1)
    TIMES["probe"] = (res["pair_div"]["ms"], plain_ms)
    BOUND["probe"] = bound(4 * 3 * P1.ROWS * P1.LANES,
                           P1.OPS["pair_div"] * P1.ROWS * P1.LANES * reps)
    for v, r in res.items():
        c = sass[v]
        log(f"[probe] {v:14s} {r['reps']} passes: {r['ms']:.4f} ms per "
            f"launch on the device ({r['event_ms']:.4f} ms as issued, "
            f"{r['launches']} launches; {r['ms_at_reps']:.4f} ms at "
            f"{P1.REPS} passes), {r['ns_per_pair']:.6f} ns per pair, "
            f"{r['ops_per_pair']} ops per pair; SASS a pass {c['arith']:.3f} "
            f"arithmetic + {c['other']:.3f} other instructions; "
            f"{100 * r['share_f32_peak']:.2f}% of 67 TFLOP/s, "
            f"{100 * r['share_issue']:.2f}% of the -fmad=false issue "
            f"ceiling ({67 * P1.issue_ceiling(v):.1f} TFLOP/s); SASS bound "
            f"{100 * c['ceiling']:.2f}% of 67 TFLOP/s on {name}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    name = card()
    log(f"[card] {name}; torch.cuda.get_device_name(0)="
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    table = eam_table()
    phases = (("build", phase_build), ("small", phase_small),
              ("full", lambda: phase_full(name)),
              ("main", lambda: phase_main(name)),
              ("physics", lambda: phase_physics(name)),
              ("gather-small", lambda: phase_gather_small(name)),
              ("gather-physics", lambda: phase_gather_physics(name)),
              ("gather-hmc", lambda: phase_gather_hmc(name)),
              ("eam-small", lambda: phase_eam_small(table)),
              ("eam-full", lambda: phase_eam_full(name, table)),
              ("eam-main", lambda: phase_eam_main(name, table)),
              ("eam-gather-small",
               lambda: phase_eam_gather_small(name, table)),
              ("eam-gather-hmc", lambda: phase_eam_gather_hmc(name, table)),
              ("cli", lambda: phase_cli(name)),
              ("bench", lambda: phase_bench(name)),
              ("northstar", lambda: phase_northstar(name)),
              ("coexist", lambda: phase_coexist(name)),
              ("sweep", lambda: phase_sweep(name)),
              ("eam-physics", lambda: phase_eam_physics(name, table)),
              ("serial-small", phase_serial_small),
              ("serial-full", lambda: phase_serial_full(name)),
              ("serial-run", lambda: phase_serial_run(name)),
              ("golden", lambda: phase_golden(name)),
              ("golden-hmc", lambda: phase_golden_hmc(name)),
              ("sharded", lambda: phase_sharded(name, table)),
              ("probe", lambda: phase_probe(name)),
              ("eam-longrc", lambda: phase_eam_longrc(name)),
              ("eam-gather-full", lambda: phase_eam_gather_full(name, table)),
              ("dense-small", lambda: phase_dense_small(name)),
              ("dense-physics", lambda: phase_dense_physics(name)),
              ("dense-full", lambda: phase_dense_full(name)),
              ("gather-full", lambda: phase_gather_full(name)))
    for ph, fn in phases:
        t = time.perf_counter()
        fn()
        log(f"[{ph}] done in {time.perf_counter() - t:.1f} s")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "neuralmelting_tpu"))
    check(not foreign, f"jax or the JAX package was imported: {foreign}")
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    log("[profiler] device times taken with CUDA events because no "
        "torch.profiler session recorded the kernel: "
        + (", ".join(f"{m!r} over {c} calls" for m, c in P1.EVENT_FALLBACKS)
           or "none"))
    kern = []
    for k, meta in KERNELS.items():
        ms, pms = TIMES[k]
        bms, by = BOUND[k]
        # no single PyTorch call computes a cell-list pair sum, a
        # Metropolis sweep, a brute-force dE sum or the probe's loop: there
        # is no library yardstick
        kern.append(dict(meta, max_abs_err=ERR[k], ms=ms, plain_ms=pms,
                         bound_ms=bms, bound_by=by, library_ms=None))
    print(name)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
