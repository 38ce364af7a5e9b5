#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``rtsdr_tpu_torch/csrc`` (``nvcc``, into the
git-ignored ``rtsdr_tpu_torch/build``), then

  1. ``kernel_cases`` — calls every kernel wrapper on CUDA tensors at the
     shapes the receiver gives it (MODE0: 307,200-byte blocks, 151-tap
     filters, the 3,001-tap composed resampler, C = 1 and C = 1024; the
     composed channelizer at K = 16 with 1 and 8 captures, with no offsets
     (every station on the shared prototype), the smoke's one offset
     (15 + 1) and every station offset (own taps only), each case naming
     the stations of each route, then at K = 8 and 32 and in its generic
     instance (K = 3, decim 2); its two-stage role over a station map
     (``k5_station_map``: 38 stations over 8 slots and one a slot, 27
     captures, with and without the residual NCO in its epilogue, and one
     K5 launch a step of the compiled band38 receiver);
     every wrapper
     call of the third step of the MODE1 / MODE1_RDS receivers (320,000-byte
     blocks, 16,000 IF samples, the x57/250 resampler with its 9,003 taps),
     of the wideband receiver at 8 captures x 16 slots, and of the band
     scanner, with the receiver's own arguments; the time-sharded
     receiver's calls of the mixer + resampler kernel K6 in its third step
     at T = 1 (1,024 x 15,360) and T = 4 (4 x 1,024 stacked rows of 3,840;
     MODE1_RDS: 4 x 1,024 x 4,000 at x57/250), in its segmented form (each
     arm) and as rows behind the halo zi made in stock ops, and of the
     ingest kernel's iq entry in its segmented form; the spread route's
     calls at T = 4, C = 1,024 on shard 1: of both behind shard 0's halo as
     zi, of the FIR bank at each of its (1,024, 3,840) shapes, and of the
     PLL's loop pair from the handed-over state, ``exact`` and ``stale``;
     the resync walk K7 at L = 1, 1,024 and 8 x 16 lanes of 77 windows,
     with repairs and without, on inputs that reach every branch of the
     walk, timed by the profiler's device time)
     and holds the result
     against its plain PyTorch version on the same inputs, within the
     stated tolerance; times the kernel (CUDA events, median),
     the plain version, and for the FIR bank and the ingest kernel's iq
     entry one ``torch.nn.functional.conv1d`` call as a yardstick that the
     port itself never uses; for the FIR bank and the PLL also a burst of
     10 calls (``kernel_burst_ms``: the device's time where the host keeps
     ahead), ``F.conv1d`` the same way, and at C = 1 the host's
     microseconds per wrapper call; the PLL at 1, 2, 256, 2,048 and 4,096
     lanes, with ``loop_div`` 1 and 4, tuple input, the undelayed view and
     loop constants as lists and tuples; the ingest kernel's iq entry also
     at 101 taps and decim 8 (its instance for other filters); the
     resampler + RRC kernel's carried resampler state bit for bit;
     computes the least time the card could need;
  2. the audio path (``enable_rds=False``), counted on its own:
     ``stream_audio`` (4 blocks through ``StreamRunner`` at C = 1 and once
     more through ``python -m rtsdr_tpu_torch.cli 0 --no-rds``, identical
     bytes, tones right), ``batch_audio`` (1024 channels, 3 steps, row 0
     equal to a C = 1 run), ``batch_runner_audio`` (16 capture files through
     ``BatchRunner``);
  3. the full mode-0 path (audio + RDS), counted on its own: ``stream`` —
     24 blocks of a station that carries a PS name over 0A groups, through
     ``StreamRunner`` with the CLI's settings and a ``GroupDecoder``: tones
     right, enough syncs, few false positives, the decoded PI and PS equal
     to what was encoded; once more through ``python -m rtsdr_tpu_torch.cli
     0 --rds-groups`` (identical bytes and stderr lines); ``batch`` — 1024
     RDS-bearing stations, 6 steps, finite, row 0 equal to its C = 1 twin
     in audio and frame outputs; ``batch_runner`` — 16 capture files with
     an ``rds_hook``;
  4. ``fuse_if_bank`` — the same receiver with the band-pass bank inside
     the ingest kernel, counted on its own: outputs against the unfused
     run, ms per step of both at C = 1024 and C = 2048;
  5. ``wideband`` — one capture at 16 x 2.4 MS/s -> 16 stations, 8 captures
     per step (128 stations), stereo + RDS + frame sync, counted on its
     own: ``make_wideband_receiver(MODE0, 16, (8,))`` on captures of the
     wideband synthesizer (five live slots, one 150 kHz off its slot's
     center through ``channel_offsets_hz``, one carrying a PS name): tones
     right in the live slots and apart from them in the empty ones, PI / PS
     decoded, nothing decoded in an empty slot, the composed channelizer
     against the two-stage 'pfb' route; once more through ``python -m
     rtsdr_tpu_torch.cli 0 --wideband 16`` (channel<k>.wav files with the
     in-process run's bytes);
  6. ``scan`` — ``make_band_scanner(MODE0, 16)`` over 3 blocks, compiled
     without donation as the CLI runs it (``utils/jit.py::jit_fn``), its
     metrics bit for bit the eager scanner's, verdicts equal to what was
     synthesized, and ``--wideband 16 --auto`` through the CLI, counted on
     its own;
  7. ``channels`` — ``make_channel_sharded_receiver`` (1,024 stations) and
     ``make_wideband_sharded_receiver`` (16 slots) on a one-card mesh, each
     equal to its unsharded receiver bit for bit over 2 steps (outputs and
     state), counted on its own; then ``measure_scaling(device_counts=[1])``;
  8. ``mode1`` — ``StreamRunner(MODE1)`` at C = 1 and the CLI's mode 1
     (identical bytes, tones right), then MODE1_RDS: a stream at C = 1 that
     must decode its PI / PS, and 1024 channels with row 0 equal to its
     C = 1 twin; each counted on its own;
  9. ``timeshard`` — ``make_time_sharded_receiver(MODE0,
     make_mesh(1, T, devices=[cuda:0]), C)`` (the stacked route), stereo + RDS + frame, counted on its own: C = 1 with the
     ``exact`` handoff at T = 1, 2, 4, 8 (6 blocks of the RDS station;
     audio and frame outputs against the serial receiver's on the card),
     ``stale`` and ``iterate`` at T = 4 (left-channel SNR against the serial
     receiver from block 1 on above 38 / 60 dB, syncs in the last two
     blocks), ``iterate`` with ``pll_loop_div=4`` on a pilot 60 Hz off
     (SNR above 60 dB against the serial receiver with the same
     ``pll_loop_div``), and 1,024 channels at T = 1 and 2 (4 steps: every
     row at the exact tolerances against a witness with the time-sharded
     route's arithmetic, the serial receiver behind K1's iq route with the
     discriminator in stock ops; against the serial receiver, audio and
     symbols of the noiseless row 0 at the exact tolerances; audio of the
     rows under noise at the exact tolerance but for at most one row in
     1,000 per block, which stays within 5e-3, and their symbols within
     twice what the witness parts by; T = 2 against T = 1 in every row at
     the exact tolerance); ms per block of each beside the serial
     receiver's;
     ``timeshard_spread`` — the spread route, each time shard on its own
     CUDA stream over a mesh that names this card T times
     (``make_mesh(1, T, devices=[cuda:0] * T)``), counted on its own: C = 1
     ``exact`` at T = 2 and 4 over 8 blocks with ``resync`` (against the
     serial receiver at the exact tolerances, and against the stacked
     route from this run: audio bit for bit, the RDS path at the exact
     tolerances), C = 1,024 at T = 4 ``exact`` (the C = 1,024 limits
     above) and ``stale`` (SNR above 38 dB), the ``exact`` run once more
     with ``torch.cuda._sleep`` queued on the maker's stream before every
     hand-over (outputs bit for bit the undelayed run's), MODE1_RDS at
     T = 4 over 8 blocks (PI decoded); ms per block beside the stacked
     route's, launches per step, ``distinct_devices: 1``; these runs step
     eagerly (``jit=False``: the per-place record and the counts read the
     wrappers' calls, which a replay does not make), then each but the
     delayed one runs again compiled after the window, its outputs bit for
     bit the eager run's and its ms per block beside the eager figure, and
     the delayed run once more compiled (the sleeps captured before each
     hand-over), bit for bit the undelayed run;
     ``timeshard_mode1_rds`` — MODE1_RDS at T = 4 over 16 blocks with
     ``resync``: the encoded PI decoded; ``timeshard_routes`` (not counted)
     — the ``split`` ingest against ``fused`` at T = 2, MODE1 at T = 4
     against the serial MODE1 receiver;
 10. ``checkpoint`` — ``utils/checkpoint.py`` on the card: MODE0 at
     C = 1,024 (stereo + RDS + frame), the time-sharded receiver at
     C = 1,024 and T = 4, and the wideband receiver at 16 x 8 each run 4
     steps, and again 2 steps, ``save_state``, ``load_state`` into a fresh
     ``init_fn()`` on the card, 2 steps: the last two steps' outputs bit
     for bit those of the continuous run; the keys those of the JAX
     package's checkpoint; each counted on its own;
     ``jit`` — the compiled step (``utils/jit.py``: one CUDA graph
     replayed over donated state) against the eager step on the same
     inputs, each path counted on its own: MODE0 C = 1 (the stream's 24
     blocks, ``resync`` on; between its halves more than 2 x 64 new tap
     sets through the FIR-bank and PLL wrappers, so every device cache
     turns over twice, and the freed memory filled with NaN), MODE0 and
     the audio-only receiver at C = 1,024 (6 steps), MODE1_RDS C = 1 with
     ``resync`` (8 blocks; its cuBLAS resampler held to
     ``TOL_JIT_MATMUL``), wideband 16 x 8, the channel-sharded receiver
     on a one-card mesh, the wideband-sharded receiver (16 x 8) and the
     channel-sharded receiver (C = 1,024) each as two compiled parts on
     this card (``ComposedStep``: the code a mesh over two GPUs runs, but
     for the peer copies; the same two channel shards as one graph beside
     it), the stacked time-sharded receiver at C =
     1,024, T = 4, ``exact``, and the spread route over four streams of
     this card (one graph holding the four branches): C = 1 with
     ``resync`` over 8 blocks with the cache flood between its halves,
     C = 1,024 ``exact`` and ``stale``, MODE1_RDS C = 1 with ``resync``:
     outputs and state bit for bit, launches per
     step per kernel equal, one eager step under
     ``torch.cuda.set_sync_debug_mode("error")``, the host clock per step
     of both forms (eager, compiled, compiled, eager) and the compiled
     step's device time from events around a burst of replays; a donated
     state raising and reading empty; a checkpoint loaded into the
     compiled receiver resuming bit for bit; MODE0 at C = 4,096 (2 steps,
     the same checks), then its host clock and device time per step
     eager, compiled with the block written into the step's input buffer
     beforehand, compiled given its own tensor and compiled ``borrowed``,
     in turns and in reverse; on every path also the first step's host
     time of both forms (the compiled one warms up and captures) and the
     profiler's device launches per step of both forms (MODE0 C = 1 with
     ``resync`` compiled at most ``MAX_C1_RESYNC_DEVICE_LAUNCHES``: the
     walk is one launch).  Every other phase that uses ``Receiver``,
     ``StreamRunner``, ``BatchRunner``, the sharded receivers on one card
     or the stacked time-sharded route runs the compiled step; the kernel
     cases record the wrappers' calls of eager steps (``jit=False``: a
     replayed graph runs no Python);
     ``stage_timings`` — ``utils/profiling.py`` at C = 1,024, each stage
     compiled (``jit_fn``) and replayed as a graph, one line per stage with
     the card's name and power limit; ``trace`` — one compiled MODE0 step
     at C = 1,024 under ``utils/trace.py`` (``tools/torch_trace_check.py``'s
     ``trace_step``), whose Chrome trace must show the kernels of K1-K4 as
     device events; every profiler session of this script opens through
     ``utils/trace.py::profile``, which has CUPTI torn down after each, so
     that device events late in the process are not dropped at the
     window's start;
 11. what had never run on the card: ``batch_runner_1024`` —
     ``BatchRunner`` over 1,024 capture files, 3 blocks, each station's
     audio and frame outputs equal to its row of the batched receiver
     (counted); ``wideband_pipe`` — 4 blocks of the wideband capture
     through ``cli 0 --wideband 16`` from a file and from a pipe, the same
     wav bytes; ``wideband_other_k`` — the wideband receiver at K = 8 and
     K = 32 over 3 blocks of captures with 2 and 3 stations: each station's
     tones in its own channel; each other slot's reading of a live
     station's tone under 0.15 and within ``TOL_STRAY`` of the port's
     plain path's (float64, CPU) on the same capture (counted);
 12. ``campaign`` — ``tools/torch_decode_campaign.py`` on the card at 12
     blocks: clean and 15 dB SNR at CLI defaults (groups >= transmitted
     - 2), +200 Hz pilot detune at CLI defaults (<= 1 group) and with the
     robust clock (>= 3), the thresholds of
     ``tests/test_torch_golden_campaign.py`` (counted); beside each of the
     three scenarios the golden decoder's column (``tests/torch_oracles.py``,
     numpy + scipy on the host, outside the window), equal to the syncs and
     groups ``campaign_r5.json`` records;
 13. the measurement tools: ``scaling`` — ``tools/torch_scaling_sweep.py``
     over C = 1, 1,024 and 4,096 for the mono and the full chain (the block
     written once into the compiled step's input buffer, slope timing; each
     chain counted), then the latency of a block through the compiled
     ``StreamRunner`` at C = 1 fed at the air rate (counted); ``ingest`` —
     ``tools/torch_bench_ingest.py`` with 1, 4 and 16 pipes into a pinned
     staging array and 1,024 pipes on into a compiled function's input
     buffer (blocks, bytes and rows as written, the device's sum of the
     last block right), then the (1,024, 307,200) host-to-device copy
     against the compiled MODE0 step (counted); ``pll_envelope`` —
     ``tools/torch_pll_envelope.py``'s full grid on the card (K2 and K3 at
     ``loop_div`` 1, 2 and 4 over 36 lanes; counted), the clean centre
     point locked at div 1, and the grid at 2 blocks on the card against
     the plain versions on the CPU (lock and jitter within 0.05);
     ``fetch_overlap`` — ``io/staging.py::Fetcher`` at width: the compiled
     MODE0 step at C = 1,024 with ``resync``, 6 blocks through the
     resident loop (a device copy into the step's input, ``borrowed``,
     the fetch one step behind), each block's arrays equal to a device
     clone of its outputs taken before the next step; then 8 such steps
     traced: every device-to-host copy on a stream of no kernel, under a
     ``rtsdr.fetch_start`` span with ``side`` 1, and most of its time
     (at least 90 %) beside the next block's work on the step's stream
     (its feed, a device copy, then its kernels); ``Fetcher.start``'s
     host ms a step;
 14. for each counted window the launch counts, set to 0 just before, must
     equal steps x launches per step (the walk K7: one per step of each
     receiver with ``resync`` on).

Every line printed is one JSON object, except the line with the card's name
and power limit.  Exit code 0 and a last line ``{"ok": true, ...}`` only if
every phase passed; without a CUDA device, or if a kernel does not build,
launch or agree, the exit code is not 0 and no result is printed.
"""

from __future__ import annotations

import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

H100_MEM_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12      # float32 outside the tensor cores

TOL_FIR_REL = 2e-6    # x max|ref|: float32 sums of 151 terms, order may differ
TOL_IQ = 3e-6         # decimated I/Q, |values| < 1
TOL_FM = 5e-6         # rad: atan2f vs torch.atan2 on constant-envelope I/Q
TOL_STATE = 1e-6      # carried FIR / discriminator state
TOL_NCO = 5e-5        # cos/sin of angles the two detectors round differently
TOL_PLL_STATE = 1e-4  # sequential float32 rounding over 15,360 samples
TOL_PLL_INTEG = 1e-5  # the integrator of a locked loop is itself ~1e-3
TOL_RRC_REL = 5e-6    # x max|ref|: float32 sums of 158 + 151 terms, FMA vs
#                       multiply-then-add, the zi terms summed by a warp
TOL_ROW0 = 2e-5       # a batch row against the same station run alone
TOL_FUSED_AUDIO = 2e-5    # fused-bank receiver against the unfused one
TOL_FUSED_SYMBOLS_REL = 1e-4  # x peak symbol: through two locked loops
# a row under noise whose loop or blend a ~1e-7 difference of fm moved for
# a block (2.4e-3 on an H100): at most one row in 1,000 per block
TOL_FLIPPED_ROW_AUDIO = 5e-3

N_AUDIO_STREAM_BLOCKS = 4
N_AUDIO_BATCH_STEPS = 3
N_AUDIO_RUNNER_BLOCKS = 2
N_STREAM_BLOCKS = 24
N_BATCH_STEPS = 6
N_BATCH_CHANNELS = 1024
N_RUNNER_STATIONS = 16
N_RUNNER_BLOCKS = 4
N_FUSE_STEPS = 4
FUSE_CHANNELS = (1024, 2048)
WB_K = 16                 # slots of the wideband capture
WB_CAPTURES = 8           # captures per step: 128 stations
WB_BLOCKS = 14
N_SCAN_BLOCKS = 3
# the resync walk (K7): lanes of the stream (C = 1), the batch (1,024) and
# the wideband step (8 captures x 16 slots), each with the seed of its
# inputs (utils/signals.py::sync_walk_inputs; 11: one whose one lane
# reaches every branch of the walk)
SYNC_WALK_CASES = (((), 11), ((1024,), 1), ((8, 16), 2))
# the walk's dependent chain per window (bad -> bad: an add, two selects, a
# compare, a select), at an assumed 4 cycles per dependent integer op
SYNC_WALK_CHAIN_CYCLES = 5 * 4
MAX_C1_RESYNC_DEVICE_LAUNCHES = 210
N_MODE1_STREAM_BLOCKS = 4
N_MODE1_RDS_STREAM_BLOCKS = 16
N_MODE1_BATCH_STEPS = 3

# the time-sharded receiver (MODE0 / MODE1_RDS at full width, stereo + RDS
# + frame) and the channel / wideband sharded receivers on a one-card mesh
TS_SHARDS = (1, 2, 4, 8)      # exact handoff at C = 1
N_TS_BLOCKS = 6
N_TS_DETUNED_BLOCKS = 4
TS_BATCH_T = 2                # exact handoff at C = 1024
N_TS_BATCH_STEPS = 4
N_TS_M1_BLOCKS = 16
TS_SNR_FLOOR_DB = {"stale": 38.0, "iterate": 60.0}   # tests/test_timeshard.py
# the spread route: one stream per time shard on the one card
SPREAD_SHARDS = (2, 4)        # exact handoff at C = 1, resync on
N_SPREAD_BLOCKS = 8
SPREAD_BATCH_T = 4            # C = 1,024 (exact, stale), MODE1_RDS
N_SPREAD_M1_BLOCKS = 8
SPREAD_SLEEP_CYCLES = 1_000_000  # x (T - t) on shard t before a hand-over
N_CHANNELS_STEPS = 2
TOL_RESAMP_REL = 5e-6  # x max|ref|: float32 sums of 158 (x57/250: 158) taps
#                        and of the dense zi terms, FMA vs multiply-then-add

TOL_K5_REL = 8e-6     # x max over stations of sum|g|: two float32 sums of
#                       2 x 2,656 products of |x| < 1 values in different
#                       orders (the plain version is a blocked matrix product)
TOL_WB_AUDIO = 2e-4   # composed against the two-stage route, live slots

# the wideband band plan: slot -> (station, RDS (PI, PS) or None).  Slot 4's
# station sits 150 kHz above its slot's center; slot 13 is a mono-only
# carrier (no pilot, no stereo, no RDS).  Every stereo station carries RDS:
# a clean synthetic stereo multiplex without it still shows a 19 + 38 kHz
# product at 57 kHz some 20 dB over its (quantization-only) floor, which
# the scanner rightly cannot tell from a weak RDS carrier.
WB_OFFSET_SLOT, WB_OFFSET_HZ = 4, 150e3
WB_RDS_SLOT = 1
WB_BAND = {
    1: (dict(mono_hz=1.1e3, stereo_hz=2.3e3), (0x4D58, "WIDEBAND")),
    4: (dict(mono_hz=700.0, stereo_hz=1.7e3), (0x4D59, "OFFSET 4")),
    7: (dict(mono_hz=900.0, stereo_hz=1.9e3, pilot_phase=0.4),
        (0x4D5A, "SLOT  7 ")),
    10: (dict(mono_hz=1.3e3, stereo_hz=2.9e3, pilot_phase=1.1),
         (0x4D5B, "SLOT 10 ")),
    13: (dict(mono_hz=1.5e3, stereo_hz=3.1e3, pilot_amp=0.0,
              stereo_amp=0.0, mono_amp=0.9), None)}
WB_STATIONS = {slot: kw for slot, (kw, _) in WB_BAND.items()}
WB_PI, WB_PS = WB_BAND[WB_RDS_SLOT][1]
MODE1_PI, MODE1_PS = 0x1B2C, "MODE ONE"

# what the stream phase must decode (24 blocks air ~17 groups of ~70
# 26-bit blocks; the first two blocks go to carrier and clock acquisition;
# each of ~1,800 windows matches one of 5 offset words by chance with
# probability 5/1024: ~9 false positives expected)
STATION_PI, STATION_PS = 0x3A5C, "H100 FM "

# the auxiliary modules' phases (checkpoint, stage table, trace, the
# receivers never run on the card before, the decode campaign)
N_CKPT_STEPS = 2              # steps before and after the checkpoint
N_JIT_FLOOD = 2 * 64 + 8      # new tap sets through the wrappers
N_JIT_M1_BLOCKS = 8
N_JIT_WB_STEPS = 6
JIT_TS_T = 4
N_JIT_SPREAD_BLOCKS = 8      # the spread route's C = 1 row
JIT_HOST_STEPS = 8            # steps per host-clock timing of a form
N_JIT_WIDE = 4096             # the device-bound width of the in-place row
# MODE1's audio resampler is a torch.matmul: cuBLAS may pick another
# algorithm for a captured call, which sums in another order (float32,
# audio |x| < 1)
TOL_JIT_MATMUL = 2e-6
CKPT_TS_SHARDS = 4
N_RUNNER_1024_BLOCKS = 3
N_PIPE_BLOCKS = 4
WB_OTHER_K = {8: {1: {}, 5: dict(mono_hz=700.0, stereo_hz=1.7e3)},
              32: {3: {}, 17: dict(mono_hz=700.0, stereo_hz=1.7e3),
                   30: dict(mono_hz=1500.0, stereo_hz=3.1e3)}}
N_WB_OTHER_BLOCKS = 3
# an other slot's reading of a live station's tone against the port's plain
# path (float64, on the CPU) on the same capture: with two or three stations
# in the band their quantization products FM-capture an empty slot's
# discriminator, which reads them at ~0.1 and amplifies rounding
TOL_STRAY = 0.02
N_CAMPAIGN_BLOCKS = 12
# the golden decoder's column of campaign_r5.json at 12 blocks (syncs,
# groups); the golden pass is numpy + scipy on the host, and the port's
# synthesizer gives the JAX tool's streams value for value
GOLDEN_CAMPAIGN = {"clean": (33, 7), "snr15": (33, 7),
                   "detune+200": (23, 5)}
# the measurement tools' phases: channel counts of the sweep, its repeats,
# the stream-latency streams, the ingest pipe counts and blocks per pipe,
# the rows of the device path, and the PLL envelope's card-against-CPU
# comparison (blocks; tolerances of tests/test_torch_golden_pll.py)
SCALING_CHANNELS = (1, 1024, 4096)
SCALING_REPEATS = 3
N_LATENCY_RUNS = 6
INGEST_PIPES = (1, 4, 16)
N_INGEST_BLOCKS = 100
INGEST_DEVICE_ROWS = 1024
N_INGEST_DEVICE_BLOCKS = 8
N_ENVELOPE_CHECK_BLOCKS = 2
TOL_ENVELOPE_LOCK = 0.05
TOL_ENVELOPE_JITTER = 0.05
ENVELOPE_PHASE_HELD = 0.5   # jitter is defined where the loop holds a phase
# the checkpoint keys of a MODE0 receiver state with RDS and the frame
# layer: those of rtsdr_tpu.utils.checkpoint (tests/test_torch_checkpoint.py
# holds the port's and the JAX package's keys to this list)
CHECKPOINT_KEYS = [
    "frontend/zi_i", "frontend/zi_q", "frontend/prev_i", "frontend/prev_q",
    "audio/mono_zi", "audio/pilot_zi", "audio/chan_zi", "audio/stereo_zi",
    *(f"audio/pll/{f}" for f in ("integrator", "phase_est", "fb_i", "fb_q",
                                 "nco_i", "nco_q", "theta")),
    "rds/extract_zi", "rds/squared_zi",
    *(f"rds/pll/{f}" for f in ("integrator", "phase_est", "fb_i", "fb_q",
                               "nco_i", "nco_q", "theta")),
    "rds/resamp_zi", "rds/rrc_zi",
    *(f"frame/{f}" for f in ("offset", "start_pos", "lonely_bit", "prebit",
                             "first_block", "carry", "carry_len", "base_pos",
                             "last_position", "bad_count", "offset_frac",
                             "derot_phase")),
]
MIN_STREAM_SYNCS = 40
MAX_STREAM_FALSE_POSITIVES = 25


def band38_plan(cfg):
    """Each station's slot and offset for every second 200 kHz channel from
    88.3 to 105.9 MHz but the 7 on a slot edge, around 97.9 MHz at 8 x the
    RF rate, as ``--wideband 8 --wideband-centers`` maps them."""
    from rtsdr_tpu_torch import cli

    edges = {895, 919, 943, 967, 991, 1015, 1039}       # 100 kHz units
    chans = [883 + 4 * i for i in range(45) if 883 + 4 * i not in edges]
    spec = ",".join(f"{(c - 979) * 100}k" for c in chans)
    slots, offsets, err = cli._centers_to_offsets(cfg, 8, spec)
    if err:
        raise ValueError(err)
    return slots, [float(o) for o in offsets]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the port stands alone: JAX and the JAX package are unimportable in
    # this process, so that a path which reaches either fails the run
    for name in ("jax", "jaxlib", "rtsdr_tpu"):
        if name not in sys.modules:
            sys.modules[name] = None

    import numpy as np
    import torch.nn.functional as F

    from rtsdr_tpu_torch import runtime
    from rtsdr_tpu_torch.config import MODE0, MODE1, MODE1_RDS
    from rtsdr_tpu_torch.io.batch import BatchRunner
    from rtsdr_tpu_torch.io.stream import StreamRunner
    from rtsdr_tpu_torch.ops import (
        _cuda, channelizer, coeffs, cuda_fir, cuda_pll, cuda_resample,
        cuda_sync, fir, ingestfir)
    from rtsdr_tpu_torch.ops.pll import PLLState, pll, pll_init, pll_loop
    from rtsdr_tpu_torch.parallel import timeshard as timeshard_mod
    from rtsdr_tpu_torch.parallel.channels import (
        compose_wideband, make_channel_sharded_receiver,
        make_wideband_sharded_receiver, shard_rows)
    from rtsdr_tpu_torch.parallel.mesh import make_mesh, row_split
    from rtsdr_tpu_torch.parallel.scaling import measure_scaling
    from rtsdr_tpu_torch.parallel.timeshard import make_time_sharded_receiver
    from rtsdr_tpu_torch.pipeline import audio as audio_mod
    from rtsdr_tpu_torch.pipeline import frame as frame_mod
    from rtsdr_tpu_torch.pipeline.audio import audio_lpf_taps
    from rtsdr_tpu_torch.pipeline import frontend as frontend_mod
    from rtsdr_tpu_torch.pipeline import rds as rds_mod
    from rtsdr_tpu_torch.pipeline.frontend import rf_lpf_taps
    from rtsdr_tpu_torch.pipeline.groups import GroupDecoder, format_group
    from rtsdr_tpu_torch.pipeline.rds import composed_resampler_taps
    from rtsdr_tpu_torch.pipeline.receiver import Receiver, make_receiver
    from rtsdr_tpu_torch.pipeline.scan import classify, make_band_scanner
    from rtsdr_tpu_torch.pipeline.wideband import make_wideband_receiver
    from rtsdr_tpu_torch.utils import jit as jit_mod
    from rtsdr_tpu_torch.utils import profiling as prof_mod
    from rtsdr_tpu_torch.utils import shards as shards_mod
    from rtsdr_tpu_torch.utils import trace as trace_mod
    from rtsdr_tpu_torch.utils.checkpoint import (
        load_state, save_state, state_keys)
    from rtsdr_tpu_torch.utils.profiling import stage_timings
    from rtsdr_tpu_torch.utils.signals import (
        encode_rds_blocks, fm_multiplex_iq, ps_station_words, rds_baseband,
        sync_walk_inputs, wideband_capture_iq)

    # the plain versions are explicit float32 sums, but state it anyway:
    # no TF32 anywhere in a reference or a yardstick
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    cfg = MODE0
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _cuda.load()
    t1 = time.perf_counter()
    # the host runtime (C++ block reader) builds at first use too: build it
    # here, so the stream phase below times streaming and not g++
    native_reader = runtime.have_native()
    emit({"build": {"seconds": round(t1 - t0, 3),
                    "nvcc_seconds": _cuda.build_seconds,
                    "sources": [f"rtsdr_tpu_torch/csrc/{s}"
                                for s in _cuda.SOURCES],
                    "host_runtime_seconds": round(time.perf_counter() - t1, 3),
                    "host_runtime_native": native_reader}, "card": card})

    # ------------------------------------------------------------ helpers
    def time_ms(fn, reps=7, warm=2):
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def burst_ms(fn, calls=10, reps=5):
        """Events around a burst of ``calls`` calls, per call: the device
        time where the device, not the host's enqueueing, is the limit."""
        return time_ms(lambda: [fn() for _ in range(calls)], reps=reps
                       ) / calls

    def host_us(fn, calls=20, reps=15):
        """Host time per call: loops of ``calls`` calls with no
        synchronisation inside (short enough that the launch queue never
        fills and blocks the host), median of ``reps``."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    def profiled_device_ms(fn, calls=20):
        """Device time per call of ``fn`` from a profiler trace (the sum of
        its device events over ``calls`` calls): a kernel's own time where
        its wrapper's host work exceeds it, as events around calls would
        not show.  None where the profiler sees no device time."""
        fn()
        torch.cuda.synchronize()
        with trace_mod.profile() as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us += max((float(getattr(e, k)) for k in (
                    "self_device_time_total", "self_cuda_time_total")
                    if hasattr(e, k)), default=0.0)
        return us / 1e3 / calls if us > 0 else None

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors
                   if t is not None)

    def bound(bytes_moved, flops):
        t_b = bytes_moved / H100_MEM_BYTES_PER_S * 1e3
        t_o = flops / H100_F32_FLOP_PER_S * 1e3
        return {"bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "bytes": int(bytes_moved), "flop": int(flops),
                "bytes_ms": t_b, "operations_ms": t_o}

    def max_err(a, b):
        return float((a.double() - b.double()).abs().max())

    cases = []

    def check(name, shape, errs, tols, **extra):
        """errs / tols: dicts by quantity; fail the run if any exceeds."""
        bad = {k: (errs[k], tols[k]) for k in errs if not errs[k] <= tols[k]}
        row = {"name": name, "shape": shape, "max_abs_err": max(errs.values()),
               "errors": errs, "tolerances": tols, **extra}
        cases.append(row)
        if bad:
            emit({"kernel_case_failed": row})
            raise SystemExit(f"chip_smoke: {name} {shape} disagrees with its "
                             f"plain version: {bad}")
        return row

    def shape_of(x):
        return "(" + ", ".join(str(n) for n in x.shape) + ")"

    def bank_case(pre, hl, s, x, x2, zi, **extra):
        """One FIR-bank call on the kernel and on its plain version, with
        one conv1d call as the yardstick."""
        n_taps = len(hl[0])
        lanes = x.numel() // x.shape[-1]
        if zi is None:
            zi = torch.zeros((*x.shape[:-1], n_taps - 1), device=dev)
        k_ys, k_t = cuda_fir.fir_bank_carried(x, hl, zi, s, x2=x2, pre=pre)
        r_ys, r_t = cuda_fir.fir_bank_carried_ref(x, hl, zi, s, x2=x2,
                                                  pre=pre)
        errs = {f"y{f}": max_err(a, b)
                for f, (a, b) in enumerate(zip(k_ys, r_ys))}
        tols = {f"y{f}": TOL_FIR_REL * float(b.abs().max())
                for f, b in enumerate(r_ys)}
        errs["new_zi"] = max_err(k_t, r_t)
        tols["new_zi"] = TOL_STATE
        # yardstick: one conv1d call over the already extended (and, for a
        # pre-op, already mixed / squared) input
        xp = x if pre == "none" else (x * x if pre == "square"
                                      else 2.0 * x * x2)
        xext = torch.cat([zi, xp], dim=-1).reshape(lanes, 1, -1)
        del xp
        w = torch.as_tensor(np.stack(hl)[:, None, ::-1].copy(),
                            dtype=torch.float32, device=dev)
        lib = F.conv1d(xext, w, stride=s)
        lib_err = max(max_err(lib[:, f], r_ys[f].reshape(lanes, -1)) /
                      float(r_ys[f].abs().max()) for f in range(len(hl)))
        del lib
        n_out = k_ys[0].shape[-1]

        def kernel():
            return cuda_fir.fir_bank_carried(x, hl, zi, s, x2=x2, pre=pre)

        def library():
            return F.conv1d(xext, w, stride=s)

        check(f"fir_bank.{pre}", f"f32 {shape_of(x)}", errs, tols,
              filters=len(hl), stride=s,
              kernel_ms=time_ms(kernel), kernel_burst_ms=burst_ms(kernel),
              **({"kernel_host_us": host_us(kernel),
                  "library_host_us": host_us(library)} if lanes == 1
                 else {}),
              plain_ms=time_ms(lambda: cuda_fir.fir_bank_carried_ref(
                  x, hl, zi, s, x2=x2, pre=pre), reps=2, warm=0),
              library_ms=time_ms(library),
              library_burst_ms=burst_ms(library),
              library="torch.nn.functional.conv1d (cudnn.allow_tf32="
                      "False) on the extended, pre-mixed input",
              library_rel_err_vs_plain=lib_err,
              **bound(nbytes(x, x2, zi, k_t, *k_ys),
                      len(hl) * lanes * n_out * 2 * n_taps
                      + (0 if pre == "none" else
                         x.numel() * (1 if pre == "square" else 2))),
              **extra)

    def pll_case(label, x, st, div, gate=None, extra=None, **kw):
        """One PLL call on the kernel and on its plain version.  ``gate``:
        boolean mask over the lanes that are held to the tolerance (the
        lanes that have a carrier to lock to); the others are reported."""
        xs = torch.stack(x, 0) if isinstance(x, tuple) else x
        lanes = xs.numel() // xs.shape[-1]
        k = cuda_pll.pll_cuda(x, st, loop_div=div, **kw)
        t_plain = time.perf_counter()
        r = pll_loop(xs, st, loop_div=div, **kw)
        torch.cuda.synchronize()
        t_plain = (time.perf_counter() - t_plain) * 1e3
        if gate is None:
            gate = torch.ones(xs.shape[:-1], dtype=torch.bool, device=dev)
        errs = {"nco_i": max_err(k[0][gate], r[0][gate]),
                "nco_q": max_err(k[1][gate], r[1][gate])}
        tols = {"nco_i": TOL_NCO, "nco_q": TOL_NCO}
        for name, a, b in zip(PLLState._fields, k[2], r[2]):
            d = (a.double() - b.double()).abs()[gate]
            if name in ("phase_est", "theta"):      # angles mod 4 pi
                d = torch.minimum(d % (4 * np.pi),
                                  4 * np.pi - d % (4 * np.pi))
            # the state has leaves called nco_i / nco_q too
            errs[f"state.{name}"] = float(d.max())
            tols[f"state.{name}"] = (TOL_PLL_INTEG if name == "integrator"
                                     else TOL_PLL_STATE)
        n = xs.shape[-1]

        def kernel():
            return cuda_pll.pll_cuda(x, st, loop_div=div, **kw)

        check("pll", f"f32 {label} = {lanes} lanes x {n}", errs, tols,
              loop_div=div, delay_output=kw.get("delay_output", True),
              lanes_held_to_tolerance=int(gate.sum()),
              nco_max_abs_err_all_lanes=max(max_err(k[0], r[0]),
                                            max_err(k[1], r[1])),
              integrator_max_abs=float(r[2].integrator.abs().max()),
              kernel_ms=time_ms(kernel), kernel_burst_ms=burst_ms(kernel),
              **({"kernel_host_us": host_us(kernel)} if lanes <= 2
                 else {}),
              plain_ms=t_plain, library_ms=None,
              **bound(nbytes(xs, k[0], k[1]) + 2 * 7 * 4 * lanes
                      + 5 * 4 * lanes,
                      lanes * n * (12 // div + 8)),
              **(extra or {}))

    # ------------------------------------------------------------- inputs
    rf_h = rf_lpf_taps(cfg)
    mono_h = audio_lpf_taps(cfg)
    if_fs = cfg.rf.if_fs
    pilot_h = coeffs.bandpass_taps(if_fs, cfg.stereo.pilot_lo,
                                   cfg.stereo.pilot_hi, cfg.stereo.taps)
    chan_h = coeffs.bandpass_taps(if_fs, cfg.stereo.chan_lo,
                                  cfg.stereo.chan_hi, cfg.stereo.taps)
    rds_h = coeffs.bandpass_taps(if_fs, cfg.rds.extract_lo,
                                 cfg.rds.extract_hi, cfg.rds.taps)
    sq_h = coeffs.bandpass_taps(if_fs, cfg.rds.squared_lo,
                                cfg.rds.squared_hi, cfg.rds.taps)
    comb_h = composed_resampler_taps(cfg)
    rrc_h = coeffs.rrc_taps(cfg.rds.rrc_fs, cfg.rds.rrc_taps,
                            cfg.rds.rrc_beta, cfg.rds.symbol_rate)
    up, down = cfg.rds.up, cfg.rds.down
    n_if, n_audio, n_rds = cfg.if_len, cfg.audio_len, cfg.rds_len
    taps = cfg.rf.taps

    def rds_station(n_blocks, pi, ps, **kw):
        """(n_blocks, block_size) u8 of a stereo station that spells ``ps``
        over 0A groups (0.73 groups per block)."""
        wave = rds_baseband(encode_rds_blocks(
            ps_station_words(n_blocks + 4, pi, ps)))
        return fm_multiplex_iq(n_blocks * cfg.iq_len, rds_wave=wave, **kw
                               ).reshape(n_blocks, cfg.block_size)

    station = rds_station(N_STREAM_BLOCKS, STATION_PI, STATION_PS)
    # 16 distinct stations (tone frequencies, pilot phases, PI codes, PS
    # names), tiled to the batch's rows; every row but row 0 gets its own
    # +-8 LSB of uniform noise
    variants = [station[:N_BATCH_STEPS]]
    for k in range(1, 16):
        variants.append(rds_station(
            N_BATCH_STEPS, STATION_PI + k, f"STN {k:02d}  ",
            mono_hz=700.0 + 130.0 * k, stereo_hz=1500.0 + 210.0 * k,
            pilot_phase=0.37 * k))
    variants_host = np.stack(variants, axis=1)                   # (6, 16, B)
    variants = torch.as_tensor(variants_host).to(dev)
    gen = torch.Generator(device=dev).manual_seed(20260)

    def batch_block(b: int, c: int = N_BATCH_CHANNELS) -> torch.Tensor:
        rows = variants[b].repeat(c // 16, 1).to(torch.int16)
        noise = torch.randint(-8, 9, rows.shape, generator=gen, device=dev,
                              dtype=torch.int16)
        noise[0] = 0
        return (rows + noise).clamp_(0, 255).to(torch.uint8)

    # -------------------------------------------------- 1. kernel cases
    # Inputs of block 1 with the states block 0 left behind, so that every
    # carried state is a real mid-stream one.
    def ingest_inputs(c):
        if c == 1:
            raws = [torch.as_tensor(station[b][None]).to(dev) for b in (0, 1)]
        else:
            raws = [batch_block(0), batch_block(1)]
        z = lambda *s: torch.zeros(s, device=dev)
        st = (z(c, taps - 1), z(c, taps - 1), torch.ones(c, device=dev),
              z(c), z(c, len(mono_h) - 1))
        out = ingestfir.ingest_fir_demod_audio(
            raws[0], rf_h, st[0], st[1], st[2], st[3], cfg.rf.decim, mono_h,
            st[4], cfg.mono.down)
        return raws[1], out[2:], out[0]

    # B1's yardstick: one grouped conv1d (stride decim) over the normalized
    # (.., 2, taps-1 + N) I/Q extended by the carried zi (+ the left
    # neighbour's tail, segmented form)
    def ingest_iq_case(raw, zi_i, zi_q, segments=None, h=rf_h,
                       decim=cfg.rf.decim, note="", **extra):
        """One ``ingest_fir_decimate`` call (K1's iq entry) on the kernel,
        on its plain version and as one ``F.conv1d`` call."""
        args = (raw, h, zi_i, zi_q, decim)
        k = ingestfir.ingest_fir_decimate(*args, segments=segments)
        r = ingestfir.ingest_fir_decimate_ref(*args, segments=segments)
        names = ("i", "q", "zi_i", "zi_q")
        rows = zi_i.numel() // zi_i.shape[-1]
        t1 = len(h) - 1
        w = torch.as_tensor(np.stack([h[::-1]] * 2)[:, None].copy(),
                            dtype=torch.float32, device=dev)
        zi2 = torch.stack([zi_i, zi_q], dim=-2).reshape(rows, 2, t1)
        if segments:
            # rows (S, C): each segment behind its left neighbour's tail
            seg = raw.reshape(raw.shape[0], segments, -1).transpose(0, 1)
            xn = ingestfir.normalize_deinterleave(seg).reshape(rows, 2, -1)
            zi2 = zi2.clone()
            zi2[raw.shape[0]:] += xn[:-raw.shape[0], :, -t1:]
        else:
            xn = ingestfir.normalize_deinterleave(raw).reshape(rows, 2, -1)
        xn = torch.cat([zi2, xn], dim=-1)
        del zi2
        lib = F.conv1d(xn, w, stride=decim, groups=2)
        lib_err = max(max_err(lib[:, 0], r[0].reshape(rows, -1)),
                      max_err(lib[:, 1], r[1].reshape(rows, -1)))
        del lib
        check("ingest.iq", f"u8 {shape_of(raw)}{note}",
              {n: max_err(a, b) for n, a, b in zip(names, k, r)},
              dict(zip(names, (TOL_IQ, TOL_IQ, TOL_STATE, TOL_STATE))),
              segments=segments,
              kernel_ms=time_ms(lambda: ingestfir.ingest_fir_decimate(
                  *args, segments=segments)),
              plain_ms=time_ms(lambda: ingestfir.ingest_fir_decimate_ref(
                  *args, segments=segments), reps=2, warm=0),
              library_ms=time_ms(lambda: F.conv1d(
                  xn, w, stride=decim, groups=2)),
              library="torch.nn.functional.conv1d (cudnn.allow_tf32=False),"
                      f" stride {decim}, groups 2, on the normalized I/Q "
                      "extended by zi",
              library_max_abs_err_vs_plain=lib_err,
              **bound(nbytes(raw, zi_i, zi_q, *k),
                      rows * k[0].shape[-1] * 2 * 2 * len(h)), **extra)
        del xn

    for c in (N_BATCH_CHANNELS, 1):
        raw, (zi_i, zi_q, pi, pq, azi), fm_prev = ingest_inputs(c)
        shape = f"u8 ({c}, {cfg.block_size})"
        rf_flop = c * n_if * 2 * 2 * taps
        au_flop = c * n_audio * 2 * len(mono_h)
        if c != 1:
            ingest_iq_case(raw, zi_i, zi_q)
            # K1's instance for other filters and decimations (the
            # receivers' own has 151 taps at decim 10 compiled in): 101
            # taps at decim 8
            z8 = torch.zeros(c, 100, device=dev)
            ingest_iq_case(raw, z8, z8, h=coeffs.lowpass_taps(
                cfg.rf.fs, 100e3, 101), decim=8, note=", 101 taps at decim 8")
            del z8
            k = ingestfir.ingest_fir_demod(raw, rf_h, zi_i, zi_q, pi, pq,
                                           cfg.rf.decim)
            r = ingestfir.ingest_fir_demod_ref(raw, rf_h, zi_i, zi_q, pi, pq,
                                               cfg.rf.decim)
            names = ("fm", "zi_i", "zi_q", "prev_i", "prev_q")
            check("ingest.fm", shape,
                  {n: max_err(a, b) for n, a, b in zip(names, k, r)},
                  dict(zip(names, (TOL_FM,) + (TOL_STATE,) * 4)),
                  kernel_ms=time_ms(lambda: ingestfir.ingest_fir_demod(
                      raw, rf_h, zi_i, zi_q, pi, pq, cfg.rf.decim)),
                  plain_ms=time_ms(lambda: ingestfir.ingest_fir_demod_ref(
                      raw, rf_h, zi_i, zi_q, pi, pq, cfg.rf.decim),
                      reps=2, warm=0),
                  library_ms=None,
                  **bound(nbytes(raw, zi_i, zi_q, pi, pq, *k),
                          rf_flop + c * n_if * 8))
        args = (raw, rf_h, zi_i, zi_q, pi, pq, cfg.rf.decim, mono_h, azi,
                cfg.mono.down)
        names = ("fm", "audio", "zi_i", "zi_q", "prev_i", "prev_q",
                 "audio_zi")
        if_zi = fm_prev[:, -(taps - 1):].contiguous()
        bank_hs = [pilot_h, chan_h, rds_h]
        fm_err = 0.0
        # without and with the band-pass bank stage, fm written or not
        for bank, emit_fm in ((False, True), (False, False), (True, True),
                              (True, False)):
            if c == 1 and not emit_fm and not bank:
                continue
            kw = dict(emit_fm=emit_fm)
            if bank:
                kw.update(bank_h=bank_hs, bank_zi=if_zi)
            k = ingestfir.ingest_fir_demod_audio(*args, **kw)
            r = ingestfir.ingest_fir_demod_audio_ref(*args, **kw)
            tols = (TOL_FM, TOL_FIR_REL * float(r[1].abs().max()),
                    TOL_STATE, TOL_STATE, TOL_STATE, TOL_STATE, TOL_FM)
            errs = {n: max_err(a, b) for n, a, b in zip(names, k, r)
                    if a is not None}
            tols = {n: t for n, t in zip(names, tols) if n in errs}
            assert (k[0] is None) == (not emit_fm)
            fm_err = max(fm_err, errs.get("fm", 0.0))
            flop = rf_flop + c * n_if * 8 + au_flop
            if bank:
                # the plain bank filters the PLAIN fm, which differs from
                # the kernel's by fm_err (atan2f vs torch.atan2): a filter
                # passes that on scaled by at most sum|h|, which for the
                # narrow pilot band-pass is not small beside its output
                for f, (a, b) in enumerate(zip(k[7], r[7])):
                    errs[f"bank{f}"] = max_err(a, b)
                    tols[f"bank{f}"] = (
                        TOL_FIR_REL * float(b.abs().max())
                        + max(fm_err, 2.5e-7)
                        * float(np.abs(bank_hs[f]).sum()))
                flop += 3 * c * n_if * 2 * taps
            outs = [t for t in k[:7]] + (list(k[7]) if bank else [])
            check("ingest.fm_audio_bank" if bank else "ingest.fm_audio",
                  shape, errs, tols, emit_fm=emit_fm,
                  kernel_ms=time_ms(
                      lambda: ingestfir.ingest_fir_demod_audio(*args, **kw)),
                  plain_ms=time_ms(
                      lambda: ingestfir.ingest_fir_demod_audio_ref(
                          *args, **kw), reps=2, warm=0),
                  library_ms=None,
                  **bound(nbytes(raw, zi_i, zi_q, pi, pq, azi,
                                 if_zi if bank else None, *outs), flop))

        # FIR bank at the shapes audio.py gives it: fm of this block, the
        # bank's own outputs as the mixer's inputs
        fm = ingestfir.ingest_fir_demod_audio(*args)[0]
        (_, chan_prev, ext_prev), _ = cuda_fir.fir_bank_carried(
            fm_prev, bank_hs, None)
        (pilot, chan, extract), _ = cuda_fir.fir_bank_carried(fm, bank_hs,
                                                              if_zi)
        st0 = pll_init((c,), device=dev)
        pkw = dict(freq=cfg.stereo.pll.freq, fs=if_fs,
                   nco_scale=cfg.stereo.pll.nco_scale,
                   phase_adjust=cfg.stereo.pll.phase_adjust,
                   norm_bandwidth=cfg.stereo.pll.norm_bandwidth)
        nco_prev, _, st1 = cuda_pll.pll_cuda(
            cuda_fir.fir_bank(fm_prev, [pilot_h])[0], st0, **pkw)
        nco, _, _ = cuda_pll.pll_cuda(pilot, st1, **pkw)
        mix_zi = (2.0 * chan_prev * nco_prev)[:, -(len(mono_h) - 1):
                                              ].contiguous()
        sq_zi = (ext_prev * ext_prev)[:, -(taps - 1):].contiguous()

        bank_cases = [("none", [pilot_h, chan_h], 1, fm, None, if_zi)]
        bank_cases.append(("mul2", [mono_h], cfg.mono.down, chan, nco,
                           mix_zi))
        bank_cases.append(("square", [sq_h], 1, extract, None, sq_zi))
        bank_cases.append(("none", bank_hs, 1, fm, None, if_zi))
        for case in bank_cases:
            bank_case(*case)

        # PLL: the band-passed pilot of this block from the locked state
        b1 = (2, 1)
        sp, rp = cfg.stereo.pll, cfg.rds.pll
        kw2 = dict(
            freq=np.array([sp.freq, rp.freq]).reshape(b1), fs=if_fs,
            nco_scale=np.array([sp.nco_scale, rp.nco_scale]).reshape(b1),
            phase_adjust=np.array([sp.phase_adjust,
                                   rp.phase_adjust]).reshape(b1),
            norm_bandwidth=np.array([sp.norm_bandwidth,
                                     rp.norm_bandwidth]).reshape(b1))
        pll_case(f"({c}, N)", pilot, st1, 1, **pkw)
        pll_case(f"({c}, N)", pilot, st1, 4, **pkw)
        # two-part input with per-part constants: the stereo-pilot +
        # squared-RDS-carrier pair of the receiver's one PLL launch (the
        # second part is a clean 114 kHz carrier per lane: an unlocked loop
        # fed noise wanders across the detector's +-pi seam, where two
        # roundings of one angle legitimately part)
        tt = torch.arange(n_if, device=dev, dtype=torch.float64) / if_fs
        ph = 0.05 * (torch.arange(c, device=dev) % 16)[:, None]
        sq = torch.cos(2 * np.pi * cfg.rds.pll.freq * tt[None, :] + ph
                       ).to(torch.float32)
        st2 = PLLState(*(torch.stack([a, b]) for a, b in
                         zip(st1, pll_init((c,), device=dev))))
        pll_case(f"2 parts of ({c}, N)", (pilot, sq), st2, 1, **kw2)
        # from the state that block leaves (both loops locked; the pilot
        # and the carrier are whole cycles per block): loop_div 4, the
        # undelayed view and, at C = 1,024, twice the lanes (4,096)
        st2 = cuda_pll.pll_cuda((pilot, sq), st2, **kw2)[2]
        pll_case(f"2 parts of ({c}, N)", (pilot, sq), st2, 4, **kw2)
        pll_case(f"2 parts of ({c}, N), undelayed", (pilot, sq), st2, 1,
                 delay_output=False, **kw2)
        if c == 1:
            # loop constants as lists and tuples (the plain loop's forms):
            # the pilot and the carrier as two lanes of one input
            pll_case("(2, N), list constants", torch.cat([pilot, sq]),
                     PLLState(*(v.reshape(2) for v in st2)), 1,
                     freq=[sp.freq, rp.freq], fs=if_fs,
                     nco_scale=[sp.nco_scale, rp.nco_scale],
                     phase_adjust=(sp.phase_adjust, rp.phase_adjust),
                     norm_bandwidth=[sp.norm_bandwidth, rp.norm_bandwidth])
        if c != 1:
            pll_case(f"2 parts of ({2 * c}, N)",
                     (pilot.repeat(2, 1), sq.repeat(2, 1)),
                     PLLState(*(v.repeat(1, 2) for v in st2)), 1, **kw2)

        # mixers + resampler + RRC: extract of both blocks, the carrier NCO
        # the PLL kernel makes of their squared band-pass; block 0 from the
        # zero state, block 1 (the one timed) from the states block 0 left
        rkw = dict(freq=rp.freq, fs=if_fs, nco_scale=rp.nco_scale,
                   phase_adjust=rp.phase_adjust,
                   norm_bandwidth=rp.norm_bandwidth)
        pre0, sq_zi0 = cuda_fir.fir_block_pre(
            ext_prev, sq_h, torch.zeros(c, taps - 1, device=dev), "square")
        ni0, nq0, rst = cuda_pll.pll_cuda(pre0, st0, **rkw)
        pre1, _ = cuda_fir.fir_block_pre(extract, sq_h, sq_zi0, "square")
        ni1, nq1, _ = cuda_pll.pll_cuda(pre1, rst, **rkw)
        r_zi = torch.zeros(c, 2, len(comb_h) - 1, device=dev)
        r_rzi = torch.zeros(c, 2, len(rrc_h) - 1, device=dev)
        for blk, (e_, ni_, nq_) in enumerate(((ext_prev, ni0, nq0),
                                              (extract, ni1, nq1))):
            rargs = (e_, ni_, nq_, comb_h, r_zi, rrc_h, r_rzi, up, down)
            k = cuda_resample.resample_mul2_rrc(*rargs)
            r = cuda_resample.resample_mul2_rrc_ref(*rargs)
            rnames = ("rrc", "new_zi", "new_rrc_zi")
            errs = {n: max_err(a, b) for n, a, b in zip(rnames, k, r)}
            scale = float(r[0].abs().max())
            # new_zi: the kernel writes the reference's tail bit for bit
            tols = {"rrc": TOL_RRC_REL * scale, "new_zi": 0.0,
                    "new_rrc_zi": TOL_RRC_REL * scale}
            timing = {}
            if blk == 1:
                timing = dict(
                    kernel_ms=time_ms(
                        lambda: cuda_resample.resample_mul2_rrc(*rargs)),
                    plain_ms=time_ms(
                        lambda: cuda_resample.resample_mul2_rrc_ref(*rargs),
                        reps=2, warm=0),
                    library_ms=None,
                    # per output and branch: the taps that meet a sample
                    # (every up-th of the composed filter) + the RRC's;
                    # 2 multiplies per mixed sample
                    **bound(nbytes(e_, ni_, nq_, r_zi, r_rzi, *k),
                            c * 2 * n_rds * 2 * (-(-len(comb_h) // up)
                                                 + len(rrc_h))
                            + c * 2 * n_if * 2))
            check("resample_rrc", f"3 x f32 ({c}, {n_if})", errs, tols,
                  block=blk, rrc_max_abs=scale,
                  carried_zi_max_abs=float(r_zi.abs().max()), **timing)
            r_zi, r_rzi = k[1], k[2]
        del (fm, pilot, chan, extract, nco, fm_prev, chan_prev, ext_prev,
             nco_prev, raw, pre0, pre1, ni0, nq0, ni1, nq1, r_zi, r_rzi, k, r)
        torch.cuda.empty_cache()

    # ---- 1b. kernel cases of the wideband and the mode-1 shapes
    # One wideband capture from the synthesizer (host, once): five live
    # slots of 16; capture 0 of a step is it, captures 1..7 the same band
    # under their own +-2 LSB of uniform noise.
    t_syn = time.perf_counter()
    wb_stations = {slot: dict(kw) for slot, kw in WB_STATIONS.items()}
    for slot, (_, rds) in WB_BAND.items():
        if rds is not None:
            wb_stations[slot]["rds_wave"] = rds_baseband(encode_rds_blocks(
                ps_station_words(WB_BLOCKS + 4, *rds)))
    wb_offsets = np.zeros(WB_K)
    wb_offsets[WB_OFFSET_SLOT] = WB_OFFSET_HZ
    wbs = WB_K * cfg.block_size
    wb_host = wideband_capture_iq(
        WB_BLOCKS * cfg.iq_len, WB_K, wb_stations, cfg.rf.fs, wb_offsets
    ).reshape(WB_BLOCKS, wbs)
    wb_dev = torch.as_tensor(wb_host).to(dev)
    wb_blocks = []
    for b in range(WB_BLOCKS):
        rows = wb_dev[b].expand(WB_CAPTURES, -1).to(torch.int16)
        noise = torch.randint(-2, 3, rows.shape, generator=gen, device=dev,
                              dtype=torch.int16)
        noise[0] = 0
        wb_blocks.append((rows + noise).clamp_(0, 255).to(torch.uint8))
    del rows, noise
    emit({"wideband_synthesis": {
        "seconds": round(time.perf_counter() - t_syn, 3), "slots": WB_K,
        "blocks": WB_BLOCKS, "live_slots": sorted(WB_STATIONS),
        "bytes_per_capture_block": wbs}})

    # K5: the receiver's taps with no offsets (every station on the shared
    # prototype), with the smoke's one offset (15 + 1), with every station
    # offset (own taps only), at 8 and 1 captures over two chained blocks;
    # then K = 8 and 32 (the compiled-in 17 taps per plane) and a geometry
    # of the generic instance, on random bytes
    h_proto = np.asarray(channelizer.channelizer_taps(WB_K, 16))
    all_offsets = np.linspace(-90e3, 90e3, WB_K) + 1e3

    def k5_least_flop(k_, g_len, decim, n_sh, n_own, l_ch, l_rf):
        """FLOP per output and capture of the least exact work for g's
        stations.  g_k = up_K(h_rf rot_k) * (mod_k h_ch) factors into the
        shared bank at the slot rate (residue sums of h_ch's l_ch real taps,
        4 FLOP each, then one K-point DFT row per station, 8 K FLOP, both
        decim times per output) and a station's own l_rf-tap complex FIR
        (8 FLOP a tap); the shared stations may instead take the composed
        prototype (L real taps, then one DFT row each at the output rate)
        and an offset one its L dense complex taps (8 L)."""
        slot_bank = decim * 4 * l_ch
        two_stage = decim * 8 * k_ + 8 * l_rf        # per station
        own = min(n_own * 8 * g_len, slot_bank + n_own * two_stage) \
            if n_own else 0
        mixed = ((4 * g_len + 8 * k_ * n_sh) if n_sh else 0) + own
        return min(mixed, slot_bank + k_ * two_stage)

    def k5_nco(offs, seed):
        """The residual NCO as ``make_wideband_receiver`` builds it on the
        composed route: (phase, ramp, a block's advance), the ramp at the
        IF rate reduced mod 2 pi in float64, the phase not zero."""
        step = -2.0 * np.pi * np.asarray(offs, np.float64) / cfg.rf.fs
        ramp = np.mod((step * cfg.rf.decim)[:, None] * np.arange(
            cfg.block_size // 2 // cfg.rf.decim, dtype=np.float64),
            2.0 * np.pi)
        adv = np.mod(step * (cfg.block_size // 2), 2.0 * np.pi)
        phase = np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi,
                                                    len(step))
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (phase, ramp, adv))

    def mix_readings(k_y, r_y, m_y, nco):
        """K5 with ``mix`` against the plain version then the stock mix,
        and the elements whose bits (a zero's sign too) differ from the
        kernel's bank then the stock mix."""
        stock = channelizer.residual_mix(k_y, *nco[:2])
        bits = int((m_y.view(torch.int32) != stock.view(torch.int32)).sum())
        return max_err(m_y, channelizer.residual_mix(r_y, *nco[:2])), bits

    def k5_case(g, blocks, ncap, decim, label, timed, factors=None,
                mix_offsets=None):
        """Two chained blocks through the kernel and the plain version;
        the second timed (with the yardstick) where ``timed``; ``factors``
        (h_ch, f): g's two stages, handed to the kernel (its plan may take
        the two-stage role) and counted for the least-work bound;
        ``mix_offsets``: each station's offset, whose residual NCO the
        kernel then also turns as the receiver has it turn (a carried
        phase, checked and timed as ``kernel_mix_ms``)."""
        k_, g_len = g.shape
        g_l1 = float(np.abs(g).sum(axis=1).max())
        p_if = blocks[0].shape[-1] // 2 // (decim * k_)
        plan = channelizer.composed_plan(g, decim, factors)
        geo = (channelizer.two_stage_geometry(plan, ncap, p_if)
               if plan.two_stage
               else channelizer.composed_geometry(plan, ncap, p_if))
        d = decim * k_
        zi = channelizer.composed_zi_u8(g_len, (ncap,), dev)
        nco = None if mix_offsets is None else k5_nco(mix_offsets, k_)
        for blk in range(2):            # block 1 reads block 0's byte tail
            raw = blocks[blk][:ncap].contiguous()
            k_y, k_zi = channelizer.composed_channelize_u8(raw, g, zi, decim,
                                                           factors)
            r_y, r_zi = channelizer.composed_channelize_u8_ref(
                raw, g, zi, decim, block=32)
            errs = {"y": max_err(k_y, r_y),
                    "new_zi_bytes_differing": float((k_zi != r_zi).sum())}
            tols = {"y": TOL_K5_REL * g_l1, "new_zi_bytes_differing": 0.0}
            timing, mixed = {}, {}
            if nco is not None:
                m_y, _ = channelizer.composed_channelize_u8(
                    raw, g, zi, decim, factors, mix=nco[:2])
                errs["y_mix"], mixed["mix_bits_differing_vs_stock"] = \
                    mix_readings(k_y, r_y, m_y, nco)
                tols["y_mix"] = tols["y"]
                del m_y
            if blk == 1 and timed:
                # yardstick: one conv1d over the normalized, de-interleaved
                # input
                w = np.empty((k_, 2, 2, g_len))
                w[:, 0, 0], w[:, 0, 1] = g.real[:, ::-1], -g.imag[:, ::-1]
                w[:, 1, 0], w[:, 1, 1] = g.imag[:, ::-1], g.real[:, ::-1]
                w = torch.as_tensor(w.reshape(2 * k_, 2, g_len),
                                    dtype=torch.float32, device=dev)
                xn = ingestfir.normalize_deinterleave(
                    torch.cat([zi, raw], dim=-1)).contiguous()
                lib = F.conv1d(xn, w, stride=d).reshape(k_y.shape)
                outs = k_y.numel() // (2 * k_)       # outputs per station
                n_sh, n_own = len(plan.shared), len(plan.own)
                if plan.two_stage:
                    # the least work still counts the unshifted stations
                    n_sh = int((~factors[1].imag.any(axis=1)).sum())
                    n_own = k_ - n_sh
                lengths = (len(factors[0]), factors[1].shape[1])
                plan_bytes = sum(a.nbytes for a in (
                    plan.proto, plan.twiddle, plan.own_taps, plan.stage_a,
                    plan.stage_b) if a is not None)
                moved = nbytes(raw, zi, k_y, k_zi) + plan_bytes
                timing = dict(
                    kernel_ms=time_ms(
                        lambda: channelizer.composed_channelize_u8(
                            raw, g, zi, decim, factors)),
                    kernel_burst_ms=burst_ms(
                        lambda: channelizer.composed_channelize_u8(
                            raw, g, zi, decim, factors)),
                    **({} if nco is None else {"kernel_mix_ms": time_ms(
                        lambda: channelizer.composed_channelize_u8(
                            raw, g, zi, decim, factors, mix=nco[:2]))}),
                    plain_ms=time_ms(
                        lambda: channelizer.composed_channelize_u8_ref(
                            raw, g, zi, decim, block=32),
                        reps=2, warm=0),
                    library_ms=time_ms(lambda: F.conv1d(xn, w, stride=d)),
                    library="torch.nn.functional.conv1d (cudnn."
                            "allow_tf32=False), stride decim K, weight "
                            "(2 K, 2, L), on the normalized "
                            "de-interleaved float input",
                    library_rel_err_vs_plain=max_err(lib, r_y)
                    / float(r_y.abs().max()),
                    # bound_ms: the least exact work (k5_least_flop);
                    # beside it, the work of the routes this g takes (per
                    # output the shared route's real taps, 4 FLOP each,
                    # and DFT rows, 8 FLOP per residue and station; the
                    # own route's complex taps, 8 FLOP each; the two-stage
                    # role's slot bank and RF FIRs, as k5_least_flop counts
                    # them) and the dense form's
                    dense_bound_ms=8 * g_len * outs * k_
                    / H100_F32_FLOP_PER_S * 1e3,
                    route_bound_ms=bound(moved, outs * (
                        k5_least_flop(k_, g_len, decim, 0, k_, *lengths)
                        if plan.two_stage else
                        ((4 * g_len + 8 * k_ * n_sh) if n_sh else 0)
                        + n_own * 8 * g_len))["bound_ms"],
                    **bound(moved, outs * k5_least_flop(
                        k_, g_len, decim, n_sh, n_own, *lengths)))
                del xn, lib, w
            check("channelizer.composed",
                  f"u8 ({ncap}, {raw.shape[-1]}), K = {k_}, L = {g_len}",
                  errs, tols, captures=ncap, case=label, block=blk,
                  shared_stations=list(plan.shared),
                  own_taps_stations=list(plan.own),
                  two_stage_stations=k_ if plan.two_stage else 0,
                  tile=geo.tile,
                  taps_per_plane=plan.a_sp, sum_abs_g=g_l1,
                  y_max_abs=float(r_y.abs().max()), **timing, **mixed)
            zi = k_zi
            if nco is not None:
                nco = (torch.remainder(nco[0] + nco[2], 2.0 * np.pi),
                       *nco[1:])
        del k_y, r_y, k_zi, r_zi, raw

    for label, offs in (("no offsets", None), ("one offset", wb_offsets),
                        ("all offset", all_offsets)):
        g, factors = channelizer.composed_rf_factors(
            WB_K, h_proto, rf_h, cfg.rf.decim, offsets_hz=offs,
            fs_ch=cfg.rf.fs)
        for ncap in (WB_CAPTURES, 1):
            k5_case(g, wb_blocks, ncap, cfg.rf.decim, label, True, factors)
        torch.cuda.empty_cache()
    # the wideband cell's shape: K = 8, 128 captures of 8 x 307,200 bytes,
    # wideband8's band plan (a station a slot on the 200 kHz raster, 7 off
    # their slot's centre): the two-stage role
    cell = [torch.randint(0, 256, (128, 8 * cfg.block_size), generator=gen,
                          device=dev, dtype=torch.uint8) for _ in range(2)]
    wb8_offs = [200e3, -600e3, 800e3, -200e3, 400e3, 0.0, -800e3, 600e3]
    g, factors = channelizer.composed_rf_factors(
        8, channelizer.channelizer_taps(8, 16), rf_h, cfg.rf.decim,
        offsets_hz=wb8_offs, fs_ch=cfg.rf.fs)
    k5_case(g, cell, 128, cfg.rf.decim, "wideband8 band plan", True,
            factors, mix_offsets=wb8_offs)
    del cell
    torch.cuda.empty_cache()
    for k_ in (8, 32):
        small = [torch.randint(0, 256, (2, 2 * cfg.rf.decim * k_ * 960),
                               generator=gen, device=dev, dtype=torch.uint8)
                 for _ in range(2)]
        offs_k = np.zeros(k_)
        offs_k[k_ // 2] = WB_OFFSET_HZ
        for label, offs in (("no offsets", None), ("one offset", offs_k),
                            ("all offset", np.linspace(-90e3, 90e3, k_)
                             + 1e3)):
            g = channelizer.composed_rf_taps(
                k_, channelizer.channelizer_taps(k_, 16), rf_h,
                cfg.rf.decim, offsets_hz=offs, fs_ch=cfg.rf.fs)
            k5_case(g, small, 2, cfg.rf.decim, label, False)
    # the generic instance (taps per plane not 17): K = 3, decim 2
    g = channelizer.composed_rf_taps(3, channelizer.channelizer_taps(3, 4),
                                     np.hanning(31) / 16, 2,
                                     offsets_hz=[0.0, 1e5, 0.0],
                                     fs_ch=cfg.rf.fs)
    small = [torch.randint(0, 256, (2, 2 * 6 * 1000), generator=gen,
                           device=dev, dtype=torch.uint8) for _ in range(2)]
    k5_case(g, small, 2, 2, "one offset, generic instance", False)
    del small
    torch.cuda.empty_cache()

    # several stations a slot: K5's two-stage role over a station map, S =
    # 38 over K = 8 (every second 200 kHz channel of the band but those on
    # a slot edge, up to 5 a slot), and S = K on the identity map, 27
    # captures of 8 x 307,200 bytes, two chained blocks each, against the
    # plain version, without and with the residual NCO in its epilogue (the
    # phase carried across the blocks as the receiver carries it, against
    # the plain version then the stock mix); one launch a call; then one
    # K5 launch a step of the compiled wideband receiver with the map
    band_slots, band_offs = band38_plan(cfg)
    band_map = channelizer.station_map(8, band_slots)
    band_cap = [torch.randint(0, 256, (27, 8 * cfg.block_size),
                              generator=gen, device=dev, dtype=torch.uint8)
                for _ in range(2)]
    map_rows = []
    for label, stations, offs in (
            ("38 stations over 8 slots", band_map, band_offs),
            ("one station a slot", None,
             [200e3, -600e3, 800e3, -200e3, 400e3, 0.0, -800e3, 600e3])):
        g, factors = channelizer.composed_rf_factors(
            8, channelizer.channelizer_taps(8, 16), rf_h, cfg.rf.decim,
            offsets_hz=offs, fs_ch=cfg.rf.fs, stations=stations)
        plan = channelizer.composed_plan(g, cfg.rf.decim, factors, stations)
        geo = channelizer.two_stage_geometry(plan, 27, cfg.block_size // 2
                                             // cfg.rf.decim)
        g_l1 = float(np.abs(g).sum(axis=1).max())
        zi = channelizer.composed_zi_u8(g.shape[1], (27,), dev)
        nco = k5_nco(offs, g.shape[0])

        def off_by(launches):
            return float(abs(launches.get(
                "channelizer.composed_two_stage", 0) - 1) + sum(
                v for n_, v in launches.items()
                if n_ != "channelizer.composed_two_stage"))

        for blk in range(2):
            _cuda.reset_launch_counts()
            k_y, k_zi = channelizer.composed_channelize_u8(
                band_cap[blk], g, zi, cfg.rf.decim, factors, stations)
            launches = _cuda.launch_counts()
            _cuda.reset_launch_counts()
            m_y, m_zi = channelizer.composed_channelize_u8(
                band_cap[blk], g, zi, cfg.rf.decim, factors, stations,
                nco[:2])
            m_launches = _cuda.launch_counts()
            r_y, r_zi = channelizer.composed_channelize_u8_ref(
                band_cap[blk], g, zi, cfg.rf.decim, block=32,
                stations=stations)
            y_mix, bits = mix_readings(k_y, r_y, m_y, nco)
            timing = {}
            if blk == 1:
                # kernel_ms: K5 as the receiver runs it, with the NCO;
                # bank_kernel_ms: without it
                timing = {
                    "kernel_ms": time_ms(
                        lambda: channelizer.composed_channelize_u8(
                            band_cap[blk], g, zi, cfg.rf.decim, factors,
                            stations, nco[:2])),
                    "bank_kernel_ms": time_ms(
                        lambda: channelizer.composed_channelize_u8(
                            band_cap[blk], g, zi, cfg.rf.decim, factors,
                            stations))}
            map_rows.append(check(
                "channelizer.composed_stations",
                f"u8 (27, {8 * cfg.block_size}), K = 8, S = {g.shape[0]}",
                {"y": max_err(k_y, r_y), "y_mix": y_mix,
                 "new_zi_bytes_differing": float((k_zi != r_zi).sum()
                                                 + (m_zi != r_zi).sum()),
                 "launches_off_by": off_by(launches) + off_by(m_launches)},
                {"y": TOL_K5_REL * g_l1, "y_mix": TOL_K5_REL * g_l1,
                 "new_zi_bytes_differing": 0.0, "launches_off_by": 0.0},
                case=label, block=blk, stations=g.shape[0],
                per_slot=1 if stations is None else stations.per_slot,
                tile=geo.tile, ns=geo.ns, smem=geo.smem, sum_abs_g=g_l1,
                mix_bits_differing_vs_stock=bits, **timing))
            zi = k_zi
            nco = (torch.remainder(nco[0] + nco[2], 2.0 * np.pi), *nco[1:])
        del k_y, r_y, k_zi, r_zi, m_y, m_zi
    del band_cap
    torch.cuda.empty_cache()
    b_init, b_step = jit_mod.jit_step(*make_wideband_receiver(
        cfg, 8, (2,), channel_offsets_hz=band_offs, channel_slots=band_slots,
        enable_rds=False, device=dev), dev, name="wideband receiver, band38")
    b_state = b_init()
    b_raw = torch.randint(0, 256, (2, 8 * cfg.block_size), generator=gen,
                          device=dev, dtype=torch.uint8)
    for _ in range(2):                  # the capture's step, then a replay
        b_state, b_out = b_step(b_state, b_raw)
    _cuda.reset_launch_counts()
    for _ in range(3):
        b_state, b_out = b_step(b_state, b_raw)
    torch.cuda.synchronize()
    b_counts = _cuda.launch_counts()
    if (b_counts.get("channelizer.composed_two_stage") != 3
            or tuple(b_out.left.shape) != (2, 38, cfg.audio_len)
            or not bool(torch.isfinite(b_out.left).all())):
        emit({"k5_station_map_failed": {"launches": b_counts,
                                        "left": list(b_out.left.shape)}})
        raise SystemExit("chip_smoke: the band38 receiver's step is not "
                         "one K5 launch a step")
    emit({"k5_station_map": {
        "cases": [{k: r[k] for k in ("case", "block", "errors", "tolerances",
                                     "stations", "per_slot", "tile", "ns",
                                     "smem", "mix_bits_differing_vs_stock",
                                     "kernel_ms", "bank_kernel_ms")
                   if k in r} for r in map_rows],
        "receiver_launches_3_steps": b_counts}, "card": card})
    del b_state, b_out, b_raw, b_step
    torch.cuda.empty_cache()

    # MODE1 / MODE1_RDS: the receiver's own calls of the fm ingest entry
    # (320,000-byte blocks) and of the mixer + resampler + RRC kernel
    # (x57/250, 9,003 taps, 16,000 -> 3,648) in its second step, i.e. with
    # real mid-stream states, repeated on the plain versions
    m1_station = fm_multiplex_iq(
        N_MODE1_RDS_STREAM_BLOCKS * MODE1.iq_len, MODE1.rf.fs,
        rds_wave=rds_baseband(encode_rds_blocks(ps_station_words(
            N_MODE1_RDS_STREAM_BLOCKS + 4, MODE1_PI, MODE1_PS)))
    ).reshape(N_MODE1_RDS_STREAM_BLOCKS, MODE1.block_size)
    m1_dev = torch.as_tensor(m1_station[:N_MODE1_BATCH_STEPS]).to(dev)

    def m1_block(b: int, c: int = N_BATCH_CHANNELS) -> torch.Tensor:
        """(c, 320000) u8: row 0 the station, the others under +-8 LSB."""
        rows = m1_dev[b].expand(c, -1).to(torch.int16)
        noise = torch.randint(-8, 9, rows.shape, generator=gen, device=dev,
                              dtype=torch.int16)
        noise[0] = 0
        return (rows + noise).clamp_(0, 255).to(torch.uint8)

    def calls_of(targets, run):
        """Run ``run()`` with each (module, name) of ``targets`` wrapped so
        that the arguments of every call are kept, by parameter name and
        with the defaults filled in: name -> [arguments, ...]."""
        seen = {}
        saved = [(m, n, getattr(m, n)) for m, n in targets]

        def keeping(n, f):
            sig = inspect.signature(f)

            def call(*a, **k):
                args = sig.bind(*a, **k)
                args.apply_defaults()
                seen.setdefault(n, []).append(dict(args.arguments))
                return f(*a, **k)
            return call

        try:
            for m, n, f in saved:
                setattr(m, n, keeping(n, f))
            run()
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
        return seen

    # every place a receiver step reaches a kernel wrapper from
    WRAPPERS = [(frontend_mod, "ingest_fir_demod"),
                (cuda_fir, "fir_bank_carried"),
                (audio_mod, "fir_bank_carried"),
                (cuda_pll, "pll_cuda"),
                (rds_mod, "resample_mul2_rrc")]

    def third_step_calls(init, step, block):
        """The wrappers' calls in the third step of a receiver: every
        carried state is a mid-stream one, the loops are past acquiring.
        The receiver steps eagerly (``jit=False``): a replayed graph runs
        no Python, so it calls no wrapper."""
        st = init()
        for b in range(2):
            st, _ = step(st, block(b))
        return calls_of(WRAPPERS, lambda: step(st, block(2)))

    def resample_case(a, n_rds_out, **extra):
        k = cuda_resample.resample_mul2_rrc(**a)
        r = cuda_resample.resample_mul2_rrc_ref(**a)
        scale = float(r[0].abs().max())
        x = a["extract"]
        lanes = x.numel() // x.shape[-1]
        check("resample_rrc", f"3 x f32 {shape_of(x)}",
              {n: max_err(p, q) for n, p, q in
               zip(("rrc", "new_zi", "new_rrc_zi"), k, r)},
              {"rrc": TOL_RRC_REL * scale, "new_zi": 0.0,
               "new_rrc_zi": TOL_RRC_REL * scale},
              block=2, up=a["up"], down=a["down"], taps=len(a["h"]),
              rrc_max_abs=scale,
              carried_zi_max_abs=float(a["zi"].abs().max()),
              kernel_ms=time_ms(
                  lambda: cuda_resample.resample_mul2_rrc(**a)),
              plain_ms=time_ms(
                  lambda: cuda_resample.resample_mul2_rrc_ref(**a),
                  reps=2, warm=0),
              library_ms=None,
              **bound(nbytes(x, a["nco_i"], a["nco_q"], a["zi"],
                             a["rrc_zi"], *k),
                      lanes * 2 * n_rds_out * 2
                      * (-(-len(a["h"]) // a["up"]) + len(a["rrc_h"]))
                      + lanes * 2 * x.shape[-1] * 2),
              **extra)

    replayed = set()

    def pll_label(x):
        x0 = x[0] if isinstance(x, tuple) else x
        label = "(" + ", ".join(map(str, x0.shape[:-1])) + ", N)"
        return f"{len(x)} parts of {label}" if isinstance(x, tuple) else label

    def replay(seen, gate=None, done=replayed, pick=0, **extra):
        """Each distinct FIR-bank, PLL and resampler call among ``seen``
        once more on the kernel and on its plain version: the ``pick``-th
        call of each kind (the spread route makes one per time shard)."""
        kinds = {}
        for a in seen.get("fir_bank_carried", []):
            kinds.setdefault(("fir_bank", a["pre"], len(a["h_list"]),
                              a["stride"], tuple(a["x"].shape)), []).append(a)
        for a in seen.get("pll_cuda", []):
            x = a["x"]
            kinds.setdefault(
                ("pll", pll_label(x),
                 (x[0] if isinstance(x, tuple) else x).shape[-1],
                 a["loop_div"]), []).append(a)
        for a in seen.get("resample_mul2_rrc", []):
            kinds.setdefault(("resample_rrc", tuple(a["extract"].shape),
                              a["up"]), []).append(a)
        for key, calls in kinds.items():
            if key in done:
                continue
            done.add(key)
            a = dict(calls[min(pick, len(calls) - 1)])
            if key[0] == "fir_bank":
                bank_case(a["pre"], a["h_list"], a["stride"], a["x"],
                          a["x2"], a["zi"], **extra)
            elif key[0] == "pll":
                x, st, div = a.pop("x"), a.pop("state"), a.pop("loop_div")
                pll_case(key[1], x, st, div, gate=gate, extra=extra, **a)
            else:
                resample_case(
                    a, a["extract"].shape[-1] * a["up"] // a["down"],
                    **extra)

    cfg1 = MODE1_RDS
    comb1_h = composed_resampler_taps(cfg1)
    for c in (N_BATCH_CHANNELS, 1):
        rx = Receiver(cfg1, (c,), enable_frame=False, jit=False)
        seen = third_step_calls(rx.init, rx.step, lambda b: m1_block(b, c))
        (fa,) = seen["ingest_fir_demod"]
        fargs = tuple(fa.values())
        k = ingestfir.ingest_fir_demod(*fargs)
        r = ingestfir.ingest_fir_demod_ref(*fargs)
        names = ("fm", "zi_i", "zi_q", "prev_i", "prev_q")
        raw = fargs[0]
        check("ingest.fm", f"u8 ({c}, {cfg1.block_size})",
              {n: max_err(a, b) for n, a, b in zip(names, k, r)},
              dict(zip(names, (TOL_FM,) + (TOL_STATE,) * 4)), mode=1,
              kernel_ms=time_ms(lambda: ingestfir.ingest_fir_demod(*fargs)),
              plain_ms=time_ms(lambda: ingestfir.ingest_fir_demod_ref(*fargs),
                               reps=2, warm=0),
              library_ms=None,
              **bound(nbytes(raw, *fargs[2:6], *k),
                      c * cfg1.if_len * (2 * 2 * taps + 8)))
        (ra,) = seen["resample_mul2_rrc"]
        assert (len(ra["h"]) == len(comb1_h) == 9003
                and (ra["up"], ra["down"]) == (57, 250))
        # the band-pass bank (3 filters) and the squared band-pass over
        # 16,000 samples (a ragged last tile of the kernel's 1,024), the
        # pilot + carrier loop pair, the x57/250 resampler
        replay(seen, mode=1)
        # the audio-only receiver: pilot + stereo band-passes (2 filters),
        # the pilot loop alone
        rx = Receiver(MODE1, (c,), enable_rds=False, jit=False)
        replay(third_step_calls(rx.init, rx.step, lambda b: m1_block(b, c)),
               mode=1)
        del rx, seen, fa, ra, fargs, k, r, raw
        torch.cuda.empty_cache()

    # the wideband receiver's own calls at 8 captures x 16 slots: after the
    # composed channelizer (band-pass bank, mono low-pass at stride 5, the
    # squared band-pass, the stereo mixer + low-pass, the loop pair, the
    # resampler), and the RF low-pass at stride 10 that follows the
    # two-stage channelizer.  A loop with no carrier to lock to wanders
    # across its detector's +-pi seam, where two roundings of one angle
    # legitimately part: the loop pair is held to its tolerance in the
    # lanes that have a carrier (a pilot; an RDS subcarrier).
    wb_gate = torch.zeros((2, WB_CAPTURES, WB_K), dtype=torch.bool,
                          device=dev)
    for slot, (kw, rds) in WB_BAND.items():
        wb_gate[0, :, slot] = bool(kw.get("pilot_amp", 0.1))
        wb_gate[1, :, slot] = rds is not None
    for impl in ("composed", "pfb"):
        w_init, w_step = make_wideband_receiver(
            cfg, WB_K, (WB_CAPTURES,), channelizer_impl=impl,
            channel_offsets_hz=wb_offsets, resync=True)
        replay(third_step_calls(w_init, w_step, lambda b: wb_blocks[b]),
               gate=wb_gate, path=f"wideband, {impl}")
        del w_init, w_step
        torch.cuda.empty_cache()
    # the band scanner's own call: the RF low-pass at stride 10 over the
    # two-stage channelizer's (16, 2, 153600) output of one capture
    sc_init, sc_step = make_band_scanner(cfg, WB_K)
    _, st = sc_step(sc_init(), wb_dev[0])
    replay(calls_of(WRAPPERS, lambda: sc_step(st, wb_dev[1])), path="scan")
    del st
    torch.cuda.empty_cache()

    # ---- 1c. the time-sharded receiver's own calls of K6 (mixers +
    # resampler, B7) and of K1's iq entry in its segmented form, in its
    # third step (real mid-stream states; shards >= 1 read their left
    # neighbour's inputs as their halo): MODE0 at T = 1 (1,024 x 15,360) and at
    # T = 4 (4 x 1,024 stacked rows of 3,840; every arm of K6, and K1
    # over 1,024 rows of 4 segments of 76,800 bytes, read in place),
    # MODE1_RDS at T = 4
    # (x57/250, 9,003 taps, 4 x 1,024 x 4,000)
    TS_WRAPPERS = [(timeshard_mod, "resample_mul2"),
                   (timeshard_mod, "ingest_fir_decimate")]
    mix_names = ("extract", "nco_i", "nco_q", "h", "zi", "up", "down",
                 "gain", "segments")
    mix_count = {"auto": "resample_mix", "pair": "resample_mix.pair",
                 "split": "resample_mix.split"}

    def mix_case(a, impl="auto", rows_form=False, **extra):
        """The receiver's call of K6 (the segmented form over its stacked
        chunks, or one spread shard's call behind its halo zi) once more on
        the kernel and its plain version; with ``rows_form`` the stacked
        chunks as (T*C, n) rows behind the halo zi built in stock ops (the
        unsegmented form, the parent's route)."""
        a = {n: a[n] for n in mix_names}
        t_sh = a["segments"]
        if rows_form:
            x = a["extract"]
            halo = cuda_resample._segment_halo(
                x, a["nco_i"], a["nco_q"], a["zi"], len(a["h"]) - 1, a["up"])
            a = dict(a, segments=None, zi=halo.reshape(-1, *halo.shape[-2:]),
                     **{n: a[n].reshape(-1, x.shape[-1])
                        for n in ("extract", "nco_i", "nco_q")})
            del halo
        plain = (cuda_resample.resample_mul2_ref if a["segments"] is None
                 else cuda_resample.resample_mul2_segments_ref)
        pa = {n: v for n, v in a.items() if n != "segments"}
        k = cuda_resample.resample_mul2(**a, impl=impl)
        r = plain(**pa)
        scale = float(r[0].abs().max())
        x, taps_ = a["extract"], len(a["h"])
        lanes, n = x.numel() // x.shape[-1], x.shape[-1]
        check(mix_count[impl], f"3 x f32 {shape_of(x)}",
              {"y": max_err(k[0], r[0]), "new_zi": max_err(k[1], r[1])},
              {"y": TOL_RESAMP_REL * scale, "new_zi": 0.0},
              form="rows" if rows_form else "segmented" if t_sh else "zi",
              time_shards=extra.pop("time_shards", t_sh),
              up=a["up"], down=a["down"], taps=taps_, y_max_abs=scale,
              carried_zi_max_abs=float(a["zi"].abs().max()),
              kernel_ms=time_ms(
                  lambda: cuda_resample.resample_mul2(**a, impl=impl)),
              kernel_burst_ms=burst_ms(
                  lambda: cuda_resample.resample_mul2(**a, impl=impl)),
              plain_ms=time_ms(lambda: plain(**pa), reps=2, warm=0),
              library_ms=None,
              # per output and branch the taps that meet a sample; 2
              # multiplies per mixed sample
              **bound(nbytes(x, a["nco_i"], a["nco_q"], a["zi"], *k),
                      lanes * 2 * k[0].shape[-1] * 2 * -(-taps_ // a["up"])
                      + lanes * 2 * n * 2), **extra)
        del k, r

    def ts_third_step_calls(cfg_, t_shards, block, **kw):
        init, step = make_time_sharded_receiver(
            cfg_, make_mesh(1, t_shards, devices=[dev]),
            N_BATCH_CHANNELS, jit=False, **kw)
        st = init()
        for b in range(2):
            st, _ = step(st, block(b))
        return calls_of(TS_WRAPPERS, lambda: step(st, block(2)))

    for t_shards in (1, 4):
        seen = ts_third_step_calls(cfg, t_shards, batch_block)
        (ma,) = seen["resample_mul2"]
        assert ma["segments"] == t_shards
        for impl in ("auto", "pair", "split"):
            mix_case(ma, impl)
        mix_case(ma, rows_form=True)
        if t_shards == 4:
            (ia,) = seen["ingest_fir_decimate"]
            assert ia["segments"] == t_shards
            ingest_iq_case(ia["raw_u8"], ia["zi_i"], ia["zi_q"], t_shards,
                           time_shards=t_shards)
        del seen, ma
        torch.cuda.empty_cache()
    # the spread route's own calls at T = 4, C = 1,024 (one stream per
    # shard on this card), third step, shard 1's of each kind (its inputs
    # handed over from shard 0): K1's iq entry on its chunk (1,024 x 76,800
    # bytes) behind shard 0's raw tail normalized as its zi, K6 on its
    # (1,024 x 3,840) behind shard 0's zero-stuffed mixed tail as its zi
    # (the tail in stock ops, as the route makes it), K2's band-pass bank,
    # squared band-pass, mono / stereo low-pass at stride 5 and RRC over
    # (1,024, 3,840) rows, and K3's loop pair over 2 parts of (1,024, 3,840)
    # from shard 0's end state (exact) and from the extrapolated one (stale)
    sp_mesh = make_mesh(1, 4, devices=[dev] * 4)
    sp_wrappers = TS_WRAPPERS + [(timeshard_mod, "fir_bank_carried"),
                                 (cuda_fir, "fir_bank_carried"),
                                 (cuda_pll, "pll_cuda")]
    for handoff in ("exact", "stale"):
        # eager: a replayed graph calls no wrapper
        init, step = make_time_sharded_receiver(
            cfg, sp_mesh, N_BATCH_CHANNELS, pll_handoff=handoff, jit=False)
        st = init()
        for b in range(2):
            st, _ = step(st, batch_block(b))
        seen = calls_of(sp_wrappers, lambda: step(st, batch_block(2)))
        torch.cuda.synchronize()
        assert len(seen["pll_cuda"]) == 4
        on = dict(route="spread", shard=1, time_shards=4,
                  pll_handoff=handoff)
        if handoff == "exact":
            assert [a["segments"] for a in seen["resample_mul2"]] == [
                None] * 4
            mix_case(seen["resample_mul2"][1], rows_form=False, **on)
            ia = seen["ingest_fir_decimate"][1]
            assert ia["segments"] is None
            ingest_iq_case(ia["raw_u8"], ia["zi_i"], ia["zi_q"], **on)
            replay(seen, done=set(), pick=1, **on)
            del ia
        else:
            replay({"pll_cuda": seen["pll_cuda"]}, done=set(), pick=1, **on)
        del seen, st, init, step
        torch.cuda.empty_cache()
    seen = ts_third_step_calls(cfg1, 4, m1_block, enable_frame=False)
    (ma,) = seen["resample_mul2"]
    assert len(ma["h"]) == 9003 and (ma["up"], ma["down"]) == (57, 250)
    for impl in ("auto", "pair", "split"):
        mix_case(ma, impl, mode=1)
    mix_case(ma, rows_form=True, mode=1)
    del seen, ma
    torch.cuda.empty_cache()

    # ---- 1d. the resync walk (K7) against its plain version, W = 77 (the
    # MODE0 and MODE1_RDS frame), at the lanes of SYNC_WALK_CASES, with
    # repairs and without: every output equal (integers and flags); the
    # inputs reach every branch of the walk (checked on the plain outputs)
    w_max = frame_mod.frame_sizes(cfg)[3]
    sm_clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True
    ).stdout.split()[0]) * 1e6
    for batch, seed in SYNC_WALK_CASES:
        lanes = int(np.prod(batch))
        host = sync_walk_inputs(np.random.default_rng(seed), lanes, w_max)
        a = {k: torch.as_tensor(v.reshape(batch + v.shape[1:])).to(dev)
             for k, v in host.items()}
        for repairs in (True, False):
            corr = a["corr"] if repairs else None
            args = (a["sid"], a["w_valid"], a["base_pos"],
                    a["last_position"], a["bad_count"])
            got = cuda_sync.sync_walk(*args, corr=corr)
            ref = frame_mod._walk_plain(
                *args, corr if repairs else torch.zeros_like(a["w_valid"]))
            names = ("is_sync", "is_false_pos", "is_resync", "new_last",
                     "new_bad")
            if any(g.dtype != r.dtype or g.shape != r.shape
                   for g, r in zip(got, ref)):
                raise SystemExit("chip_smoke: sync_walk's outputs are not "
                                 "its plain version's dtypes and shapes")
            sync_, fp_, fire_ = (r.cpu().numpy() for r in ref[:3])
            valid_h = host["w_valid"].reshape(sync_.shape)
            corr_h = host["corr"].reshape(sync_.shape)
            reached = {
                "anchor from unsynced": bool((sync_ & (host[
                    "last_position"].reshape(batch) < 0)[..., None]).any()),
                "sync": bool(sync_.any()),
                "false positive": bool(fp_.any()),
                "resync": bool(fire_.any()),
                "cut tail": bool((~valid_h).any())}
            if repairs:
                reached["repair accepted"] = bool((sync_ & corr_h).any())
                reached["repair refused"] = bool(
                    (~sync_ & corr_h & valid_h).any())
            if not all(reached.values()):
                raise SystemExit(f"chip_smoke: sync_walk inputs {batch} "
                                 f"reach too few branches: {reached}")
            check("sync_walk", f"i32 {shape_of(a['sid'])}",
                  {n: max_err(g, r) for n, g, r in zip(names, got, ref)},
                  dict.fromkeys(names, 0.0), lanes=lanes, windows=w_max,
                  repairs=repairs, seed=seed, branches_reached=reached,
                  # the kernel's device time (profiler): events around a
                  # call time its wrapper's host work, tens of us
                  kernel_ms=profiled_device_ms(
                      lambda: cuda_sync.sync_walk(*args, corr=corr)),
                  events_ms=time_ms(
                      lambda: cuda_sync.sync_walk(*args, corr=corr)),
                  kernel_burst_ms=burst_ms(
                      lambda: cuda_sync.sync_walk(*args, corr=corr)),
                  plain_ms=time_ms(
                      lambda: frame_mod._walk_plain(
                          *args, corr if repairs else
                          torch.zeros_like(a["w_valid"])), reps=3, warm=1),
                  library_ms=None,
                  chain_bound_ms=w_max * SYNC_WALK_CHAIN_CYCLES
                  / sm_clock * 1e3, sm_clock_max_hz=sm_clock,
                  # ~14 integer operations per window
                  **bound(nbytes(*args, corr, *got), lanes * w_max * 14))
        del a, got, ref
    # on-card integers of another width raise, launching nothing
    walk64 = torch.zeros((2, w_max), dtype=torch.int64, device=dev)

    emit({"kernel_cases": cases, "card": card})
    torch.cuda.empty_cache()

    # nothing with a kernel computes its plain version on the card: what the
    # kernels cannot take (float64) raises, per function and per pipeline
    x64 = torch.zeros((2, 600), dtype=torch.float64, device=dev)
    zi64 = torch.zeros((2, taps - 1), dtype=torch.float64, device=dev)
    refusals = {
        "fir_block": lambda: fir.fir_block(x64, mono_h, zi64),
        "fir_decimate": lambda: fir.fir_decimate(x64, mono_h, zi64, 5),
        "fir_bank_carried": lambda: cuda_fir.fir_bank_carried(
            x64, [mono_h], zi64),
        "pll": lambda: pll(x64, pll_init((2,), torch.float64, dev), **pkw),
        "resample_mul2_rrc": lambda: cuda_resample.resample_mul2_rrc(
            x64, x64, x64, mono_h, torch.stack([zi64, zi64], 1), mono_h,
            torch.stack([zi64, zi64], 1), 1, 2),
        "resample_mul2": lambda: cuda_resample.resample_mul2(
            x64, x64, x64, mono_h, torch.stack([zi64, zi64], 1), 1, 2),
        "Receiver": lambda: Receiver(cfg, (), torch.float64),
        "make_time_sharded_receiver": lambda: make_time_sharded_receiver(
            cfg, make_mesh(1, 2, devices=[dev]), 1, torch.float64),
        "sync_walk (int64)": lambda: frame_mod.resolve_sync(
            walk64, walk64 > 0, walk64[:, 0], walk64[:, 0], walk64[:, 0],
            resync=True),
    }
    before = _cuda.launch_counts()
    for name, call in refusals.items():
        try:
            call()
        except TypeError:
            continue
        raise SystemExit(f"chip_smoke: {name} took float64 on the card "
                         "instead of raising")
    if _cuda.launch_counts() != before:
        raise SystemExit("chip_smoke: a refused call launched a kernel")
    emit({"refused_float64_on_card": sorted(refusals), "card": card})

    # ------------------------------------------------------- shared checks
    here = os.path.dirname(os.path.abspath(__file__))

    def run_cli(iq_path, *flags, mode="0", cwd=here):
        env = dict(os.environ)
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        with open(iq_path, "rb") as f:
            return subprocess.run(
                [sys.executable, "-m", "rtsdr_tpu_torch.cli", mode, *flags],
                stdin=f, capture_output=True, timeout=600, cwd=cwd, env=env)

    def tone_amplitudes(pcm):
        """Tone fits over all but the first block of int16 stereo bytes."""
        lr = np.frombuffer(pcm, np.int16).reshape(-1, 2)[n_audio:] / 16384.0
        t = np.arange(lr.shape[0]) / cfg.audio_fs

        def tone(x, hz):
            return 2.0 * float(np.hypot(
                np.mean(x * np.sin(2 * np.pi * hz * t)),
                np.mean(x * np.cos(2 * np.pi * hz * t))))

        amps = {"mono_1100Hz_in_L+R": tone(lr[:, 0] + lr[:, 1], 1.1e3),
                "stereo_2300Hz_in_L-R": tone(lr[:, 0] - lr[:, 1], 2.3e3),
                "leak_2300Hz_in_L+R": tone(lr[:, 0] + lr[:, 1], 2.3e3)}
        if not (abs(amps["mono_1100Hz_in_L+R"] - 0.88) < 0.088
                and abs(amps["stereo_2300Hz_in_L-R"] - 0.83) < 0.083
                and amps["leak_2300Hz_in_L+R"] < 0.02):
            raise SystemExit(f"chip_smoke: stream tones are off: {amps}")
        return amps

    TONES_EXPECTED = {"mono": 0.88, "stereo": 0.83, "leak_below": 0.02,
                      "within": "10%"}

    def stream_phase(n_blocks, rds: bool, cfg=cfg, station=station,
                     mode="0", pi=STATION_PI, ps=STATION_PS):
        """``n_blocks`` of ``station`` through StreamRunner at C = 1 and
        through the CLI as a subprocess; returns the phase's report."""
        lines, chunks = [], []
        dec = GroupDecoder()

        def hook(fo):
            for g in dec.feed(fo):
                lines.append(format_group(g, dec.pty_table))

        with tempfile.TemporaryDirectory() as tmp:
            iq_path = os.path.join(tmp, "station.iq")
            station[:n_blocks].tofile(iq_path)
            # the CLI's own settings (its --resync default is on)
            runner = (StreamRunner(cfg, resync=True) if rds
                      else StreamRunner(cfg, enable_rds=False))
            with open(iq_path, "rb") as f:
                t0 = time.perf_counter()
                stats = runner.run(f.fileno(), emit=chunks.append,
                                   rds_log=lines.append, frame_hook=hook)
                stream_s = time.perf_counter() - t0
            flags = ("--rds-groups",) if rds else ("--no-rds",)
            if rds and mode == "1":
                flags += ("--rds",)
            cli = run_cli(iq_path, *flags, mode=mode)
        pcm = b"".join(chunks)
        expect_bytes = n_blocks * n_audio * 4
        if stats["blocks"] != n_blocks or len(pcm) != expect_bytes:
            raise SystemExit(f"chip_smoke: stream wrote {len(pcm)} bytes in "
                             f"{stats['blocks']} blocks, expected "
                             f"{expect_bytes}")
        cli_lines = cli.stderr.decode().splitlines()
        summary_at = next((i for i, ln in enumerate(cli_lines)
                           if ln.startswith("processed ")), len(cli_lines))
        if (cli.returncode != 0 or cli.stdout != pcm
                or cli_lines[:summary_at] != lines):
            raise SystemExit(
                "chip_smoke: the CLI subprocess failed, or its bytes or its "
                f"stderr lines differ from StreamRunner's (rc "
                f"{cli.returncode}, {len(cli.stdout)} bytes, "
                f"{summary_at} lines vs {len(lines)}): "
                f"{cli.stderr.decode()[-2000:]}")
        report = {"blocks": n_blocks, "channels": 1, "bytes_out": len(pcm),
                  "tone_amplitudes": tone_amplitudes(pcm),
                  "expected": TONES_EXPECTED,
                  "ms_per_64ms_block": stream_s * 1e3 / n_blocks,
                  "cli_bytes_identical": True}
        if rds:
            report.update({
                "rds_syncs": stats["rds_events"],
                "rds_false_positives": stats["rds_false_positives"],
                "min_syncs": MIN_STREAM_SYNCS,
                "max_false_positives": MAX_STREAM_FALSE_POSITIVES,
                "groups": len(dec.groups),
                "decoded_pi": None if dec.pi is None else f"0x{dec.pi:04X}",
                "decoded_ps": dec.ps_name,
                "encoded_pi": f"0x{pi:04X}",
                "encoded_ps": ps,
                "cli_stderr_lines_identical": summary_at,
                "cli_summary": cli_lines[summary_at:]})
        return report

    def batch_phase(rxb, rx1, n_steps, block_fn=batch_block):
        """Step ``rxb`` (1024 channels) and its C = 1 twin on row 0."""
        cfg = rxb.cfg
        st_b, st_1 = rxb.init(), rx1.init()
        step_ms, row0_err, finite, peak, twin = [], 0.0, True, 0, []
        frames_equal = True
        for b in range(n_steps):
            raw = block_fn(b)
            torch.cuda.synchronize()
            # peak while stepping: state, this block's input and outputs,
            # the step's intermediates (not the scratch the input was made
            # with)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            st_b, out_b = rxb.step(st_b, raw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated())
            st_1, out_1 = rx1.step(st_1, raw[0])
            twin.append((out_1.left.cpu().numpy(), out_1.right.cpu().numpy(),
                         out_1.rds))
            for a, r in ((out_b.left, out_1.left), (out_b.right, out_1.right),
                         (out_b.mono, out_1.mono)):
                finite = finite and bool(torch.isfinite(a).all())
                if tuple(a.shape) != (N_BATCH_CHANNELS, n_audio):
                    raise SystemExit(f"chip_smoke: batch output {a.shape}")
                row0_err = max(row0_err, max_err(a[0], r))
            if out_b.rds is not None:
                for name, a, r in zip(out_b.rds._fields, out_b.rds,
                                      out_1.rds):
                    if a.dtype.is_floating_point:
                        finite = finite and bool(torch.isfinite(a).all())
                        row0_err = max(row0_err, max_err(a[0], r))
                    else:
                        frames_equal = frames_equal and torch.equal(a[0], r)
        steady = statistics.median(step_ms[1:])
        report = {"channels": N_BATCH_CHANNELS, "steps": n_steps,
                  "bytes_per_step": N_BATCH_CHANNELS * cfg.block_size,
                  "finite": finite, "row0_max_abs_err_vs_c1": row0_err,
                  "row0_tolerance": TOL_ROW0,
                  "row0_frame_integers_equal": frames_equal,
                  "step_ms": step_ms, "ms_per_step_median": steady,
                  "realtime_multiple": N_BATCH_CHANNELS * 64.0 / steady,
                  "max_memory_allocated_bytes": peak}
        if not finite or not row0_err <= TOL_ROW0 or not frames_equal:
            raise SystemExit(f"chip_smoke: batch outputs wrong: {report}")
        return report, twin, out_b

    def runner_phase(n_blocks, twin, rds: bool):
        """The --stations path: one capture file per station (the 16
        noiseless variants; station 0 is the C = 1 twin's input), one reader
        thread per file, pinned (N, block) staging, one batched step per
        block."""
        got = [[] for _ in range(N_RUNNER_STATIONS)]
        frames = [[] for _ in range(N_RUNNER_STATIONS)]
        with tempfile.TemporaryDirectory() as tmp:
            files = []
            for c in range(N_RUNNER_STATIONS):
                path = os.path.join(tmp, f"station{c}.iq")
                variants_host[:n_blocks, c].tofile(path)
                files.append(open(path, "rb"))
            try:
                kw = {} if rds else {"enable_rds": False}
                with BatchRunner(cfg, [f.fileno() for f in files],
                                 **kw) as runner:
                    t0 = time.perf_counter()
                    rstats = runner.run(
                        emit=lambda c, left, right: got[c].append(
                            (left.copy(), right.copy())),
                        rds_hook=(lambda c, fo: frames[c].append(
                            type(fo)(*(np.array(x) for x in fo))))
                        if rds else None)
                    runner_s = time.perf_counter() - t0
            finally:
                for f in files:
                    f.close()
        if (rstats != {"blocks": n_blocks, "stations": N_RUNNER_STATIONS}
                or any(len(g) != n_blocks for g in got)
                or (rds and any(len(f) != n_blocks for f in frames))):
            raise SystemExit(f"chip_smoke: BatchRunner stats {rstats}, blocks "
                             f"emitted per station {[len(g) for g in got]}")
        finite = all(np.isfinite(a).all() and a.shape == (n_audio,)
                     for g in got for lr_ in g for a in lr_)
        err = max(float(np.abs(a - r).max())
                  for b in range(n_blocks)
                  for a, r in zip(got[0][b], twin[b][:2]))
        # the stations differ, so no two rows may carry the same audio
        distinct = len({got[c][-1][0].tobytes()
                        for c in range(N_RUNNER_STATIONS)})
        report = {"stations": N_RUNNER_STATIONS, "blocks": n_blocks,
                  "finite": finite, "station0_max_abs_err_vs_c1": err,
                  "station0_tolerance": TOL_ROW0,
                  "distinct_stations": distinct,
                  "ms_per_block": runner_s * 1e3 / n_blocks}
        ok = finite and err <= TOL_ROW0 and distinct == N_RUNNER_STATIONS
        if rds:
            # station 0's frame outputs are the twin's; every station's
            # windows are counted, shaped per station
            same = all(
                np.array_equal(getattr(frames[0][b], name),
                               getattr(twin[b][2], name).cpu().numpy())
                for b in range(n_blocks)
                for name in ("n_windows", "syndrome_id", "is_sync",
                             "positions", "info_word"))
            shapes = all(fo.syndrome_id.shape == (77,) and fo.n_windows.shape
                         == () for fr in frames for fo in fr)
            report.update({"rds_hook_calls": sum(len(f) for f in frames),
                           "station0_frames_equal_c1": same,
                           "per_station_shapes": shapes,
                           "syncs_per_station": [
                               int(sum(fo.is_sync.sum() for fo in fr))
                               for fr in frames]})
            ok = ok and same and shapes
        if not ok:
            raise SystemExit(f"chip_smoke: BatchRunner outputs wrong: "
                             f"{report}")
        return report

    def expect_counts(window, steps, per_step, walks=0):
        """``walks``: the resync walk's launches in the window (one per
        step of each receiver with ``resync`` on)."""
        counts = _cuda.launch_counts()
        expected = {k: v * steps for k, v in per_step.items()}
        if walks:
            expected["sync_walk"] = walks
        if counts != expected:
            raise SystemExit(f"chip_smoke: launch counts {counts} on the "
                             f"{window} path, expected {expected}")
        return counts

    # --------------------------------- warm-up outside the counted windows
    rx1a = Receiver(cfg, (), enable_rds=False)
    rxba = Receiver(cfg, (N_BATCH_CHANNELS,), enable_rds=False)
    rx1 = Receiver(cfg, ())
    rxb = Receiver(cfg, (N_BATCH_CHANNELS,))
    for one, many in ((rx1a, rxba), (rx1, rxb)):
        st = one.init()
        for b in range(2):
            st, _ = one.step(st, torch.as_tensor(station[b]).to(dev))
        many.step(many.init(), batch_block(0))
    torch.cuda.synchronize()

    # ============ 2. the audio path (enable_rds=False): counts from 0 here
    _cuda.reset_launch_counts()
    rep_stream = stream_phase(N_AUDIO_STREAM_BLOCKS, rds=False)
    rep_batch, twin_a, _ = batch_phase(rxba, rx1a, N_AUDIO_BATCH_STEPS)
    rep_runner = runner_phase(N_AUDIO_RUNNER_BLOCKS, twin_a, rds=False)
    # stream, batch, the batch's C = 1 twin, BatchRunner
    audio_counts = expect_counts(
        "audio", N_AUDIO_STREAM_BLOCKS + 2 * N_AUDIO_BATCH_STEPS
        + N_AUDIO_RUNNER_BLOCKS,
        {"ingest.fm_audio": 1, "fir_bank.none": 1, "fir_bank.mul2": 1,
         "pll": 1})
    # ======================================== end of the audio path
    emit({"stream_audio": rep_stream, "card": card})
    emit({"batch_audio": rep_batch, "card": card})
    emit({"batch_runner_audio": rep_runner, "card": card})
    del rxba, rx1a, twin_a

    # ======= 3. the full mode-0 path (audio + RDS): counts from 0 here
    _cuda.reset_launch_counts()
    rep_stream = stream_phase(N_STREAM_BLOCKS, rds=True)
    rep_batch, twin, _ = batch_phase(rxb, rx1, N_BATCH_STEPS)
    rep_runner = runner_phase(N_RUNNER_BLOCKS, twin, rds=True)
    rds_per_step = {"ingest.fm_audio": 1, "fir_bank.none": 1,
                    "fir_bank.square": 1, "fir_bank.mul2": 1, "pll": 1,
                    "resample_rrc": 1}
    rds_counts = expect_counts(
        "RDS", N_STREAM_BLOCKS + 2 * N_BATCH_STEPS + N_RUNNER_BLOCKS,
        rds_per_step, walks=N_STREAM_BLOCKS)
    # ================================== end of the full mode-0 path
    rep_stream["launches"] = rds_counts
    emit({"stream": rep_stream, "card": card})
    if (rep_stream["rds_syncs"] < MIN_STREAM_SYNCS
            or rep_stream["rds_false_positives"] > MAX_STREAM_FALSE_POSITIVES
            or rep_stream["decoded_pi"] != rep_stream["encoded_pi"]
            or rep_stream["decoded_ps"] != STATION_PS):
        raise SystemExit(f"chip_smoke: the stream's RDS decode is off: "
                         f"{rep_stream}")
    emit({"batch": rep_batch, "card": card})
    emit({"batch_runner": rep_runner, "card": card})
    del rxb, twin

    # ===== 4. the band-pass bank inside the ingest kernel (fuse_if_bank)
    fuse_rows = []
    fuse_per_step = {"ingest.fm_audio_bank": 1, "fir_bank.square": 1,
                     "fir_bank.mul2": 1, "pll": 1, "resample_rrc": 1}
    fuse_counts = dict.fromkeys(fuse_per_step, 0)
    for c in FUSE_CHANNELS:
        blocks = [batch_block(b, c) for b in range(N_FUSE_STEPS)]
        unfused = None
        for fuse in (False, True):
            rx = Receiver(cfg, (c,), fuse_if_bank=fuse)
            st = rx.init()
            torch.cuda.synchronize()
            if fuse:
                # ============ each fused run is counted on its own
                _cuda.reset_launch_counts()
            ms, outs = [], []
            for raw in blocks:
                t0 = time.perf_counter()
                st, out = rx.step(st, raw)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                outs.append(out)
            row = {"channels": c, "fuse_if_bank": fuse, "step_ms": ms,
                   "ms_per_step_median": statistics.median(ms[1:])}
            if not fuse:
                unfused = outs
            else:
                for name, n in expect_counts(
                        f"fuse_if_bank C = {c}", N_FUSE_STEPS,
                        fuse_per_step).items():
                    fuse_counts[name] += n
                # ==================== end of this fused run
                a_err = s_err = 0.0
                sid_diff = sid_n = 0
                for o, u in zip(outs, unfused):
                    a_err = max(a_err, max_err(o.left, u.left),
                                max_err(o.right, u.right))
                    peak_sym = float(u.rds.symbols_i.abs().max())
                    s_err = max(s_err,
                                max_err(o.rds.symbols_i, u.rds.symbols_i)
                                / peak_sym)
                    sid_diff += int((o.rds.syndrome_id
                                     != u.rds.syndrome_id).sum())
                    sid_n += o.rds.syndrome_id.numel()
                    if not (torch.equal(o.rds.n_sym, u.rds.n_sym)
                            and torch.equal(o.rds.n_windows,
                                            u.rds.n_windows)):
                        raise SystemExit("chip_smoke: fused and unfused "
                                         "receivers count differently")
                row.update({"audio_max_abs_err_vs_unfused": a_err,
                            "audio_tolerance": TOL_FUSED_AUDIO,
                            "symbols_max_rel_err_vs_unfused": s_err,
                            "symbols_tolerance": TOL_FUSED_SYMBOLS_REL,
                            "syndrome_ids_differing": sid_diff,
                            "syndrome_ids_compared": sid_n})
                # a symbol within rounding of zero may slice either way;
                # more than one window in a thousand is a fault
                if (not a_err <= TOL_FUSED_AUDIO
                        or not s_err <= TOL_FUSED_SYMBOLS_REL
                        or sid_diff > sid_n // 1000):
                    raise SystemExit(f"chip_smoke: fuse_if_bank=True "
                                     f"differs from unfused: {row}")
            fuse_rows.append(row)
            del rx, st, outs
        del blocks, unfused
        torch.cuda.empty_cache()
    # ============================== end of the fuse_if_bank path
    emit({"fuse_if_bank": fuse_rows, "card": card})

    # ======================= 5. wideband: 16 slots x 8 captures per step
    import wave as wave_mod

    def tone(x, hz):
        t = np.arange(x.shape[-1]) / cfg.audio_fs
        return 2.0 * float(np.hypot(np.mean(x * np.sin(2 * np.pi * hz * t)),
                                    np.mean(x * np.cos(2 * np.pi * hz * t))))

    wb_kw = dict(channel_offsets_hz=wb_offsets, resync=True)
    live = sorted(WB_STATIONS)
    empty = [c for c in range(WB_K) if c not in live]

    # outside the counted window: the composed front door against the
    # two-stage one on the same bytes, two blocks from the zero state
    def first_blocks(impl):
        init, step = make_wideband_receiver(
            cfg, WB_K, (WB_CAPTURES,), channelizer_impl=impl, **wb_kw)
        st, outs = init(), []
        for b in range(2):
            st, out = step(st, wb_blocks[b])
            outs.append(torch.stack([out.left, out.right, out.mono]))
        torch.cuda.synchronize()
        return outs

    _cuda.reset_launch_counts()
    pfb_outs = first_blocks("pfb")
    pfb_counts = _cuda.launch_counts()
    comp_outs = first_blocks("composed")
    # (block, L/R/mono, capture, slot): the largest |difference| over time.
    # Gated: mono in both blocks, and L / R in block 1 of the slots that
    # carry a pilot.  A pilot loop whose phase error passes the detector's
    # +-pi seam takes either side on a difference of one rounding: while it
    # acquires from the zero state (block 0) and for ever where there is no
    # pilot to lock to (the mono-only carrier); those L / R are reported.
    wb_diff = torch.stack([(a - b).abs().amax(dim=-1)
                           for a, b in zip(comp_outs, pfb_outs)])
    piloted = [c for c in live if WB_STATIONS[c].get("pilot_amp", 0.1)]
    wb_vs_pfb = max(float(wb_diff[:, 2][:, :, live].max()),
                    float(wb_diff[1, :2][:, :, piloted].max()))
    wb_vs_pfb_block0_lr = float(wb_diff[0, :2][:, :, live].max())
    wb_vs_pfb_empty = float(wb_diff[:, :, :, empty].max())
    wb_vs_pfb_by_slot = [float(x) for x in wb_diff.amax(dim=(0, 1, 2))]
    del pfb_outs, comp_outs
    torch.cuda.empty_cache()

    wb_init, wb_step = make_wideband_receiver(cfg, WB_K, (WB_CAPTURES,),
                                              **wb_kw)
    wb1_init, wb1_step = make_wideband_receiver(cfg, WB_K, **wb_kw)
    # ==================== the wideband path: counts from 0 here
    _cuda.reset_launch_counts()
    st_b, st_1 = wb_init(), wb1_init()
    wb_ms, wb_peak, wb_row0, wb_finite = [], 0, 0.0, True
    wb_left, wb_right = [], []
    decs = [GroupDecoder() for _ in range(WB_K)]
    for b in range(WB_BLOCKS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st_b, out_b = wb_step(st_b, wb_blocks[b])
        torch.cuda.synchronize()
        wb_ms.append((time.perf_counter() - t0) * 1e3)
        wb_peak = max(wb_peak, torch.cuda.max_memory_allocated())
        st_1, out_1 = wb1_step(st_1, wb_dev[b])
        for a, r in ((out_b.left, out_1.left), (out_b.right, out_1.right)):
            if tuple(a.shape) != (WB_CAPTURES, WB_K, n_audio):
                raise SystemExit(f"chip_smoke: wideband output {a.shape}")
            wb_finite = wb_finite and bool(torch.isfinite(a).all())
            wb_row0 = max(wb_row0, max_err(a[0], r))
        for name, a, r in zip(out_b.rds._fields, out_b.rds, out_1.rds):
            if not a.dtype.is_floating_point and not torch.equal(a[0], r):
                raise SystemExit(f"chip_smoke: wideband frame output {name} "
                                 "of capture 0 differs from its twin's")
        wb_left.append(out_1.left.cpu().numpy())
        wb_right.append(out_1.right.cpu().numpy())
        fo = type(out_1.rds)(*(x.cpu().numpy() for x in out_1.rds))
        for c in range(WB_K):
            decs[c].feed(type(fo)(*(leaf[c] for leaf in fo)))
    wb_counts = expect_counts(
        "wideband", 2 * WB_BLOCKS,
        {"channelizer.composed": 1, "fir_bank.none": 2, "fir_bank.square": 1,
         "fir_bank.mul2": 1, "pll": 1, "resample_rrc": 1, "sync_walk": 1})
    # ============================== end of the wideband path
    left = np.concatenate(wb_left, axis=-1)[:, n_audio:]      # (K, T)
    right = np.concatenate(wb_right, axis=-1)[:, n_audio:]
    tones, tones_ok = {}, True
    for c in live:
        kw = WB_STATIONS[c]
        got = {"mono_in_L+R": tone(left[c] + right[c], kw["mono_hz"]),
               "stereo_in_L-R": tone(left[c] - right[c], kw["stereo_hz"])}
        # the default station's amplitudes, scaled by this station's
        want = {"mono_in_L+R": 0.88 * kw.get("mono_amp", 0.45) / 0.45,
                "stereo_in_L-R": 0.83 * kw.get("stereo_amp", 0.45) / 0.45}
        tones[c] = {"measured": got, "expected": want}
        tones_ok = tones_ok and all(
            abs(got[n] - want[n]) < (0.1 * want[n] or 0.02) for n in got)
    # an empty slot is not silent (FM demodulation is amplitude-blind and
    # it demodulates noise), but no live station's tone stands in it
    stray = max(tone(left[c], WB_STATIONS[s]["mono_hz"])
                for c in empty for s in live)
    wb_steady = statistics.median(wb_ms[1:])
    dec = decs[WB_RDS_SLOT]
    rep_wb = {
        "slots": WB_K, "captures": WB_CAPTURES, "blocks": WB_BLOCKS,
        "stations_per_step": WB_K * WB_CAPTURES, "live_slots": live,
        "offset_slot": WB_OFFSET_SLOT, "offset_hz": WB_OFFSET_HZ,
        "finite": wb_finite, "tone_amplitudes": tones,
        "tones_within": "10% of expected (0.02 where none is expected)",
        "max_live_tone_in_an_empty_slot_left": stray,
        "empty_slot_limit": 0.15,
        "capture0_max_abs_err_vs_single_capture": wb_row0,
        "capture0_tolerance": TOL_ROW0,
        "composed_vs_pfb_audio_max_abs_err_live_slots": wb_vs_pfb,
        "composed_vs_pfb_compared": "mono of blocks 0 and 1 in the live "
                                    "slots, left / right of block 1 in "
                                    f"slots {piloted} (pilot loops locked)",
        "composed_vs_pfb_tolerance": TOL_WB_AUDIO,
        "composed_vs_pfb_audio_max_abs_err_empty_slots": wb_vs_pfb_empty,
        "composed_vs_pfb_by_slot": wb_vs_pfb_by_slot,
        "composed_vs_pfb_block0_left_right_live_slots": wb_vs_pfb_block0_lr,
        "pfb_launches_two_steps": pfb_counts,
        "decoded_pi": None if dec.pi is None else f"0x{dec.pi:04X}",
        "decoded_ps": dec.ps_name, "encoded_pi": f"0x{WB_PI:04X}",
        "encoded_ps": WB_PS, "groups_in_rds_slot": len(dec.groups),
        "groups_in_empty_slots": sum(len(decs[c].groups) for c in empty),
        "decoded_pi_by_slot": {
            c: None if decs[c].pi is None else f"0x{decs[c].pi:04X}"
            for c in live},
        "step_ms": wb_ms, "ms_per_step_median": wb_steady,
        "stations_x_realtime": WB_K * WB_CAPTURES * 64.0 / wb_steady,
        "max_memory_allocated_bytes": wb_peak, "launches": wb_counts}
    if (not wb_finite or not tones_ok or stray >= 0.15
            or not wb_row0 <= TOL_ROW0 or not wb_vs_pfb <= TOL_WB_AUDIO
            or dec.pi != WB_PI or dec.ps_name != WB_PS
            or any(decs[c].pi != (rds[0] if rds else None)
                   for c, (_, rds) in WB_BAND.items())
            or rep_wb["groups_in_empty_slots"]
            or pfb_counts != {"fir_bank.none": 6, "fir_bank.square": 2,
                              "fir_bank.mul2": 2, "pll": 2,
                              "resample_rrc": 2, "sync_walk": 2}):
        raise SystemExit(f"chip_smoke: wideband outputs wrong: {rep_wb}")

    # the same capture through the CLI: channel<k>.wav per slot, the bytes
    # of the single-capture run above
    center = (f"{(WB_OFFSET_SLOT * cfg.rf.fs + WB_OFFSET_HZ) / 1e6:.2f}M")
    with tempfile.TemporaryDirectory() as tmp:
        iq_path = os.path.join(tmp, "band.iq")
        wb_host.tofile(iq_path)
        cli = run_cli(iq_path, "--wideband", str(WB_K),
                      f"--wideband-centers={center}", "--rds-groups", cwd=tmp)
        cli_err = cli.stderr.decode().splitlines()
        wavs_equal = cli.returncode == 0
        for c in range(WB_K):
            want = runtime.emit_int16_interleave(
                np.concatenate(wb_left, axis=-1)[c],
                np.concatenate(wb_right, axis=-1)[c], 32767.0).tobytes()
            path = os.path.join(tmp, f"channel{c}.wav")
            if not wavs_equal or not os.path.exists(path):
                wavs_equal = False
                break
            with wave_mod.open(path, "rb") as wv:
                wavs_equal = wavs_equal and wv.readframes(
                    wv.getnframes()) == want
    rep_wb["cli"] = {
        "returncode": cli.returncode, "wav_files": WB_K,
        "wav_bytes_identical": wavs_equal, "wideband_centers": center,
        "summary": [ln for ln in cli_err
                    if ln.startswith((f"[ch{WB_RDS_SLOT}] RDS: PI=",
                                      "processed ", "wideband channel"))]}
    if (not wavs_equal or not any(
            ln.startswith(f"[ch{WB_RDS_SLOT}] RDS: PI=0x{WB_PI:04X}")
            and f"PS='{WB_PS}'" in ln for ln in cli_err)):
        raise SystemExit("chip_smoke: the wideband CLI run failed or its wav "
                         f"files differ: {rep_wb['cli']} "
                         f"{cli.stderr.decode()[-2000:]}")
    emit({"wideband": rep_wb, "card": card})
    del wb_step, wb1_step, st_b, st_1, out_b, out_1
    torch.cuda.empty_cache()

    # ================================== 6. the band scanner, compiled
    # without donation as the CLI runs it (utils/jit.py::jit_fn), against
    # the eager scanner over the same blocks: metrics bit for bit
    sc_init, sc_step = make_band_scanner(cfg, WB_K)
    e_st, sc_eager = sc_init(), []
    for b in range(N_SCAN_BLOCKS):
        m, e_st = sc_step(e_st, wb_dev[b])
        sc_eager.append([x.clone() for x in m])
    sc_jit = jit_mod.jit_fn(sc_step, dev, name="band scanner")
    torch.cuda.synchronize()
    # ==================== the scan path: counts from 0 here
    _cuda.reset_launch_counts()
    st, acc, sc_ms, sc_equal = sc_init(), [], [], True
    for b in range(N_SCAN_BLOCKS):
        t0 = time.perf_counter()
        m, st = sc_jit(st, wb_dev[b])
        torch.cuda.synchronize()
        sc_ms.append((time.perf_counter() - t0) * 1e3)
        sc_equal = sc_equal and all(
            torch.equal(x, y) for x, y in zip(m, sc_eager[b]))
        if b > 0:
            acc.append([x.cpu().numpy() for x in m])
    scan_counts = expect_counts("scan", N_SCAN_BLOCKS, {"fir_bank.none": 1})
    # ============================== end of the scan path
    if not isinstance(sc_jit, jit_mod.CompiledFn) or sc_jit._graph is None:
        raise SystemExit("chip_smoke: the band scanner did not replay a "
                         "graph")
    if not sc_equal:
        raise SystemExit("chip_smoke: the compiled band scanner differs "
                         "from the eager one")
    held = [st]

    def scan_replay():
        held[0] = sc_jit.borrowed(held[0], wb_dev[0])[1]
    sc_graph_ms = burst_ms(scan_replay, calls=10, reps=3)
    sc_eager_ms = burst_ms(lambda: sc_step(e_st, wb_dev[0]), calls=10,
                           reps=3)
    del held, sc_eager
    mean = type(m)(*(np.mean(np.stack(xs), axis=0) for xs in zip(*acc)))
    verdicts = classify(mean)
    want_verdicts = ["empty"] * WB_K
    for c, (_, rds) in WB_BAND.items():
        want_verdicts[c] = "station+stereo+rds" if rds else "station"
    # the scanner mixes no offset out: the station 150 kHz off its slot's
    # center is found, whatever of its pilot survives the RF low-pass
    verdicts_ok = all(
        v.startswith("station") if c == WB_OFFSET_SLOT else v == w
        for c, (v, w) in enumerate(zip(verdicts, want_verdicts)))
    with tempfile.TemporaryDirectory() as tmp:
        iq_path = os.path.join(tmp, "band.iq")
        wb_host[:N_SCAN_BLOCKS + 2].tofile(iq_path)
        cli = run_cli(iq_path, "--wideband", str(WB_K), "--auto", "--no-rds",
                      cwd=tmp)
        table = cli.stdout.decode().splitlines()
        cli_err = cli.stderr.decode().splitlines()
        wavs = sorted(f for f in os.listdir(tmp) if f.endswith(".wav"))
    rep_scan = {
        "slots": WB_K, "blocks": N_SCAN_BLOCKS, "verdicts": verdicts,
        "synthesized": want_verdicts,
        "rssi_db": [float(x) for x in mean.rssi_db],
        "pilot_snr_db": [float(x) for x in mean.pilot_snr_db],
        "rds_snr_db": [float(x) for x in mean.rds_snr_db],
        "step": "compiled (jit_fn)", "equal_to_eager_bitwise": sc_equal,
        "step_ms": sc_ms, "launches": scan_counts,
        "burst_events_ms_per_step_compiled": sc_graph_ms,
        "burst_events_ms_per_step_eager": sc_eager_ms,
        "cli_auto": {"returncode": cli.returncode,
                     "verdicts": [ln.split()[-1] for ln in table[1:]],
                     "stderr": cli_err, "wav_files": wavs}}
    if (not verdicts_ok or cli.returncode != 0
            or rep_scan["cli_auto"]["verdicts"] != verdicts
            or wavs != sorted(f"channel{c}.wav" for c in live)
            or cli_err[:1] != [f"auto: {len(live)}/{WB_K} slots active after "
                               "3-block scan; decoding those"]):
        raise SystemExit(f"chip_smoke: band scan wrong: {rep_scan}")
    emit({"scan": rep_scan, "card": card})

    # ========= 7. channel- and wideband-sharded receivers, one-card mesh
    mesh1 = make_mesh(1, 1, devices=[dev])
    rx_c = Receiver(cfg, (N_BATCH_CHANNELS,))
    ch_init, ch_step, ch_rows = make_channel_sharded_receiver(
        cfg, mesh1, N_BATCH_CHANNELS)
    ws_init, ws_step = make_wideband_sharded_receiver(cfg, mesh1, WB_K,
                                                      **wb_kw)
    w1_init, w1_step = make_wideband_receiver(cfg, WB_K, **wb_kw)

    def clone_tree(t):
        if t is None or isinstance(t, torch.Tensor):
            return None if t is None else t.clone()
        vals = [clone_tree(v) for v in t]
        return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)

    def trees_equal(a, b):
        if a is None or b is None:
            return a is None and b is None
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return len(a) == len(b) and all(trees_equal(x, y)
                                        for x, y in zip(a, b))

    # the unsharded receivers first, outside the counted window: their
    # outputs and states are what the sharded ones must equal
    raws = [batch_block(b) for b in range(N_CHANNELS_STEPS)]
    ref_u, wref_u = [], []
    st_u, wst_u = rx_c.init(), w1_init()
    for b, raw in enumerate(raws):
        st_u, out_u = rx_c.step(st_u, raw)
        wst_u, wout_u = w1_step(wst_u, wb_dev[b])
        # (a clone: the compiled receiver's next step updates its state
        # in place)
        ref_u.append((clone_tree(st_u), out_u))
        wref_u.append((wst_u, wout_u))
    torch.cuda.synchronize()

    # ==================== the sharded paths: counts from 0 here
    _cuda.reset_launch_counts()
    ch_equal = ws_equal = True
    st_s, wst_s = ch_init(), ws_init()
    for b, raw in enumerate(raws):
        st_s, out_s = ch_step(st_s, raw)
        wst_s, wout_s = ws_step(wst_s, wb_dev[b])
        (st_u, out_u), (wst_u, wout_u) = ref_u[b], wref_u[b]
        ch_equal = (ch_equal and trees_equal(out_s, out_u)
                    and trees_equal(st_s[0], st_u))
        ws_equal = (ws_equal and trees_equal(wout_s, wout_u)
                    and trees_equal(wst_s.rx[0], wst_u.rx)
                    and trees_equal(wst_s.chan_zi, wst_u.chan_zi))
    sharded_counts = _cuda.launch_counts()
    # one channel-sharded step is one receiver step (rds_per_step); one
    # wideband-sharded step is the composed channelizer plus the receiver
    # of its slots with the IF front end
    want = {k: N_CHANNELS_STEPS * v for k, v in rds_per_step.items()}
    for k, v in {"channelizer.composed": 1, "fir_bank.none": 2,
                 "fir_bank.square": 1, "fir_bank.mul2": 1, "pll": 1,
                 "resample_rrc": 1, "sync_walk": 1}.items():
        want[k] = want.get(k, 0) + N_CHANNELS_STEPS * v
    if sharded_counts != want:
        raise SystemExit(f"chip_smoke: launch counts {sharded_counts} on the "
                         f"sharded paths, expected {want}")
    # ============================== end of the sharded paths
    t0 = time.perf_counter()
    scaling = measure_scaling(cfg, device_counts=[1])
    rep_ch = {"mesh": {"channel_shards": 1, "time_shards": 1},
              "channels": N_BATCH_CHANNELS, "steps": N_CHANNELS_STEPS,
              "row_split": [[sl.start, sl.stop] for sl in ch_rows],
              "channel_sharded_equal_unsharded_bitwise": ch_equal,
              "wideband_sharded_equal_unsharded_bitwise": ws_equal,
              "wideband_slots": WB_K, "launches": sharded_counts,
              "measure_scaling": scaling,
              "measure_scaling_seconds": time.perf_counter() - t0}
    if (not ch_equal or not ws_equal or len(scaling) != 1
            or scaling[0]["devices"] != 1
            or not scaling[0]["channel_blocks_per_sec"] > 0):
        raise SystemExit(f"chip_smoke: sharded receivers wrong: {rep_ch}")
    emit({"channels": rep_ch, "card": card})
    del (rx_c, raws, ref_u, wref_u, st_s, st_u, out_s, out_u, wst_s, wst_u,
         wout_s, wout_u, wb_blocks, wb_dev)
    torch.cuda.empty_cache()

    # ================================== 8. mode 1 and MODE1_RDS
    rx1m = Receiver(MODE1, ())
    st = rx1m.init()
    for b in range(2):                                   # warm-up
        st, _ = rx1m.step(st, torch.as_tensor(m1_station[b]).to(dev))
    torch.cuda.synchronize()
    # ==================== the mode-1 audio path: counts from 0 here
    _cuda.reset_launch_counts()
    rep_m1 = stream_phase(N_MODE1_STREAM_BLOCKS, rds=False, cfg=MODE1,
                          station=m1_station, mode="1")
    m1_counts = expect_counts(
        "mode 1", N_MODE1_STREAM_BLOCKS,
        {"ingest.fm": 1, "fir_bank.none": 1, "pll": 1})
    # ============================== end of the mode-1 audio path
    rep_m1["launches"] = m1_counts
    emit({"mode1_stream": rep_m1, "card": card})

    rx1r = Receiver(cfg1, ())
    rxbr = Receiver(cfg1, (N_BATCH_CHANNELS,))
    rxbr.step(rxbr.init(), m1_block(0))                  # warm-up
    torch.cuda.synchronize()
    # ==================== the MODE1_RDS path: counts from 0 here
    _cuda.reset_launch_counts()
    rep_m1r = stream_phase(N_MODE1_RDS_STREAM_BLOCKS, rds=True, cfg=cfg1,
                           station=m1_station, mode="1", pi=MODE1_PI,
                           ps=MODE1_PS)
    rep_m1b, _, _ = batch_phase(rxbr, rx1r, N_MODE1_BATCH_STEPS,
                                block_fn=m1_block)
    m1r_counts = expect_counts(
        "MODE1_RDS", N_MODE1_RDS_STREAM_BLOCKS + 2 * N_MODE1_BATCH_STEPS,
        {"ingest.fm": 1, "fir_bank.none": 1, "fir_bank.square": 1, "pll": 1,
         "resample_rrc": 1}, walks=N_MODE1_RDS_STREAM_BLOCKS)
    # ============================== end of the MODE1_RDS path
    rep_m1r["launches"] = m1r_counts
    emit({"mode1_rds_stream": rep_m1r, "card": card})
    if (rep_m1r["rds_syncs"] < 24
            or rep_m1r["rds_false_positives"] > MAX_STREAM_FALSE_POSITIVES
            or rep_m1r["decoded_pi"] != rep_m1r["encoded_pi"]
            or rep_m1r["decoded_ps"] != MODE1_PS):
        raise SystemExit(f"chip_smoke: the mode-1 stream's RDS decode is "
                         f"off: {rep_m1r}")
    emit({"mode1_rds_batch": rep_m1b, "card": card})
    del rxbr, rx1r

    # ============ 9. the time-sharded receiver (MODE0, stereo + RDS + frame)
    # The serial references run first, outside the counted window.
    def timed_run(init, step, blocks):
        st, outs, ms = init(), [], []
        for raw in blocks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, out = step(st, raw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        return outs, ms

    def serial_run(cfg_, blocks, c=1, **kw):
        rx = Receiver(cfg_, (c,), **kw)
        return timed_run(rx.init, rx.step, blocks)

    def ts_run(cfg_, blocks, t_shards, c=1, **kw):
        return timed_run(*make_time_sharded_receiver(
            cfg_, make_mesh(1, t_shards, devices=[dev]), c, **kw), blocks)

    def vs_serial(outs, refs):
        """Audio and frame outputs of a run against the serial receiver's.
        Symbols are held in row 0, the noiseless station, here; the rows
        under +-8 LSB of noise are held at C = 1,024 against a witness
        (``sym_rel_per_block``)."""
        a_err = s_err = s_err_all = 0.0
        sid_diff = sid_n = 0
        counts_equal = True
        for o, u in zip(outs, refs):
            a_err = max(a_err, max_err(o.left, u.left),
                        max_err(o.right, u.right), max_err(o.mono, u.mono))
            peak = float(u.rds.symbols_i[0].abs().max())
            for a, b in ((o.rds.symbols_i, u.rds.symbols_i),
                         (o.rds.symbols_q, u.rds.symbols_q)):
                s_err = max(s_err, max_err(a[0], b[0]) / peak)
                s_err_all = max(s_err_all, max_err(a, b)
                                / float(b.abs().max()))
            sid_diff += int((o.rds.syndrome_id != u.rds.syndrome_id).sum())
            sid_n += o.rds.syndrome_id.numel()
            counts_equal = counts_equal and torch.equal(
                o.rds.n_sym, u.rds.n_sym) and torch.equal(
                o.rds.n_windows, u.rds.n_windows)
        return {"audio_max_abs_err_vs_serial": a_err,
                "audio_tolerance": TOL_FUSED_AUDIO,
                "symbols_max_rel_err_vs_serial": s_err,
                "symbols_tolerance": TOL_FUSED_SYMBOLS_REL,
                "symbols_max_rel_err_vs_serial_all_rows": s_err_all,
                "syndrome_ids_differing": sid_diff,
                "syndrome_ids_compared": sid_n,
                "symbol_and_window_counts_equal": counts_equal}

    def sym_rel_per_block(outs, refs):
        """Per block, over all rows: max |symbol difference| / peak."""
        return [max(max_err(o.rds.symbols_i, u.rds.symbols_i),
                    max_err(o.rds.symbols_q, u.rds.symbols_q))
                / float(u.rds.symbols_i.abs().max())
                for o, u in zip(outs, refs)]

    def audio_per_block(outs, refs):
        """Per block, over all rows: max |audio difference|."""
        return [max(max_err(o.left, u.left), max_err(o.right, u.right),
                    max_err(o.mono, u.mono))
                for o, u in zip(outs, refs)]

    def audio_rows_over(outs, refs, tol):
        """Per block: the rows whose max |audio difference| exceeds tol."""
        over = []
        for o, u in zip(outs, refs):
            err = torch.stack([(a.double() - b.double()).abs().amax(-1)
                               for a, b in ((o.left, u.left),
                                            (o.right, u.right),
                                            (o.mono, u.mono))]).amax(0)
            over.append({int(r): float(err[r])
                         for r in torch.nonzero(err > tol).flatten()})
        return over

    def exact_ok(rep):
        # a symbol within rounding of zero may slice either way; more than
        # one window in a thousand is a fault
        return (rep["audio_max_abs_err_vs_serial"] <= TOL_FUSED_AUDIO
                and rep["symbols_max_rel_err_vs_serial"]
                <= TOL_FUSED_SYMBOLS_REL
                and rep["syndrome_ids_differing"]
                <= rep["syndrome_ids_compared"] // 1000
                and rep["symbol_and_window_counts_equal"])

    def snr_db(got, ref):
        got, ref = got.double(), ref.double()
        err = float(torch.sqrt(torch.mean((got - ref) ** 2)))
        return 20 * np.log10(float(torch.sqrt(torch.mean(ref ** 2)))
                             / max(err, 1e-30))

    def syncs(outs):
        return sum(int(o.rds.is_sync[0, :int(o.rds.n_windows[0])].sum())
                   for o in outs)

    ts_blocks = [torch.as_tensor(station[b][None]).to(dev)
                 for b in range(N_TS_BLOCKS)]
    detuned = fm_multiplex_iq(
        N_TS_DETUNED_BLOCKS * cfg.iq_len, pilot_hz=19e3 + 60.0,
        rds_wave=rds_baseband(encode_rds_blocks(ps_station_words(
            N_TS_DETUNED_BLOCKS + 4, STATION_PI, STATION_PS)))
    ).reshape(N_TS_DETUNED_BLOCKS, cfg.block_size)
    det_blocks = [torch.as_tensor(detuned[b][None]).to(dev)
                  for b in range(N_TS_DETUNED_BLOCKS)]
    tsb_blocks = [batch_block(b) for b in range(N_TS_BATCH_STEPS)]
    ser1, ser1_ms = serial_run(cfg, ts_blocks)
    ser_det, ser_det_ms = serial_run(cfg, det_blocks, pll_loop_div=4)
    serb, serb_ms = serial_run(cfg, tsb_blocks, c=N_BATCH_CHANNELS)
    # the witness: the serial receiver with the discriminator in stock ops
    # after K1's iq route, as the time-sharded receiver has it (its 'if'
    # front end fed K1's decimated I/Q, the RF state carried here), against
    # the serial receiver with K1's fm entry
    def witness_run(blocks, c):
        rx = Receiver(cfg, (c,), frontend_impl="if")
        st, outs = rx.init(), []
        zi_i = zi_q = torch.zeros(c, taps - 1, device=dev)
        for blk in blocks:
            y_i, y_q, zi_i, zi_q = ingestfir.ingest_fir_decimate(
                blk, rf_h, zi_i, zi_q, cfg.rf.decim)
            st, out = rx.step(st, torch.stack([y_i, y_q], dim=-2))
            outs.append(out)
        return outs

    serb_fe = witness_run(tsb_blocks, N_BATCH_CHANNELS)
    witness = sym_rel_per_block(serb_fe, serb)
    witness_audio = audio_per_block(serb_fe, serb)
    for t_shards in TS_SHARDS:            # warm-up of each shape
        ts_run(cfg, ts_blocks[:1], t_shards)
    for t_shards in (1, TS_BATCH_T):
        ts_run(cfg, tsb_blocks[:1], t_shards, c=N_BATCH_CHANNELS)
    torch.cuda.synchronize()

    def ts_per_step(t_shards, handoff="exact", mode1=False, resync=False):
        return {"ingest.iq": 1, "fir_bank.none": 2 if mode1 else 3,
                "fir_bank.square": 1,
                **({} if mode1 else {"fir_bank.mul2": 1}),
                "pll": {"exact": t_shards, "stale": 1, "iterate": 2}[handoff],
                "resample_mix": 1, **({"sync_walk": 1} if resync else {})}

    def add_counts(total, steps, per_step):
        for k, v in per_step.items():
            total[k] = total.get(k, 0) + steps * v

    # ==================== the time-sharded path: counts from 0 here
    _cuda.reset_launch_counts()
    ts_want, ts_rows, ts_fail = {}, [], []
    for t_shards in TS_SHARDS:
        outs, ms = ts_run(cfg, ts_blocks, t_shards)
        add_counts(ts_want, N_TS_BLOCKS, ts_per_step(t_shards))
        row = {"channels": 1, "time_shards": t_shards, "handoff": "exact",
               "blocks": N_TS_BLOCKS, **vs_serial(outs, ser1),
               "ms_per_64ms_block": statistics.median(ms[1:]),
               "serial_ms_per_64ms_block": statistics.median(ser1_ms[1:]),
               "step_ms": ms}
        ts_rows.append(row)
        if not exact_ok(row):
            ts_fail.append(row)
    for handoff, floor in TS_SNR_FLOOR_DB.items():
        outs, ms = ts_run(cfg, ts_blocks, 4, pll_handoff=handoff)
        add_counts(ts_want, N_TS_BLOCKS, ts_per_step(4, handoff))
        snrs = [snr_db(o.left[0], u.left[0])
                for o, u in zip(outs[1:], ser1[1:])]
        last_syncs = syncs(outs[-2:])
        row = {"channels": 1, "time_shards": 4, "handoff": handoff,
               "blocks": N_TS_BLOCKS, "left_snr_db_vs_serial_blocks_1_on":
               snrs, "snr_floor_db": floor,
               "syncs_in_last_two_blocks": last_syncs,
               "ms_per_64ms_block": statistics.median(ms[1:]),
               "serial_ms_per_64ms_block": statistics.median(ser1_ms[1:]),
               "step_ms": ms}
        ts_rows.append(row)
        if min(snrs) <= floor or last_syncs == 0:
            ts_fail.append(row)
    outs, ms = ts_run(cfg, det_blocks, 4, pll_handoff="iterate",
                      pll_loop_div=4)
    add_counts(ts_want, N_TS_DETUNED_BLOCKS, ts_per_step(4, "iterate"))
    snrs = [snr_db(o.left[0], u.left[0]) for o, u in zip(outs[1:],
                                                         ser_det[1:])]
    row = {"channels": 1, "time_shards": 4, "handoff": "iterate",
           "pll_loop_div": 4, "pilot_hz": 19e3 + 60.0,
           "blocks": N_TS_DETUNED_BLOCKS,
           "left_snr_db_vs_serial_blocks_1_on": snrs,
           "snr_floor_db": TS_SNR_FLOOR_DB["iterate"],
           "ms_per_64ms_block": statistics.median(ms[1:]),
           "serial_ms_per_64ms_block": statistics.median(ser_det_ms[1:]),
           "step_ms": ms}
    ts_rows.append(row)
    if min(snrs) <= TS_SNR_FLOOR_DB["iterate"]:
        ts_fail.append(row)
    # C = 1,024: T = 1 (the time-sharded route, no seams) and T = 2.  Rows
    # 1.. carry +-8 LSB of noise, where a ~1e-7 difference of fm can move a
    # loop or the blend for a block; against the serial receiver at most
    # one row in 1,000 per block may then part in audio, by at most
    # TOL_FLIPPED_ROW_AUDIO, and their symbols by at most twice what the
    # witness parts by.  The witness has the time-sharded route's
    # arithmetic: T = 1 and T = 2 are held to it in every row at the exact
    # tolerances, and T = 2 to T = 1 in every row
    def batch_check(outs, ms, t_shards, ref_t1=None):
        """One C = 1,024 run of ``tsb_blocks`` held to the witness and to
        the serial receiver (and to the T = 1 run ``ref_t1``, if given):
        (report row, passed)."""
        tol_noisy = max(TOL_FUSED_SYMBOLS_REL, 2 * max(witness))
        flipped = audio_rows_over(outs, serb, TOL_FUSED_AUDIO)
        vs_w = vs_serial(outs, serb_fe)
        row = {"channels": N_BATCH_CHANNELS, "time_shards": t_shards,
               "handoff": "exact", "steps": N_TS_BATCH_STEPS,
               **vs_serial(outs, serb),
               "audio_max_abs_err_vs_serial_all_rows_per_block":
                   audio_per_block(outs, serb),
               "symbols_max_rel_err_vs_serial_all_rows_per_block":
                   sym_rel_per_block(outs, serb),
               "witness_audio_max_abs_err_all_rows_per_block":
                   witness_audio,
               "witness_symbols_max_rel_err_all_rows_per_block": witness,
               "noisy_rows_tolerance": tol_noisy,
               "audio_rows_over_tolerance_vs_serial_per_block": flipped,
               "audio_rows_over_tolerance_allowed_per_block":
                   N_BATCH_CHANNELS // 1000,
               "flipped_rows_audio_tolerance": TOL_FLIPPED_ROW_AUDIO,
               "audio_max_abs_err_vs_witness_all_rows":
                   vs_w["audio_max_abs_err_vs_serial"],
               "symbols_max_rel_err_vs_witness_all_rows":
                   vs_w["symbols_max_rel_err_vs_serial_all_rows"],
               "syndrome_ids_differing_vs_witness":
                   vs_w["syndrome_ids_differing"],
               "finite": all(bool(torch.isfinite(o.left).all())
                             for o in outs),
               "ms_per_step_median": statistics.median(ms[1:]),
               "serial_ms_per_step_median": statistics.median(serb_ms[1:]),
               "step_ms": ms, "serial_step_ms": serb_ms}
        if ref_t1 is not None:
            row["symbols_max_rel_err_vs_t1_all_rows_per_block"] = (
                sym_rel_per_block(outs, ref_t1))
        # against the serial receiver: row 0 (noiseless) exact; the audio
        # of every other row exact but for a bounded count of flipped rows;
        # symbols within the witness's bound
        serial_ok = (
            row["symbols_max_rel_err_vs_serial"] <= TOL_FUSED_SYMBOLS_REL
            and all(len(f) <= N_BATCH_CHANNELS // 1000
                    and max(f.values(), default=0.0) <= TOL_FLIPPED_ROW_AUDIO
                    for f in flipped)
            and max(row["symbols_max_rel_err_vs_serial_all_rows_per_block"])
            <= tol_noisy and row["symbol_and_window_counts_equal"])
        # against the witness (the same arithmetic): every row exact
        witness_ok = (
            exact_ok(vs_w) and vs_w["symbols_max_rel_err_vs_serial_all_rows"]
            <= TOL_FUSED_SYMBOLS_REL)
        row["row0_audio_max_abs_err_vs_serial"] = max(
            max(max_err(o.left[0], u.left[0]), max_err(o.right[0], u.right[0]),
                max_err(o.mono[0], u.mono[0])) for o, u in zip(outs, serb))
        row0_ok = row["row0_audio_max_abs_err_vs_serial"] <= TOL_FUSED_AUDIO
        return row, (
            serial_ok and witness_ok and row0_ok and row["finite"]
            and max(row.get("symbols_max_rel_err_vs_t1_all_rows_per_block",
                            [0.0])) <= TOL_FUSED_SYMBOLS_REL)

    batch_outs = {}
    for t_shards in (1, TS_BATCH_T):
        outs, ms = ts_run(cfg, tsb_blocks, t_shards, c=N_BATCH_CHANNELS)
        add_counts(ts_want, N_TS_BATCH_STEPS, ts_per_step(t_shards))
        batch_outs[t_shards] = outs
        row, ok = batch_check(outs, ms, t_shards,
                              batch_outs[1] if t_shards != 1 else None)
        ts_rows.append(row)
        if not ok:
            ts_fail.append(row)
    del batch_outs
    ts_counts = _cuda.launch_counts()
    if ts_counts != ts_want:
        raise SystemExit(f"chip_smoke: launch counts {ts_counts} on the "
                         f"time-sharded path, expected {ts_want}")
    # ============================== end of the time-sharded path
    emit({"timeshard": {"runs": ts_rows, "launches": ts_counts},
          "card": card})
    if ts_fail:
        raise SystemExit(f"chip_smoke: time-sharded receiver wrong: "
                         f"{ts_fail}")

    # ===== 9b. the spread route: each time shard on its own CUDA stream,
    # over a mesh that names this one card T times (every halo, PLL handoff
    # and gather crosses streams as it would cross cards).  References
    # first, outside the counted window: the serial receiver and the
    # stacked route on the same blocks
    sp_t0 = time.perf_counter()
    card0 = torch.device("cuda", torch.cuda.current_device())

    def _leaf_list(tree):
        if tree is None:
            return []
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [x for v in tree for x in _leaf_list(v)]

    def spread_run(cfg_, blocks, t_shards, c=1, jit=False, **kw):
        """The eager step unless ``jit``: the per-place record and the
        launch counts below read the wrappers' calls, which a replayed
        graph does not make."""
        mesh = make_mesh(1, t_shards, devices=[card0] * t_shards)
        assert mesh.spread
        return timed_run(*make_time_sharded_receiver(cfg_, mesh, c, jit=jit,
                                                     **kw), blocks)

    def spread_per_step(t_shards, handoff="exact", mode1=False,
                        resync=False):
        """Launches per step: every stage once per shard, but the frame
        layer's walk, once over the gathered block."""
        return {k: v * t_shards if k not in ("pll", "sync_walk") else
                v if k == "sync_walk" else
                {"exact": 1, "stale": 1, "iterate": 2}[handoff] * t_shards
                for k, v in ts_per_step(t_shards, handoff, mode1,
                                        resync).items()}

    def outputs_equal(a_outs, b_outs):
        return all(torch.equal(x, y) for o, u in zip(a_outs, b_outs)
                   for x, y in zip(_leaf_list(o), _leaf_list(u)))

    def vs_stacked(outs, refs):
        """Audio bit for bit, the RDS path within the exact tolerances:
        K6 adds each shard's halo as a carried zi here, where the stacked
        route's segmented form reads it in place."""
        rep = {k.replace("_vs_serial", "") + "_vs_stacked": v
               for k, v in vs_serial(outs, refs).items()}
        rep["audio_bit_equal_to_stacked"] = all(
            torch.equal(getattr(o, n), getattr(u, n))
            for o, u in zip(outs, refs) for n in ("left", "right", "mono"))
        rep["all_outputs_bit_equal_to_stacked"] = outputs_equal(outs, refs)
        return rep

    def stacked_ok(rep):
        return (rep["audio_bit_equal_to_stacked"]
                and rep["symbols_max_rel_err_all_rows_vs_stacked"]
                <= TOL_FUSED_SYMBOLS_REL
                and rep["syndrome_ids_differing_vs_stacked"]
                <= rep["syndrome_ids_compared_vs_stacked"] // 1000
                and rep["symbol_and_window_counts_equal_vs_stacked"])

    sp_blocks = [torch.as_tensor(station[b][None]).to(dev)
                 for b in range(N_SPREAD_BLOCKS)]
    sp_ser, sp_ser_ms = serial_run(cfg, sp_blocks, resync=True)
    sp_stacked = {t: ts_run(cfg, sp_blocks, t, resync=True)
                  for t in SPREAD_SHARDS}
    spb_stacked = {h: ts_run(cfg, tsb_blocks, SPREAD_BATCH_T,
                             c=N_BATCH_CHANNELS, pll_handoff=h)
                   for h in ("exact", "stale")}
    m1sp_blocks = [torch.as_tensor(m1_station[b][None]).to(dev)
                   for b in range(N_SPREAD_M1_BLOCKS)]
    for t_shards in SPREAD_SHARDS:                          # warm-up
        spread_run(cfg, sp_blocks[:1], t_shards, resync=True)
    spread_run(cfg, tsb_blocks[:1], SPREAD_BATCH_T, c=N_BATCH_CHANNELS)
    spread_run(cfg1, m1sp_blocks[:1], SPREAD_BATCH_T, resync=True)
    torch.cuda.synchronize()

    # ==================== the spread path: counts from 0 here
    # every place a shard of this window steps at, as the route enters it
    real_on_place = timeshard_mod.on_place
    sp_stepped = set()

    def seen_on_place(place):
        sp_stepped.add(str(place.device))
        return real_on_place(place)

    timeshard_mod.on_place = seen_on_place
    _cuda.reset_launch_counts()
    sp_want, sp_rows, sp_fail = {}, [], []
    sp_again = []       # (row, run arguments, eager outputs): run compiled
    for t_shards in SPREAD_SHARDS:
        outs, ms = spread_run(cfg, sp_blocks, t_shards, resync=True)
        sp_again.append((len(sp_rows), (cfg, sp_blocks, t_shards),
                         dict(resync=True), outs))
        add_counts(sp_want, N_SPREAD_BLOCKS,
                   spread_per_step(t_shards, resync=True))
        st_outs, st_ms = sp_stacked[t_shards]
        row = {"channels": 1, "time_shards": t_shards, "handoff": "exact",
               "resync": True, "blocks": N_SPREAD_BLOCKS,
               **vs_serial(outs, sp_ser), **vs_stacked(outs, st_outs),
               "ms_per_64ms_block": statistics.median(ms[1:]),
               "stacked_ms_per_64ms_block": statistics.median(st_ms[1:]),
               "serial_ms_per_64ms_block": statistics.median(sp_ser_ms[1:]),
               "launches_per_step": spread_per_step(t_shards, resync=True),
               "stacked_launches_per_step": ts_per_step(t_shards,
                                                        resync=True),
               "step_ms": ms}
        sp_rows.append(row)
        if not exact_ok(row) or not stacked_ok(row):
            sp_fail.append(row)
    sp_batch = {}
    for handoff in ("exact", "stale"):
        outs, ms = spread_run(cfg, tsb_blocks, SPREAD_BATCH_T,
                              c=N_BATCH_CHANNELS, pll_handoff=handoff)
        add_counts(sp_want, N_TS_BATCH_STEPS,
                   spread_per_step(SPREAD_BATCH_T, handoff))
        sp_batch[handoff] = outs
        sp_again.append((len(sp_rows), (cfg, tsb_blocks, SPREAD_BATCH_T),
                         dict(c=N_BATCH_CHANNELS, pll_handoff=handoff), outs))
        st_outs, st_ms = spb_stacked[handoff]
        if handoff == "exact":
            row, ok = batch_check(outs, ms, SPREAD_BATCH_T)
        else:
            snrs = [snr_db(o.left[0], u.left[0])
                    for o, u in zip(outs[1:], serb[1:])]
            row = {"channels": N_BATCH_CHANNELS, "time_shards":
                   SPREAD_BATCH_T, "steps": N_TS_BATCH_STEPS,
                   "left_snr_db_vs_serial_blocks_1_on": snrs,
                   "snr_floor_db": TS_SNR_FLOOR_DB[handoff],
                   "finite": all(bool(torch.isfinite(o.left).all())
                                 for o in outs),
                   "step_ms": ms}
            ok = min(snrs) > TS_SNR_FLOOR_DB[handoff] and row["finite"]
        row.update({"handoff": handoff, "route": "spread",
                    **vs_stacked(outs, st_outs),
                    "ms_per_64ms_block": statistics.median(ms[1:]),
                    "stacked_ms_per_64ms_block": statistics.median(st_ms[1:]),
                    "launches_per_step": spread_per_step(SPREAD_BATCH_T,
                                                         handoff),
                    "stacked_launches_per_step": ts_per_step(SPREAD_BATCH_T,
                                                             handoff)})
        sp_rows.append(row)
        if not ok or not stacked_ok(row):
            sp_fail.append(row)
    # the delayed run: before every hand-over a shard makes, a sleep queued
    # on its stream, the longer the further left the shard (T - t units),
    # so that every maker runs behind its readers: a read that does not
    # wait for its maker's event, or memory handed on before its reader is
    # done, finds what was there before.  The outputs must not move by a
    # bit
    real_record = shards_mod.record
    real_places = timeshard_mod.time_shard_places
    sp_places = []

    def keep_places(devices):
        sp_places[:] = real_places(devices)
        return tuple(sp_places)

    def delayed_record(place):
        if place in sp_places:
            with torch.cuda.stream(place.stream):
                torch.cuda._sleep(SPREAD_SLEEP_CYCLES * (
                    len(sp_places) - sp_places.index(place)))
        return real_record(place)

    def delayed_run(jit):
        """The C = 1,024 ``exact`` run with the sleeps; compiled, the
        capture records each sleep before its hand-over, so every replay
        runs each maker behind its readers as well."""
        timeshard_mod.time_shard_places = keep_places
        shards_mod.record = timeshard_mod.record = delayed_record
        try:
            return spread_run(cfg, tsb_blocks, SPREAD_BATCH_T,
                              c=N_BATCH_CHANNELS, jit=jit)
        finally:
            shards_mod.record = timeshard_mod.record = real_record
            timeshard_mod.time_shard_places = real_places

    outs, ms = delayed_run(False)
    add_counts(sp_want, N_TS_BATCH_STEPS, spread_per_step(SPREAD_BATCH_T))
    sp_delayed = len(sp_rows)
    row = {"channels": N_BATCH_CHANNELS, "time_shards": SPREAD_BATCH_T,
           "handoff": "exact", "delayed_producers": True,
           "sleep_cycles_per_hand_over_by_shard": [
               SPREAD_SLEEP_CYCLES * (SPREAD_BATCH_T - t)
               for t in range(SPREAD_BATCH_T)],
           "outputs_bit_equal_to_undelayed": outputs_equal(
               outs, sp_batch["exact"]),
           "step_ms": ms}
    sp_rows.append(row)
    if not row["outputs_bit_equal_to_undelayed"]:
        sp_fail.append(row)
    # MODE1_RDS at T = 4: the encoded PI decoded
    outs, ms = spread_run(cfg1, m1sp_blocks, SPREAD_BATCH_T, resync=True)
    add_counts(sp_want, N_SPREAD_M1_BLOCKS,
               spread_per_step(SPREAD_BATCH_T, mode1=True, resync=True))
    sp_again.append((len(sp_rows), (cfg1, m1sp_blocks, SPREAD_BATCH_T),
                     dict(resync=True), outs))
    dec = GroupDecoder()
    for o in outs:
        dec.feed(type(o.rds)(*(x[0].cpu().numpy() for x in o.rds)))
    row = {"mode": "MODE1_RDS", "channels": 1, "time_shards": SPREAD_BATCH_T,
           "handoff": "exact", "resync": True, "blocks": N_SPREAD_M1_BLOCKS,
           "syncs": syncs(outs), "groups": len(dec.groups),
           "decoded_pi": None if dec.pi is None else f"0x{dec.pi:04X}",
           "encoded_pi": f"0x{MODE1_PI:04X}",
           "ms_per_64ms_block": statistics.median(ms[1:]),
           "launches_per_step": spread_per_step(SPREAD_BATCH_T, mode1=True,
                                                resync=True)}
    sp_rows.append(row)
    if dec.pi != MODE1_PI:
        sp_fail.append(row)
    sp_counts = _cuda.launch_counts()
    # ============================== end of the spread path
    timeshard_mod.on_place = real_on_place
    # the same runs compiled (one CUDA graph over the shards' streams),
    # after the window: outputs bit for bit the eager run's, ms per block
    # beside the eager figure
    for i, args, kw, e_outs in sp_again:
        outs, ms = spread_run(*args, jit=True, **kw)
        same = outputs_equal(outs, e_outs)
        sp_rows[i].update({
            "compiled_ms_per_64ms_block": statistics.median(ms[1:]),
            "compiled_first_step_ms_with_capture": ms[0],
            "compiled_outputs_bit_equal_to_eager": same})
        if not same:
            sp_fail.append(sp_rows[i])
    outs, ms = delayed_run(True)
    row = sp_rows[sp_delayed]
    row.update({"compiled_outputs_bit_equal_to_undelayed": outputs_equal(
        outs, sp_batch["exact"]), "compiled_step_ms": ms})
    if not row["compiled_outputs_bit_equal_to_undelayed"]:
        sp_fail.append(row)
    del sp_again, e_outs, sp_batch
    emit({"timeshard_spread": {
        "runs": sp_rows, "launches": sp_counts,
        "distinct_devices": len(sp_stepped),
        "streams_per_row": SPREAD_BATCH_T,
        "phase_seconds": time.perf_counter() - sp_t0}, "card": card})
    if sp_counts != sp_want:
        raise SystemExit(f"chip_smoke: launch counts {sp_counts} on the "
                         f"spread path, expected {sp_want}")
    if sp_fail:
        raise SystemExit(f"chip_smoke: the spread route is wrong: {sp_fail}")
    if sp_stepped != {str(card0)}:
        raise SystemExit(f"chip_smoke: the spread route stepped on "
                         f"{sorted(sp_stepped)}, not on {card0} alone")
    del sp_ser, sp_stacked, spb_stacked, sp_blocks, m1sp_blocks
    del outs, ser1, ser_det, serb, serb_fe, tsb_blocks
    torch.cuda.empty_cache()

    # ===== 10. the time-sharded MODE1_RDS receiver (T = 4): decoded PI
    m1_blocks = [torch.as_tensor(m1_station[b][None]).to(dev)
                 for b in range(N_TS_M1_BLOCKS)]
    ts_run(cfg1, m1_blocks[:1], 4, resync=True)           # warm-up
    torch.cuda.synchronize()
    # ==================== the time-sharded MODE1_RDS path: counts from 0
    _cuda.reset_launch_counts()
    outs, ms = ts_run(cfg1, m1_blocks, 4, resync=True)
    m1ts_counts = expect_counts("time-sharded MODE1_RDS", N_TS_M1_BLOCKS,
                                ts_per_step(4, mode1=True, resync=True))
    # ============================== end of the time-sharded MODE1_RDS path
    dec = GroupDecoder()
    for o in outs:
        fo = type(o.rds)(*(x[0].cpu().numpy() for x in o.rds))
        dec.feed(fo)
    rep_m1ts = {"channels": 1, "time_shards": 4, "handoff": "exact",
                "blocks": N_TS_M1_BLOCKS, "syncs": syncs(outs),
                "groups": len(dec.groups),
                "decoded_pi": None if dec.pi is None else f"0x{dec.pi:04X}",
                "decoded_ps": dec.ps_name, "encoded_pi": f"0x{MODE1_PI:04X}",
                "encoded_ps": MODE1_PS,
                "ms_per_64ms_block": statistics.median(ms[1:]),
                "launches": m1ts_counts}
    emit({"timeshard_mode1_rds": rep_m1ts, "card": card})
    if dec.pi != MODE1_PI:
        raise SystemExit(f"chip_smoke: the time-sharded MODE1_RDS receiver "
                         f"did not decode its PI: {rep_m1ts}")
    del outs, m1_blocks

    # ===== 11. the time-sharded receiver's other routes (not counted): the
    # 'split' ingest (K2 at stride 10 over normalized I/Q) against 'fused'
    # at T = 2, and MODE1 (audio only) at T = 4 against the serial MODE1
    # receiver — mono in every block, L / R from block 1 on (the pilot loops
    # acquire in block 0)
    fused_outs, _ = ts_run(cfg, ts_blocks[:3], 2)
    split_outs, _ = ts_run(cfg, ts_blocks[:3], 2, ingest_impl="split")
    rep_split = {"time_shards": 2, "blocks": 3,
                 **vs_serial(split_outs, fused_outs)}
    m1a_blocks = [torch.as_tensor(m1_station[b][None]).to(dev)
                  for b in range(3)]
    m1a_ser, _ = serial_run(MODE1, m1a_blocks)
    m1a_ts, _ = ts_run(MODE1, m1a_blocks, 4)
    m1a_err = max([max_err(o.mono, u.mono) for o, u in zip(m1a_ts, m1a_ser)]
                  + [max_err(getattr(o, n), getattr(u, n))
                     for o, u in zip(m1a_ts[1:], m1a_ser[1:])
                     for n in ("left", "right")])
    rep_routes = {"split_vs_fused_ingest": rep_split,
                  "mode1_audio_t4_max_abs_err_vs_serial": m1a_err,
                  "mode1_audio_tolerance": TOL_FUSED_AUDIO,
                  "mode1_rds_output": m1a_ts[0].rds}
    emit({"timeshard_routes": rep_routes, "card": card})
    if (not exact_ok(rep_split) or not m1a_err <= TOL_FUSED_AUDIO
            or m1a_ts[0].rds is not None):
        raise SystemExit(f"chip_smoke: a time-sharded route is wrong: "
                         f"{rep_routes}")
    del fused_outs, split_outs, m1a_ser, m1a_ts, m1a_blocks

    # ===== 12. checkpoint / resume on the card: each receiver's run of
    # 2 x N_CKPT_STEPS steps against N_CKPT_STEPS steps, save_state,
    # load_state into a fresh init_fn() on the card, N_CKPT_STEPS more —
    # every output bit for bit; each counted on its own
    def resume_check(label, init, step, blocks, per_step):
        """Continuous run against the resumed one; returns the report."""
        t0 = time.perf_counter()
        _cuda.reset_launch_counts()
        st, cont = init(), []
        for raw in blocks:
            st, out = step(st, raw)
            cont.append(out)
        st = init()
        for raw in blocks[:N_CKPT_STEPS]:
            st, _ = step(st, raw)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state.npz")
            t_io = time.perf_counter()
            save_state(path, st)
            keys = state_keys(st)
            st = load_state(path, init())
            io_s = time.perf_counter() - t_io
            file_bytes = os.path.getsize(path)
        resumed = []
        for raw in blocks[N_CKPT_STEPS:]:
            st, out = step(st, raw)
            resumed.append(out)
        counts = expect_counts(f"checkpoint {label}", 4 * N_CKPT_STEPS,
                               per_step)
        same = all(trees_equal(a, b) for a, b in
                   zip(cont[N_CKPT_STEPS:], resumed))
        on_card = all(leaf.is_cuda for leaf in _leaf_list(st))
        rep = {"steps_before": N_CKPT_STEPS, "steps_after": N_CKPT_STEPS,
               "outputs_bit_identical": same, "state_on_card": on_card,
               "keys": len(keys), "file_bytes": file_bytes,
               "save_load_seconds": io_s, "launches": counts,
               "seconds": time.perf_counter() - t0}
        if not same or not on_card:
            raise SystemExit(f"chip_smoke: checkpoint {label}: the resumed "
                             f"run differs from the continuous one: {rep}")
        return rep, keys

    t_ck = time.perf_counter()
    ck_blocks = [batch_block(b) for b in range(2 * N_CKPT_STEPS)]
    rx_ck = Receiver(cfg, (N_BATCH_CHANNELS,))
    rep_ck_mode0, ck_keys = resume_check(
        f"MODE0 C = {N_BATCH_CHANNELS}", rx_ck.init, rx_ck.step, ck_blocks,
        rds_per_step)
    rep_ck_mode0["channels"] = N_BATCH_CHANNELS
    if ck_keys != CHECKPOINT_KEYS:
        raise SystemExit(f"chip_smoke: checkpoint keys {ck_keys} are not "
                         f"the JAX package's {CHECKPOINT_KEYS}")
    ts_ck = make_time_sharded_receiver(
        cfg, make_mesh(1, CKPT_TS_SHARDS, devices=[dev]), N_BATCH_CHANNELS)
    rep_ck_ts, ts_keys = resume_check(
        f"time-sharded T = {CKPT_TS_SHARDS}", *ts_ck, ck_blocks,
        ts_per_step(CKPT_TS_SHARDS))
    rep_ck_ts.update(channels=N_BATCH_CHANNELS, time_shards=CKPT_TS_SHARDS,
                     keys_equal_serial=ts_keys == CHECKPOINT_KEYS)
    if ts_keys != CHECKPOINT_KEYS:
        raise SystemExit("chip_smoke: the time-sharded state's checkpoint "
                         f"keys are not the serial ones: {ts_keys}")
    del rx_ck, ts_ck, ck_blocks
    # the wideband phase's captures again (its blocks were freed): capture
    # 0 the band itself, captures 1.. under their own +-2 LSB of noise
    wb_ck_blocks = []
    for b in range(2 * N_CKPT_STEPS):
        rows = torch.as_tensor(wb_host[b]).to(dev).expand(
            WB_CAPTURES, -1).to(torch.int16)
        noise = torch.randint(-2, 3, rows.shape, generator=gen, device=dev,
                              dtype=torch.int16)
        noise[0] = 0
        wb_ck_blocks.append((rows + noise).clamp_(0, 255).to(torch.uint8))
    del rows, noise
    wb_ck = make_wideband_receiver(cfg, WB_K, (WB_CAPTURES,), **wb_kw)
    rep_ck_wb, _ = resume_check(
        f"wideband {WB_K} x {WB_CAPTURES}", *wb_ck, wb_ck_blocks,
        {"channelizer.composed": 1, "fir_bank.none": 2, "fir_bank.square": 1,
         "fir_bank.mul2": 1, "pll": 1, "resample_rrc": 1, "sync_walk": 1})
    rep_ck_wb.update(slots=WB_K, captures=WB_CAPTURES)
    del wb_ck, wb_ck_blocks
    torch.cuda.empty_cache()
    emit({"checkpoint": {"mode0": rep_ck_mode0, "timeshard": rep_ck_ts,
                         "wideband": rep_ck_wb, "keys": CHECKPOINT_KEYS,
                         "seconds": time.perf_counter() - t_ck},
          "card": card})

    # ===== 12b. the compiled step (utils/jit.py: the CUDA-graph
    # counterpart of jax.jit(step, donate_argnums=0)) against the eager
    # step with the same kernels in the same order, each path on the same
    # inputs: outputs and state bit for bit, launches per step per kernel
    # equal, one eager step under set_sync_debug_mode("error"), then the
    # host clock per step of both forms in turns (eager, compiled,
    # compiled, eager) and the compiled step's device time from events
    # around a burst of replays; each path counted on its own
    t_jit = time.perf_counter()

    def snap(tree):
        return [t.clone() for t in _leaf_list(tree)]

    def runs_differ(a, b):
        """(largest |a - b| over float leaves, integer leaves that differ)
        over two runs' per-step snapshots."""
        err, int_diff = 0.0, 0
        for xs, ys in zip(a, b):
            for x, y in zip(xs, ys):
                if x.dtype.is_floating_point:
                    err = max(err, max_err(x, y))
                elif not torch.equal(x, y):
                    int_diff += 1
        return err, int_diff

    def jit_run(init, step, blocks, mid=None):
        """Snapshots of every step's state and outputs; ``mid()`` runs
        between the first and second halves of the blocks.  Also returns
        the host ms of the first step (a compiled step's warm-ups and
        capture)."""
        st, states, outs = init(), [], []
        for b, raw in enumerate(blocks):
            if mid is not None and b == len(blocks) // 2:
                mid()
            t0 = time.perf_counter()
            st, out = step(st, raw)
            if b == 0:
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t0) * 1e3
            states.append(snap(st))
            outs.append(snap(out))
        torch.cuda.synchronize()
        return st, states, outs, first_ms

    def device_launches(fn, steps=2):
        """Device events (kernels, copies, fills) per call of ``fn`` in a
        profiler trace, counted as ``tools/torch_profile_step.py`` counts
        them."""
        fn()
        torch.cuda.synchronize()
        with trace_mod.profile() as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        n = 0
        for e in prof.key_averages():
            us = max((float(getattr(e, k)) for k in (
                "self_device_time_total", "self_cuda_time_total")
                if hasattr(e, k)), default=0.0)
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                n += e.count
        return n / steps

    def host_ms(init, step, blocks, st=None):
        st = init() if st is None else st
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for raw in blocks:
            st, _ = step(st, raw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(blocks), st

    def jit_path(label, make, blocks, tol=0.0, mid=None):
        """``make(jit)`` -> (init, step); the path's report."""
        e_init, e_step = make(False)
        c_init, c_step = make(True)
        if not isinstance(c_step, (jit_mod.CompiledStep,
                                   jit_mod.ComposedStep)):
            raise SystemExit(f"chip_smoke: jit path {label} is not compiled")
        n = len(blocks)
        _cuda.reset_launch_counts()
        e_st, e_states, e_outs, e_first = jit_run(e_init, e_step, blocks)
        e_counts = _cuda.launch_counts()
        # a steady eager step (its caches filled by the run) makes no host
        # synchronisation
        torch.cuda.set_sync_debug_mode("error")
        try:
            e_st, _ = e_step(e_st, blocks[-1])
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _cuda.reset_launch_counts()
        c_st, c_states, c_outs, c_first = jit_run(c_init, c_step, blocks,
                                                  mid)
        c_counts = _cuda.launch_counts()
        s_err, s_int = runs_differ(c_states, e_states)
        o_err, o_int = runs_differ(c_outs, e_outs)
        per_step = {k: v // n for k, v in e_counts.items()}
        counts_ok = (c_step.per_step == per_step
                     and c_counts == {k: v * n for k, v in per_step.items()}
                     and all(v % n == 0 for v in e_counts.values()))
        hb = blocks * max(1, JIT_HOST_STEPS // n)
        e_ms1, e_st = host_ms(e_init, e_step, hb, e_st)
        c_ms1, c_st = host_ms(c_init, c_step, hb, c_st)
        c_ms2, c_st = host_ms(c_init, c_step, hb, c_st)
        e_ms2, e_st = host_ms(e_init, e_step, hb, e_st)
        held = [c_st]

        def replay():
            held[0], _ = c_step.borrowed(held[0], blocks[-1])
        graph_ms = burst_ms(replay, calls=10, reps=3)
        e_held = [e_st]

        def eager_step():
            e_held[0], _ = e_step(e_held[0], blocks[-1])
        dl_eager = device_launches(eager_step)
        dl_compiled = device_launches(replay)
        e_st = e_held[0]
        rep = {"path": label, "steps": n,
               "state_max_abs_err": s_err, "state_int_leaves_differing": s_int,
               "outputs_max_abs_err": o_err,
               "outputs_int_leaves_differing": o_int, "tolerance": tol,
               "state_leaves": len(c_states[0]),
               "output_leaves": len(c_outs[0]),
               "launches_per_step_eager": per_step,
               "launches_per_step_compiled": c_step.per_step,
               "launch_counts_equal": counts_ok,
               "eager_step_under_sync_debug_error": "passed",
               "host_ms_per_step_eager": [e_ms1, e_ms2],
               "host_ms_per_step_compiled": [c_ms1, c_ms2],
               "host_steps_timed": len(hb),
               "compiled_device_ms_per_step_events": graph_ms,
               "device_launches_per_step_eager": dl_eager,
               "device_launches_per_step_compiled": dl_compiled,
               "first_step_host_ms_eager": e_first,
               "first_step_host_ms_compiled_with_capture": c_first}
        if (s_int or o_int or not s_err <= tol or not o_err <= tol
                or not counts_ok):
            raise SystemExit(f"chip_smoke: the compiled step differs from "
                             f"the eager one: {rep}")
        # the live state: the burst's replays consumed c_st
        return rep, c_init, c_step, held[0]

    jit_rows = []
    mesh_j = make_mesh(1, 1, devices=[dev])
    st_blocks = [torch.as_tensor(station[b]).to(dev)
                 for b in range(N_STREAM_BLOCKS)]

    # the cache flood, between the two halves of the MODE0 C = 1 run:
    # more than 2 x 64 new tap sets through the FIR-bank and PLL wrappers
    # (every DeviceCache turns over twice), then the freed memory filled
    # with NaN before the graph replays again
    def flood():
        saved = _cuda.launch_counts()     # not the path's launches
        x = torch.randn(1, 4096, device=dev)
        zi = torch.zeros(1, taps - 1, device=dev)
        for k in range(N_JIT_FLOOD):
            h = np.random.default_rng(k).standard_normal(taps)
            cuda_fir.fir_bank_carried(x, [h], zi, 1)
            cuda_pll.pll_cuda(x, pll_init((1,), device=dev),
                              freq=np.array([19e3 + k]), fs=cfg.rf.if_fs)
        torch.cuda.synchronize()
        junk = [torch.full((1 << k,), float("nan"), device=dev)
                for k in range(4, 22) for _ in range(8)]
        torch.cuda.synchronize()
        del junk
        _cuda.LAUNCHES.clear()
        _cuda.LAUNCHES.update(saved)

    rep, c_init, c_step, c_st = jit_path(
        "MODE0 C = 1, resync, cache flood at the middle",
        lambda j: (lambda rx: (rx.init, rx.step))(
            Receiver(cfg, (), resync=True, jit=j)),
        st_blocks, mid=flood)
    rep["cache_flood_tap_sets"] = N_JIT_FLOOD
    jit_rows.append(rep)
    # the resync walk is one launch (K7), not ~1,430 stock ops
    if not (rep["device_launches_per_step_compiled"]
            <= MAX_C1_RESYNC_DEVICE_LAUNCHES):
        raise SystemExit(
            f"chip_smoke: the MODE0 C = 1 resync step issues "
            f"{rep['device_launches_per_step_compiled']} device launches, "
            f"more than {MAX_C1_RESYNC_DEVICE_LAUNCHES}")
    # a donated tree raises; a checkpoint loads into the compiled receiver
    s1, _ = c_step(c_init(), st_blocks[0])
    s2, _ = c_step(s1, st_blocks[1])
    try:
        c_step(s1, st_blocks[2])
        raise SystemExit("chip_smoke: a consumed state tree stepped")
    except RuntimeError as e:
        consumed = str(e)[:120]
    # ... and reading it fails: its tensors were emptied, the live one's
    # were not
    if (any(t.numel() for t in _leaf_list(s1))
            or not all(t.numel() for t in _leaf_list(s2))):
        raise SystemExit("chip_smoke: a consumed state tree still reads")
    e_init, e_step = make_receiver(cfg, (), resync=True)
    st, ck_ref = e_init(), []
    for raw in st_blocks[:2 * N_CKPT_STEPS]:
        st, out = e_step(st, raw)
        ck_ref.append(snap(out))
    st = c_init()
    for raw in st_blocks[:N_CKPT_STEPS]:
        st, _ = c_step(st, raw)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_state(path, st)
        st = load_state(path, c_init())
    ck_same = True
    for b, raw in enumerate(st_blocks[N_CKPT_STEPS:2 * N_CKPT_STEPS]):
        st, out = c_step(st, raw)
        ck_same = ck_same and all(
            torch.equal(x, y) for x, y in zip(snap(out),
                                              ck_ref[N_CKPT_STEPS + b]))
    if not ck_same:
        raise SystemExit("chip_smoke: a checkpoint loaded into the compiled "
                         "receiver does not resume bit for bit")
    del c_init, c_step, c_st, s1, s2, st, ck_ref

    jit_rows.append(jit_path(
        f"MODE0 C = {N_BATCH_CHANNELS}",
        lambda j: (lambda rx: (rx.init, rx.step))(
            Receiver(cfg, (N_BATCH_CHANNELS,), jit=j)),
        [batch_block(b) for b in range(N_BATCH_STEPS)])[0])
    torch.cuda.empty_cache()
    jit_rows.append(jit_path(
        f"MODE0 audio only C = {N_BATCH_CHANNELS}",
        lambda j: (lambda rx: (rx.init, rx.step))(
            Receiver(cfg, (N_BATCH_CHANNELS,), enable_rds=False, jit=j)),
        [batch_block(b) for b in range(N_BATCH_STEPS)])[0])
    torch.cuda.empty_cache()
    jit_rows.append(jit_path(
        "MODE1_RDS C = 1, resync",
        lambda j: (lambda rx: (rx.init, rx.step))(
            Receiver(cfg1, (), resync=True, jit=j)),
        [torch.as_tensor(m1_station[b]).to(dev)
         for b in range(N_JIT_M1_BLOCKS)], tol=TOL_JIT_MATMUL)[0])
    jwb_blocks = []
    for b in range(N_JIT_WB_STEPS):
        rows = torch.as_tensor(wb_host[b]).to(dev).expand(
            WB_CAPTURES, -1).to(torch.int16)
        noise = torch.randint(-2, 3, rows.shape, generator=gen, device=dev,
                              dtype=torch.int16)
        noise[0] = 0
        jwb_blocks.append((rows + noise).clamp_(0, 255).to(torch.uint8))
    del rows, noise

    def wideband_jit(j):
        init, step = make_wideband_receiver(cfg, WB_K, (WB_CAPTURES,),
                                            **wb_kw)
        return jit_mod.jit_step(init, step, dev) if j else (init, step)

    jit_rows.append(jit_path(f"wideband {WB_K} x {WB_CAPTURES}, resync",
                             wideband_jit, jwb_blocks)[0])

    # the wideband-sharded step as two compiled parts on this card (the
    # code a mesh over two GPUs runs, but for the peer copies): the
    # channelizer's part hands the other its slots' I/Q
    def wideband_two_parts(j):
        init, step = make_wideband_receiver(
            cfg, WB_K, (WB_CAPTURES,), channel_sharding=[dev, dev],
            device=dev, **wb_kw)
        if not j:
            return init, step
        return init, compose_wideband(init, step, [(dev, [0]), (dev, [1])],
                                      "wideband-sharded, two parts")

    jit_rows.append(jit_path(
        f"wideband-sharded two-part composition {WB_K} x {WB_CAPTURES}, "
        "resync", wideband_two_parts, jwb_blocks)[0])
    del jwb_blocks
    torch.cuda.empty_cache()
    jit_rows.append(jit_path(
        f"channel-sharded one-card mesh C = {N_BATCH_CHANNELS}",
        lambda j: make_channel_sharded_receiver(
            cfg, mesh_j, N_BATCH_CHANNELS, jit=j)[:2],
        [batch_block(b) for b in range(N_BATCH_STEPS)])[0])
    torch.cuda.empty_cache()
    jit_rows.append(jit_path(
        f"time-sharded stacked C = {N_BATCH_CHANNELS}, T = {JIT_TS_T}, "
        "exact",
        lambda j: make_time_sharded_receiver(
            cfg, make_mesh(1, JIT_TS_T, devices=[dev]), N_BATCH_CHANNELS,
            jit=j),
        [batch_block(b) for b in range(N_TS_BATCH_STEPS)])[0])
    torch.cuda.empty_cache()

    # the spread route (one stream per time shard of this card): one graph
    # holds the T forked branches.  C = 1 with resync and the cache flood
    # between the halves, C = 1,024 exact and stale, MODE1_RDS
    spread_j = make_mesh(1, JIT_TS_T, devices=[dev] * JIT_TS_T)
    rep = jit_path(
        f"time-sharded spread C = 1, T = {JIT_TS_T}, resync, cache flood "
        "at the middle",
        lambda j: make_time_sharded_receiver(cfg, spread_j, 1, resync=True,
                                             jit=j),
        [b[None] for b in st_blocks[:N_JIT_SPREAD_BLOCKS]], mid=flood)[0]
    rep["cache_flood_tap_sets"] = N_JIT_FLOOD
    jit_rows.append(rep)
    for handoff in ("exact", "stale"):
        jit_rows.append(jit_path(
            f"time-sharded spread C = {N_BATCH_CHANNELS}, T = {JIT_TS_T}, "
            f"{handoff}",
            lambda j, h=handoff: make_time_sharded_receiver(
                cfg, spread_j, N_BATCH_CHANNELS, pll_handoff=h, jit=j),
            [batch_block(b) for b in range(N_TS_BATCH_STEPS)])[0])
        torch.cuda.empty_cache()
    jit_rows.append(jit_path(
        f"time-sharded spread MODE1_RDS C = 1, T = {JIT_TS_T}, resync",
        lambda j: make_time_sharded_receiver(cfg1, spread_j, 1, resync=True,
                                             jit=j),
        [torch.as_tensor(m1_station[b][None]).to(dev)
         for b in range(N_JIT_M1_BLOCKS)])[0])
    # the channel-sharded receiver as two compiled parts on this card, one
    # shard each (the composition a mesh over two GPUs builds, but for the
    # peer copies)
    halves = row_split(N_BATCH_CHANNELS, 2)

    def channels_two_parts(j):
        shards = [make_receiver(cfg, (N_BATCH_CHANNELS // 2,), device=dev)
                  for _ in halves]
        return shard_rows([s[0] for s in shards], [s[1] for s in shards],
                          halves, [dev, dev], j,
                          "channel-sharded receiver, two parts",
                          groups=[(dev, [0]), (dev, [1])])

    jit_rows.append(jit_path(
        f"channel-sharded two-part composition C = {N_BATCH_CHANNELS}",
        channels_two_parts,
        [batch_block(b) for b in range(N_BATCH_STEPS)])[0])
    torch.cuda.empty_cache()
    # the same two shards as one graph (a mesh naming this card twice):
    # what the composition's device time is set against
    jit_rows.append(jit_path(
        f"channel-sharded two shards, one graph, C = {N_BATCH_CHANNELS}",
        lambda j: make_channel_sharded_receiver(
            cfg, make_mesh(2, 1, devices=[dev, dev]), N_BATCH_CHANNELS,
            jit=j)[:2],
        [batch_block(b) for b in range(N_BATCH_STEPS)])[0])
    torch.cuda.empty_cache()

    # MODE0 C = 4,096 (device-bound): the compiled step given the block
    # already written into its static input buffer (as the runners write
    # each block) against the eager step given its own tensor, and the
    # compiled step given its own tensor (one device copy into that
    # buffer) and its borrowed form (no output copies, the runners');
    # the forms in turns, then in reverse, host clock per step and device
    # time by events around a burst
    wide_blocks = [batch_block(b, N_JIT_WIDE) for b in range(2)]
    rep, _, w_step, w_st = jit_path(
        f"MODE0 C = {N_JIT_WIDE}",
        lambda j: (lambda rx: (rx.init, rx.step))(
            Receiver(cfg, (N_JIT_WIDE,), jit=j)), wide_blocks)
    e_init, e_step = make_receiver(cfg, (N_JIT_WIDE,))
    own = wide_blocks[-1]
    buf = w_step.input_buffer(own.shape)
    buf.copy_(own)
    forms = {"eager": (e_step, own),
             "compiled, input in place": (w_step, buf),
             "compiled, own input tensor": (w_step, own),
             "compiled borrowed, input in place": (w_step.borrowed, buf)}
    wide_st = {"eager": e_init(), "compiled": w_st}
    wide_host = {k: [] for k in forms}
    wide_dev = {k: [] for k in forms}
    for order in (list(forms), list(forms)[::-1]):
        for k in order:
            fn, raw = forms[k]
            key = "eager" if k == "eager" else "compiled"
            ms, wide_st[key] = host_ms(None, fn, [raw] * JIT_HOST_STEPS,
                                       wide_st[key])
            wide_host[k].append(ms)

            def one(fn=fn, raw=raw, key=key):
                wide_st[key], _ = fn(wide_st[key], raw)
            wide_dev[k].append(burst_ms(one, calls=10, reps=3))
    rep["in_place"] = {"host_ms_per_step": wide_host,
                       "device_ms_per_step_events": wide_dev,
                       "steps_per_host_timing": JIT_HOST_STEPS}
    jit_rows.append(rep)
    del wide_blocks, w_step, w_st, e_step, own, buf, forms, wide_st
    torch.cuda.empty_cache()
    emit({"jit": {"paths": jit_rows, "consumed_tree_raised": consumed,
                  "checkpoint_into_compiled_bit_for_bit": ck_same,
                  "seconds": time.perf_counter() - t_jit}, "card": card})

    # ===== 13. the per-stage table (utils/profiling.py) at C = 1,024, each
    # stage compiled (jit_fn) as the JAX table jits it: each must have
    # replayed a graph
    t_st = time.perf_counter()
    real_jit_fn, st_made = prof_mod.jit_fn, []
    prof_mod.jit_fn = lambda *a, **k: (st_made.append(real_jit_fn(*a, **k))
                                       or st_made[-1])
    try:
        st_recs = stage_timings(cfg, N_BATCH_CHANNELS, device="cuda")
    finally:
        prof_mod.jit_fn = real_jit_fn
    st_graphs = [f._graph is not None for f in st_made]
    del st_made
    for rec in st_recs:
        rec["card"] = card
        rec["compiled"] = True
        emit({"stage_timings": rec})
    if (len(st_recs) != 8 or st_graphs != [True] * 8 or not all(
            np.isfinite(r["sec_per_block_batch"]) for r in st_recs)):
        raise SystemExit(f"chip_smoke: stage_timings wrong: {st_recs} "
                         f"(graphs replayed: {st_graphs})")
    emit({"stage_timings_seconds": time.perf_counter() - t_st, "card": card})
    torch.cuda.empty_cache()

    # ===== 14. one MODE0 step under utils/trace.py: the Chrome trace holds
    # K1-K4 as device events
    t_tr = time.perf_counter()
    sys.path.insert(0, os.path.join(here, "tools"))
    from torch_trace_check import TRACE_KERNELS, trace_step

    rx_tr = Receiver(cfg, (N_BATCH_CHANNELS,))
    tr_raw = batch_block(0)
    st_tr, _ = rx_tr.step(rx_tr.init(), tr_raw)            # warm-up
    torch.cuda.synchronize()
    st_tr, rep_tr = trace_step(rx_tr.step, st_tr, batch_block(1))
    rep_tr.update(channels=N_BATCH_CHANNELS, kernel_names=TRACE_KERNELS,
                  process_seconds=time.perf_counter() - t_start,
                  seconds=time.perf_counter() - t_tr)
    emit({"trace": rep_tr, "card": card})
    if not rep_tr["all_seen"]:
        raise SystemExit(f"chip_smoke: the trace does not show K1-K4 on "
                         f"the card: {rep_tr}")
    del rx_tr, st_tr

    # ===== 15. what had never run on the card: BatchRunner at 1,024
    # stations (one capture file per station), a wideband capture from a
    # pipe through the CLI, the wideband receiver at K = 8 and 32
    import resource

    t_br = time.perf_counter()
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want_fds = N_BATCH_CHANNELS + 256
    if soft != resource.RLIM_INFINITY and soft < want_fds:
        resource.setrlimit(resource.RLIMIT_NOFILE, (
            want_fds if hard == resource.RLIM_INFINITY
            else min(want_fds, hard), hard))
    br_blocks = [batch_block(b) for b in range(N_RUNNER_1024_BLOCKS)]
    br_host = torch.stack(br_blocks, dim=1).cpu().numpy()     # (C, b, B)
    got = [[] for _ in range(N_BATCH_CHANNELS)]
    frames = [[] for _ in range(N_BATCH_CHANNELS)]
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        try:
            for c in range(N_BATCH_CHANNELS):
                path = os.path.join(tmp, f"station{c}.iq")
                br_host[c].tofile(path)
                files.append(open(path, "rb"))
            with BatchRunner(cfg, [f.fileno() for f in files]) as runner:
                # ============ the 1,024-station BatchRunner: counts from 0
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                br_stats = runner.run(
                    emit=lambda c, left, right: got[c].append(
                        (left.copy(), right.copy())),
                    rds_hook=lambda c, fo: frames[c].append(
                        type(fo)(*(np.array(x) for x in fo))))
                br_s = time.perf_counter() - t0
                br_counts = expect_counts("BatchRunner 1,024",
                                          N_RUNNER_1024_BLOCKS, rds_per_step)
                # ============ end of the 1,024-station BatchRunner
        finally:
            for f in files:
                f.close()
    rx_br = Receiver(cfg, (N_BATCH_CHANNELS,))
    st_br, br_equal, frames_equal = rx_br.init(), True, True
    for b, raw in enumerate(br_blocks):
        st_br, out = rx_br.step(st_br, raw)
        left, right = out.left.cpu().numpy(), out.right.cpu().numpy()
        fo = [x.cpu().numpy() for x in out.rds]
        for c in range(N_BATCH_CHANNELS):
            br_equal = (br_equal and np.array_equal(got[c][b][0], left[c])
                        and np.array_equal(got[c][b][1], right[c]))
            frames_equal = frames_equal and all(
                np.array_equal(x, y[c]) for x, y in zip(frames[c][b], fo))
    rep_br = {"stations": N_BATCH_CHANNELS, "blocks": N_RUNNER_1024_BLOCKS,
              "stats": br_stats, "every_station_equals_its_row":
              br_equal, "frames_equal_rows": frames_equal,
              "syncs_all_stations": int(sum(
                  fo.is_sync.sum() for fr in frames for fo in fr)),
              "ms_per_block": br_s * 1e3 / N_RUNNER_1024_BLOCKS,
              "launches": br_counts, "rlimit_nofile": resource.getrlimit(
                  resource.RLIMIT_NOFILE)[0],
              "seconds": time.perf_counter() - t_br}
    emit({"batch_runner_1024": rep_br, "card": card})
    if (br_stats != {"blocks": N_RUNNER_1024_BLOCKS,
                     "stations": N_BATCH_CHANNELS}
            or not br_equal or not frames_equal):
        raise SystemExit(f"chip_smoke: BatchRunner at {N_BATCH_CHANNELS} "
                         f"stations wrong: {rep_br}")
    del rx_br, st_br, br_blocks, br_host, got, frames
    torch.cuda.empty_cache()

    # a wideband capture through `cli 0 --wideband 16` from a file and
    # from a pipe (written in 64 KiB pieces): the same wavs
    t_pp = time.perf_counter()
    wb_flags = ("--wideband", str(WB_K), "--no-rds")

    def wav_bytes(d):
        out = {}
        for c in range(WB_K):
            with wave_mod.open(os.path.join(d, f"channel{c}.wav"), "rb") as wv:
                out[c] = wv.readframes(wv.getnframes())
        return out

    with tempfile.TemporaryDirectory() as tmp:
        d_file, d_pipe = os.path.join(tmp, "file"), os.path.join(tmp, "pipe")
        os.makedirs(d_file)
        os.makedirs(d_pipe)
        iq_path = os.path.join(tmp, "band.iq")
        wb_host[:N_PIPE_BLOCKS].tofile(iq_path)
        cli_file = run_cli(iq_path, *wb_flags, cwd=d_file)
        env = dict(os.environ)
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        payload = wb_host[:N_PIPE_BLOCKS].tobytes()
        err_path = os.path.join(tmp, "pipe.err")
        with open(err_path, "wb") as err_f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "rtsdr_tpu_torch.cli", "0",
                 *wb_flags], stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=err_f, cwd=d_pipe, env=env)
            try:
                for i in range(0, len(payload), 1 << 16):
                    proc.stdin.write(payload[i:i + (1 << 16)])
            finally:
                proc.stdin.close()
            pipe_rc = proc.wait(timeout=600)
        with open(err_path, "rb") as f:
            pipe_err = f.read()
        same_wavs = (cli_file.returncode == 0 and pipe_rc == 0
                     and wav_bytes(d_file) == wav_bytes(d_pipe))
        wav_len = (len(wav_bytes(d_file)[0])
                   if cli_file.returncode == 0 else 0)
    rep_pipe = {"slots": WB_K, "blocks": N_PIPE_BLOCKS,
                "file_returncode": cli_file.returncode,
                "pipe_returncode": pipe_rc, "wav_bytes_identical": same_wavs,
                "wav_bytes_per_channel": wav_len,
                "expected_wav_bytes_per_channel": N_PIPE_BLOCKS * n_audio * 4,
                "pipe_stderr_tail": pipe_err.decode().splitlines()[-2:],
                "seconds": time.perf_counter() - t_pp}
    emit({"wideband_pipe": rep_pipe, "card": card})
    if not same_wavs or wav_len != N_PIPE_BLOCKS * n_audio * 4:
        raise SystemExit(f"chip_smoke: the wideband capture from a pipe "
                         f"differs from the file's: {rep_pipe} "
                         f"{cli_file.stderr.decode()[-1000:]}")

    # the wideband receiver at K = 8 and 32: each station's tones in its
    # own channel; in every other slot a live station's tone reads what the
    # plain path reads there, and stays under the K = 16 phase's limit
    def stray_tones(left_k, stations):
        return {c: max(tone(left_k[c], kw.get("mono_hz", 1.1e3))
                       for kw in stations.values())
                for c in range(left_k.shape[0]) if c not in stations}

    wb_other = {}
    for k_, stations in WB_OTHER_K.items():
        t_k = time.perf_counter()
        cap = wideband_capture_iq(N_WB_OTHER_BLOCKS * cfg.iq_len, k_,
                                  stations, cfg.rf.fs
                                  ).reshape(N_WB_OTHER_BLOCKS, -1)
        syn_s = time.perf_counter() - t_k
        init_k, step_k = make_wideband_receiver(cfg, k_)
        cap_dev = torch.as_tensor(cap).to(dev)
        step_k(init_k(), cap_dev[0])                        # warm-up
        torch.cuda.synchronize()
        # ==================== the wideband K path: counts from 0 here
        _cuda.reset_launch_counts()
        st_k, ls, rs = init_k(), [], []
        for b in range(N_WB_OTHER_BLOCKS):
            st_k, out = step_k(st_k, cap_dev[b])
            ls.append(out.left.cpu().numpy())
            rs.append(out.right.cpu().numpy())
        k_counts = expect_counts(
            f"wideband K = {k_}", N_WB_OTHER_BLOCKS,
            {"channelizer.composed": 1, "fir_bank.none": 2,
             "fir_bank.square": 1, "fir_bank.mul2": 1, "pll": 1,
             "resample_rrc": 1})
        # ============================== end of the wideband K path
        left = np.concatenate(ls, axis=-1)[:, n_audio:]
        right = np.concatenate(rs, axis=-1)[:, n_audio:]
        tones_k, ok_k = {}, bool(np.isfinite(left).all())
        for slot, kw in stations.items():
            got_t = {"mono_in_L+R": tone(left[slot] + right[slot],
                                         kw.get("mono_hz", 1.1e3)),
                     "stereo_in_L-R": tone(left[slot] - right[slot],
                                           kw.get("stereo_hz", 2.3e3))}
            want_t = {"mono_in_L+R": 0.88, "stereo_in_L-R": 0.83}
            tones_k[slot] = got_t
            ok_k = ok_k and all(abs(got_t[n] - want_t[n]) < 0.1 * want_t[n]
                                for n in got_t)
        t_plain = time.perf_counter()
        init_p, step_p = make_wideband_receiver(cfg, k_, dtype=torch.float64,
                                                device="cpu")
        st_p, ls_p = init_p(), []
        for b in range(N_WB_OTHER_BLOCKS):
            st_p, out_p = step_p(st_p, torch.as_tensor(cap[b]))
            ls_p.append(out_p.left.numpy())
        plain_s = time.perf_counter() - t_plain
        strays = stray_tones(left, stations)
        strays_plain = stray_tones(
            np.concatenate(ls_p, axis=-1)[:, n_audio:], stations)
        stray_k = max(strays.values())
        stray_vs_plain = max(abs(strays[c] - strays_plain[c])
                             for c in strays)
        wb_other[k_] = {"slots": k_, "blocks": N_WB_OTHER_BLOCKS,
                        "live_slots": sorted(stations),
                        "tone_amplitudes": tones_k,
                        "expected": {"mono_in_L+R": 0.88,
                                     "stereo_in_L-R": 0.83,
                                     "within": "10%"},
                        "max_live_tone_in_an_other_slot_left": stray_k,
                        "other_slot_limit": 0.15,
                        "live_tone_by_other_slot": strays,
                        "live_tone_by_other_slot_plain_f64": strays_plain,
                        "max_abs_err_vs_plain": stray_vs_plain,
                        "tolerance_vs_plain": TOL_STRAY,
                        "launches": k_counts, "synthesis_seconds": syn_s,
                        "plain_cpu_seconds": plain_s,
                        "seconds": time.perf_counter() - t_k}
        if not ok_k or stray_k >= 0.15 or not stray_vs_plain <= TOL_STRAY:
            raise SystemExit(f"chip_smoke: wideband K = {k_} wrong: "
                             f"{wb_other[k_]}")
        del init_k, step_k, st_k, cap_dev
    emit({"wideband_other_k": wb_other, "card": card})
    torch.cuda.empty_cache()

    # ===== 16. the decode campaign (tools/torch_decode_campaign.py) on the
    # card: clean and 15 dB SNR at CLI defaults, +200 Hz pilot detune at
    # CLI defaults and with the robust clock; the CPU tests' thresholds
    # (tests/test_torch_golden_campaign.py)
    t_cp = time.perf_counter()
    sys.path.insert(0, os.path.join(here, "tools"))
    import torch_decode_campaign as dcamp

    cp_names = ["clean", "snr15", "detune+200"]
    cp_streams = {n: dcamp.synth_impaired(N_CAMPAIGN_BLOCKS,
                                          dcamp.SCENARIOS[n])
                  for n in cp_names}
    cp_syn_s = time.perf_counter() - t_cp
    _cuda.reset_launch_counts()
    cp_rows = dcamp.campaign(cp_names, N_CAMPAIGN_BLOCKS, device="cuda",
                             streams=cp_streams)
    cp_rows += dcamp.campaign(["detune+200"], N_CAMPAIGN_BLOCKS,
                              clock="gardner", derotate=True, device="cuda",
                              streams=cp_streams)
    cp_counts = expect_counts("campaign", 2 * N_CAMPAIGN_BLOCKS, rds_per_step,
                              walks=2 * N_CAMPAIGN_BLOCKS)
    cp = {r["scenario"]: r for r in cp_rows}
    cp_ok = (all(cp[n]["rx_groups"] >= cp[n]["tx_groups"] - 2
                 for n in ("clean", "snr15"))
             and cp["detune+200"]["rx_groups"] <= 1
             and cp["detune+200/robust"]["rx_groups"] >= 3)
    # the golden column beside the card's yield: tests/torch_oracles.py on
    # the host, outside the counted window, held to campaign_r5.json's
    t_gold = time.perf_counter()
    for n in cp_names:
        g_syncs, g_groups = dcamp.golden_yield(cp_streams[n][0],
                                               N_CAMPAIGN_BLOCKS)
        cp[n].update(golden_syncs=g_syncs, golden_groups=g_groups,
                     golden_record=list(GOLDEN_CAMPAIGN[n]))
    gold_s = time.perf_counter() - t_gold
    gold_ok = all((cp[n]["golden_syncs"], cp[n]["golden_groups"])
                  == GOLDEN_CAMPAIGN[n] for n in cp_names)
    emit({"campaign": {"rows": cp_rows, "blocks": N_CAMPAIGN_BLOCKS,
                       "thresholds": "clean, snr15: groups >= tx - 2; "
                       "detune+200: <= 1 at CLI defaults, >= 3 robust; "
                       "golden column equal to campaign_r5.json's",
                       "synthesis_seconds": cp_syn_s,
                       "golden_host_seconds": gold_s, "launches": cp_counts,
                       "seconds": time.perf_counter() - t_cp},
          "card": card})
    if not cp_ok or not gold_ok:
        raise SystemExit(f"chip_smoke: the decode campaign is off: {cp_rows}")

    # ===== 17. the channel sweep (tools/torch_scaling_sweep.py) at C = 1,
    # 1,024 and 4,096, mono and full, the block in the step's input buffer;
    # then one block's trip through the compiled StreamRunner at C = 1
    import torch_bench_ingest as bingest
    import torch_pll_envelope as penv
    import torch_scaling_sweep as sweep

    t_sc = time.perf_counter()
    sc_steps = (sweep.K1 + sweep.K2) * (1 + SCALING_REPEATS)
    sc_rows, sc_counts = {}, {}
    for chain in sweep.CHAINS:
        _cuda.reset_launch_counts()
        sc_rows[chain] = sweep.sweep_chain(chain, SCALING_CHANNELS, dev,
                                           repeats=SCALING_REPEATS, card=card)
        # each count's receiver made as many steps; the full chain's are
        # the RDS path's, the mono chain's run the ingest kernel
        per_step = (rds_per_step if chain == "full"
                    else {"ingest.fm_audio": 1})
        sc_counts[chain] = expect_counts(
            f"scaling {chain}", sc_steps * len(SCALING_CHANNELS), per_step)
    _cuda.reset_launch_counts()
    lat = sweep.stream_latency(dev, N_LATENCY_RUNS, card=card)[
        "stream_latency"]
    # the runs and the one before them that takes the capture
    n_lat = (N_LATENCY_RUNS + 1) * lat["blocks_per_run"]
    lat["launches"] = expect_counts("stream latency", n_lat, rds_per_step,
                                    walks=n_lat)
    rep_sc = {"chains": sc_rows, "knee": {c: sweep.knee(r)
                                          for c, r in sc_rows.items()},
              "repeats": SCALING_REPEATS, "steps_per_count": sc_steps,
              "launches": sc_counts, "stream_latency": lat,
              "input": "written once into step.input_buffer",
              "seconds": time.perf_counter() - t_sc}
    emit({"scaling": rep_sc, "card": card})
    sc_ok = (all(r["fits"] and np.isfinite(r["ms_per_step"])
                 and r["ms_per_step"] > 0 for rs in sc_rows.values()
                 for r in rs)
             and all([r["channels"] for r in rs] == list(SCALING_CHANNELS)
                     for rs in sc_rows.values())
             and lat["int16_bytes_out"] == lat["int16_bytes_expected"]
             and all(np.isfinite(x) and x > 0 for x in lat["last_block_ms"]))
    if not sc_ok:
        raise SystemExit(f"chip_smoke: the channel sweep is off: {rep_sc}")
    torch.cuda.empty_cache()

    # ===== 18. ingest (tools/torch_bench_ingest.py): N pipes through the
    # C++ readers into one pinned staging array, then 1,024 pipes on into a
    # compiled function's input buffer, and the (1,024, 307,200) copy
    # against the compiled step
    t_in = time.perf_counter()
    in_rows = [bingest.run_one(n, N_INGEST_BLOCKS, cfg.block_size,
                               device="pinned") for n in INGEST_PIPES]
    in_rows.append(bingest.run_one(INGEST_DEVICE_ROWS, N_INGEST_DEVICE_BLOCKS,
                                   cfg.block_size, device="cuda"))
    for r in in_rows:
        r["scaling_eff"] = (r["gb_per_s"] / r["pipes"]) / in_rows[0]["gb_per_s"]
    _cuda.reset_launch_counts()
    cvs = bingest.copy_vs_step(INGEST_DEVICE_ROWS, dev)["copy_vs_step"]
    cvs["launches"] = expect_counts(
        "copy against step", (sweep.K1 + sweep.K2) * (1 + 3), rds_per_step)
    rep_in = {"runs": in_rows, "copy_vs_step": cvs,
              "seconds": time.perf_counter() - t_in}
    emit({"ingest": rep_in, "card": card})
    in_ok = (all(r["blocks"] == r["blocks_written"]
                 and r["bytes"] == r["bytes_written"]
                 and r["last_rows_equal_written"]
                 and r["writer_threads_alive_after"] == 0
                 and np.isfinite(r["gb_per_s"]) and r["gb_per_s"] > 0
                 for r in in_rows)
             and in_rows[-1]["device_sum_equal"] is True
             and cvs["copied_equal"]
             and all(np.isfinite(cvs[k]) and cvs[k] > 0
                     for k in ("h2d_copy_ms", "step_ms")))
    if not in_ok:
        raise SystemExit(f"chip_smoke: ingest is off: {rep_in}")
    torch.cuda.empty_cache()

    # ===== 19. the PLL loop-rate envelope (tools/torch_pll_envelope.py):
    # the full grid on the card, K2 and K3 (loop_div 1, 2, 4) at 36 lanes;
    # then the same grid at 2 blocks on the card against the plain versions
    t_pe = time.perf_counter()
    _cuda.reset_launch_counts()
    env = penv.envelope(device=dev)
    n_env = len(penv.INSTANCES) * len(penv.DIVS) * penv.BLOCKS
    env_counts = expect_counts("PLL envelope", n_env,
                               {"fir_bank.none": 1, "pll": 1})
    env_summary = penv.summary(env)
    t_cpu = time.perf_counter()
    chk = {d: penv.envelope(N_ENVELOPE_CHECK_BLOCKS, device=d)
           for d in (dev, "cpu")}
    cpu_s = time.perf_counter() - t_cpu
    pairs = [(a, b) for name in penv.INSTANCES for div in penv.DIVS
             for a, b in zip(chk[dev][name][div], chk["cpu"][name][div])]
    lock_err = max(abs(a["lock"] - b["lock"]) for a, b in pairs)
    jit_err = max((abs(a["jitter_rad"] - b["jitter_rad"]) for a, b in pairs
                   if min(a["lock"], b["lock"]) > ENVELOPE_PHASE_HELD),
                  default=0.0)
    centre = {name: next(r for r in env[name][1] if r["detune_hz"] == 0.0
                         and r["snr_db"] is None) for name in env}
    rep_pe = {"points": [r for per_div in env.values()
                         for recs in per_div.values() for r in recs],
              "summary": env_summary, "blocks": penv.BLOCKS,
              "launches": env_counts, "centre_div1": centre,
              "check_blocks": N_ENVELOPE_CHECK_BLOCKS,
              "card_vs_cpu_max_lock_err": lock_err,
              "card_vs_cpu_max_jitter_err_phase_held": jit_err,
              "tolerances": {"lock": TOL_ENVELOPE_LOCK,
                             "jitter_rad": TOL_ENVELOPE_JITTER,
                             "jitter_where_lock_above": ENVELOPE_PHASE_HELD},
              "cpu_check_seconds": cpu_s,
              "seconds": time.perf_counter() - t_pe}
    emit({"pll_envelope": rep_pe, "card": card})
    pe_ok = (all(c["lock"] >= penv.SETTLE and c["settle_block"] >= 0
                 for c in centre.values())
             and all(np.isfinite(r["lock"]) and np.isfinite(r["jitter_rad"])
                     for r in rep_pe["points"])
             and len(rep_pe["points"]) == 2 * len(penv.DIVS) * 36
             and lock_err <= TOL_ENVELOPE_LOCK
             and jit_err <= TOL_ENVELOPE_JITTER)
    if not pe_ok:
        raise SystemExit(f"chip_smoke: the PLL envelope is off: "
                         f"{ {k: rep_pe[k] for k in rep_pe if k != 'points'} }")

    # ===== 20. the output fetch (io/staging.py::Fetcher) at width: a
    # snapshot on the step's stream, one copy to the host on a side stream
    # beside the next step
    from rtsdr_tpu_torch.io.staging import Fetcher
    from rtsdr_tpu_torch.io.stream import fetch_list

    t_fo = time.perf_counter()
    rx_fo = Receiver(cfg, (N_BATCH_CHANNELS,), resync=True)
    raw_fo = rx_fo.step.input_buffer((N_BATCH_CHANNELS, cfg.block_size))
    gen_fo = torch.Generator(device=dev).manual_seed(22)
    slabs_fo = torch.randint(0, 256, (2, N_BATCH_CHANNELS, cfg.block_size),
                             generator=gen_fo, device=dev, dtype=torch.uint8)
    fetcher_fo = Fetcher(dev)
    fo = {"state": rx_fo.init(), "mismatch": 0, "host_ms": []}

    def fo_steps(n, check):
        pending = None
        for k in range(n):
            raw_fo.copy_(slabs_fo[k % 2], non_blocking=True)
            fo["state"], out = rx_fo.step.borrowed(fo["state"], raw_fo)
            leaves = fetch_list(out)
            fo["leaves"] = len(leaves)
            want = [t.clone() for t in leaves] if check else None
            t0 = time.perf_counter()
            ticket = fetcher_fo.start(leaves)
            fo["host_ms"].append((time.perf_counter() - t0) * 1e3)
            if pending is not None:
                drain_fo(*pending)
            pending = (ticket, want)
        drain_fo(*pending)

    def drain_fo(ticket, want):
        arrays = fetcher_fo.wait(ticket)
        if want is not None:
            fo["mismatch"] += sum(
                not np.array_equal(a, w.cpu().numpy())
                for a, w in zip(arrays, want))

    fo_steps(6, True)
    fo["host_ms"].clear()
    torch.cuda.synchronize()
    trace_mod.clear()
    with tempfile.TemporaryDirectory() as d_fo:
        with trace_mod.profile() as prof_fo:
            fo_steps(8, False)
            torch.cuda.synchronize()
        prof_fo.export_chrome_trace(os.path.join(d_fo, "t.json"))
        with open(os.path.join(d_fo, "t.json")) as f:
            ev_fo = json.load(f).get("traceEvents", [])
    sides = [r["attrs"].get("side") for r in trace_mod.recorded()
             if r["name"] == "rtsdr.fetch_start"]
    def dev_events(keep):
        return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e.get("args", {}).get("stream")) for e in ev_fo
                if keep(e.get("cat"), e.get("name", ""))]
    kern_fo = dev_events(lambda cat, name: cat == "kernel")
    d2h_fo = dev_events(lambda cat, name: cat == "gpu_memcpy"
                        and "DtoH" in name)
    kern_streams = {s_ for _, _, s_ in kern_fo}
    side_streams = {s_ for _, _, s_ in d2h_fo}
    # the busy intervals of every other stream's kernels and copies, merged
    step_union = []
    for k0, k1, st in sorted(dev_events(
            lambda cat, name: cat in ("kernel", "gpu_memcpy", "gpu_memset"))):
        if st in side_streams:
            continue
        if step_union and k0 <= step_union[-1][1]:
            step_union[-1][1] = max(step_union[-1][1], k1)
        else:
            step_union.append([k0, k1])
    # the last block's copy has no next step to run beside
    followed = sorted(d2h_fo)[:-1]
    beside_us = sum(max(0.0, min(b1, k1) - max(b0, k0))
                    for b0, b1, _ in followed for k0, k1 in step_union)
    d2h_us = sum(b1 - b0 for b0, b1, _ in d2h_fo)
    rep_fo = {"channels": N_BATCH_CHANNELS, "steps_checked": 6,
              "leaves": fo["leaves"],
              "arrays_not_equal": fo["mismatch"],
              "traced_steps": 8, "fetch_start_side": sides,
              "d2h_copies": len(d2h_fo),
              "d2h_ms_per_step": d2h_us / 1e3 / 8,
              "d2h_beside_step_share": beside_us / max(
                  sum(b1 - b0 for b0, b1, _ in followed), 1e-9),
              "d2h_on_a_kernel_stream": sum(s_ in kern_streams
                                            for _, _, s_ in d2h_fo),
              "fetch_start_host_ms_median": statistics.median(fo["host_ms"]),
              "seconds": time.perf_counter() - t_fo}
    emit({"fetch_overlap": rep_fo, "card": card})
    if not (fo["mismatch"] == 0 and sides == [1] * 8
            and len(d2h_fo) == 8 and rep_fo["d2h_on_a_kernel_stream"] == 0
            and rep_fo["d2h_beside_step_share"] >= 0.9):
        raise SystemExit(f"chip_smoke: the output fetch is off: {rep_fo}")
    del rx_fo, raw_fo, slabs_fo, fetcher_fo, fo
    torch.cuda.empty_cache()

    # -------------------------------------------------- the kernels line
    # name -> (source, the TPU kernel it replaces, launches in the window
    # of the main path that runs it)
    meta = {
        "ingest.fm_audio": ("rtsdr_tpu_torch/csrc/ingest.cu",
                            "rtsdr_tpu/ops/ingestfir.py:257", rds_counts),
        "ingest.fm": ("rtsdr_tpu_torch/csrc/ingest.cu",
                      "rtsdr_tpu/ops/ingestfir.py:190", m1r_counts),
        "ingest.fm_audio_bank": ("rtsdr_tpu_torch/csrc/ingest.cu",
                                 "rtsdr_tpu/ops/ingestfir.py:257",
                                 fuse_counts),
        "fir_bank.none": ("rtsdr_tpu_torch/csrc/fir_bank.cu",
                          "rtsdr_tpu/ops/pallas_fir.py:35", rds_counts),
        "fir_bank.square": ("rtsdr_tpu_torch/csrc/fir_bank.cu",
                            "rtsdr_tpu/ops/pallas_fir.py:35", rds_counts),
        "fir_bank.mul2": ("rtsdr_tpu_torch/csrc/fir_bank.cu",
                          "rtsdr_tpu/ops/pallas_fir.py:35", rds_counts),
        "pll": ("rtsdr_tpu_torch/csrc/pll.cu",
                "rtsdr_tpu/ops/pallas_pll.py:82", rds_counts),
        "resample_rrc": ("rtsdr_tpu_torch/csrc/resample_rrc.cu",
                         "rtsdr_tpu/ops/pallas_fir.py:479", rds_counts),
        "channelizer.composed": ("rtsdr_tpu_torch/csrc/channelizer.cu",
                                 "rtsdr_tpu/ops/channelizer.py:304",
                                 wb_counts),
        "ingest.iq": ("rtsdr_tpu_torch/csrc/ingest.cu",
                      "rtsdr_tpu/ops/ingestfir.py:364", ts_counts),
        "resample_mix": ("rtsdr_tpu_torch/csrc/resample_rrc.cu",
                         "rtsdr_tpu/ops/pallas_fir.py:353", ts_counts),
        # the layout probe's arms (tools/torch_profile_resample.py): on no
        # main path
        "resample_mix.pair": ("rtsdr_tpu_torch/csrc/resample_rrc.cu",
                              "tools/profile_resample.py:231", ts_counts),
        "resample_mix.split": ("rtsdr_tpu_torch/csrc/resample_rrc.cu",
                               "tools/profile_resample.py:231", ts_counts),
        # no Pallas kernel: the lax.scan that XLA compiles into one loop
        "sync_walk": ("rtsdr_tpu_torch/csrc/sync_walk.cu",
                      "rtsdr_tpu/pipeline/frame.py:324", rds_counts),
    }
    # the case that has the receiver's own configuration of the kernel at
    # the batch path's shape (C = 1024)
    pick = {
        "ingest.fm_audio": lambda r: r["emit_fm"],
        # the mode-1 receivers' front end: 320,000-byte blocks
        "ingest.fm": lambda r: r.get("mode") == 1,
        "ingest.fm_audio_bank": lambda r: not r["emit_fm"],
        "fir_bank.none": lambda r: r["filters"] == 3,
        "pll": lambda r: r["shape"].startswith("f32 2 parts"),
        "resample_rrc": lambda r: r["block"] == 1,
        # the wideband receiver's own call: 8 captures, the smoke's offset
        # folded into the taps (15 stations shared, 1 own), mid-stream tail
        "channelizer.composed": lambda r: (
            r["captures"] == WB_CAPTURES and r["case"] == "one offset"
            and r["block"] == 1),
        # the time-sharded receiver's own calls at T = 4, MODE0
        "ingest.iq": lambda r: r["segments"] == 4,
        "resample_mix": lambda r: (r.get("mode") is None
                                   and r["form"] == "segmented"),
        "resample_mix.pair": lambda r: r.get("mode") is None,
        "resample_mix.split": lambda r: r.get("mode") is None,
        "sync_walk": lambda r: r["repairs"],
    }
    at_width = {"channelizer.composed": f"u8 ({WB_CAPTURES},",
                "resample_mix": f"(4, {N_BATCH_CHANNELS},",
                "resample_mix.pair": f"(4, {N_BATCH_CHANNELS},",
                "resample_mix.split": f"(4, {N_BATCH_CHANNELS},"}
    rows = []
    for name, (source, replaces, counts) in meta.items():
        case = next(r for r in cases if r["name"] == name
                    and at_width.get(name, f"({N_BATCH_CHANNELS},")
                    in r["shape"]
                    and pick.get(name, lambda r: True)(r))
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts.get(name, 0),
                     "launches_audio_path": audio_counts.get(name, 0),
                     "launches_wideband_path": wb_counts.get(name, 0),
                     "launches_mode1_rds_path": m1r_counts.get(name, 0),
                     "launches_timeshard_path": ts_counts.get(name, 0),
                     "launches_timeshard_mode1_rds_path":
                         m1ts_counts.get(name, 0),
                     "launches_timeshard_spread_path":
                         sp_counts.get(name, 0),
                     "launches_sharded_path": sharded_counts.get(name, 0),
                     "shape": case["shape"],
                     "max_abs_err": case["max_abs_err"],
                     "ms": case["kernel_ms"],
                     "burst_ms": case.get("kernel_burst_ms"),
                     "plain_ms": case["plain_ms"],
                     "bound_ms": case["bound_ms"],
                     "bound_by": case["bound_by"],
                     **{k: case[k] for k in ("route_bound_ms",
                                             "dense_bound_ms",
                                             "chain_bound_ms") if k in case},
                     "library_ms": case["library_ms"]})
    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
