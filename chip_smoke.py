#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``trackmaker_tpu_torch``) on one card.

Run from the repository root on a machine with one NVIDIA Hopper card,
PyTorch built for CUDA and the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure (non-zero exit):

0. setup: TF32 off, the card's name and power limit, the kernels built
   from ``trackmaker_tpu_torch/csrc`` (one nvcc per source, in parallel,
   fourteen sources with ``viterbi.cu``) and, beside them, the host runtime
   from ``trackmaker_tpu_torch/runtime/csrc`` (g++)
   and the toolchain (nvcc, the driver, torch),
   and the window health probe ``tools.health.health`` on the card (its
   path: 1,201 launches of the probe kernel), printed with the card;
1. each kernel against its plain PyTorch version on the card: the
   Manchester kernels at the flagship shapes (32 captures x 433,464
   samples, 128 candidates), then the correlation at the 60-sample 4B5B
   preamble and the 4B5B attempt at the fourb5b_b32 shapes (32 captures x
   275,640 samples, 128 candidates), then the four ASK kernels at the
   ask_b16 shapes (16 captures x 338,752 samples, 97 candidate rows): the
   sliding dot at L=440 and L=30 and, bit for bit, at 15 pattern lengths
   in 1..512 (RAW_LS) on 3 captures of 50,001 samples, the fire rule on
   the batch's sync, the
   record chain on the batch's chain rows and on random rows with ties,
   the walk on the batch's successor table and on random tables; the
   line-coded walk on random tables and, with the Manchester attempt's four
   forms, on the edge inputs of tests/test_torch_walk_attempt_design.py
   (walk tables of 1 to 1,000 candidates at the caps that bind; attempt
   windows across T and the valid length, at every offset mod 4, bases at
   and past T, a first sample off a 16-byte boundary, row stride 0); the
   4B5B attempt's four forms and the ASK walk on the edge inputs of
   tests/test_torch_ask_walk_4b5b_design.py (the same kinds of windows,
   near-zero levels, invalid symbols at 0 and 525; ASK tables of C+1 in
   1..2,048 at max_frames 1..300 with self-loops, cycles, misses and a
   clean chain longer than max_frames); the record chain and the fire rule
   on the edge inputs of tests/test_torch_ask_fire_chain_design.py (chain
   rows of widths 1..4,096 across its segment and tile edges, the fire
   rule at w 1..11,264 and T 1..339,453 around its tile and halo, its
   arrays aligned and one element in; w = 0 and past its limit refused);
   then the
   row stats at the equalized_b32 (L=96) and fourb5b_b32 (L=60) shapes and
   at L=440 on the ask_b16 captures, each against its plain version and
   exactly against the row reduction of the dense normalized correlation
   and, at L <= 128, of the hit kernel's dense corr, and the dense
   normalized correlation at L=440 (the ASK chirp, on the ask_b16
   captures) against its plain version and, at L=96, exactly against the
   hit kernel's dense corr; then, at the flagship and
   fourb5b_b32 shapes, the hit kernel's refine entry (the sync-refine fold)
   against its plain version, its columns 0..8 against the hit kernel's
   rows bit for bit and its frame starts against the legacy attempt
   kernels', and the attempt kernels' fold forms against their plain
   versions and, given the legacy frame starts, against the legacy
   kernels; the hit kernel's corr against the normalized correlation
   kernel's bit for bit, and its rows against the plain rows of that corr,
   at every pattern length 1..128 (the preamble repeated and cut) on 3
   captures of 50,001 samples; the refine entry on dense hits (4 captures
   of 60,001 samples at thresholds 0.3 / 0.4 and -2, rows of 1 to 4 and
   more hits, every slot live), with the checks of the fold above, at both
   line codes; the hit kernel's batch-folded entry against the hit kernel's
   rows at the flagship shape; the attempt kernels' shared-capture forms
   (legacy and fold) against their plain versions on two long captures
   split into blocks: blocked_600s (Manchester, 600 s, 64 blocks,
   candidates past 2^24) and a 60 s 4B5B capture in 8 blocks with a frame
   across every seam, each with live candidates that read past their
   block's end; then the tools' kernels: the probe kernel against its
   plain version, the two-stream correlation (``tools.exp_xcorr_streams``)
   against its plain version and, bit for bit, against the hit kernel's
   rows, its noep form against its plain version and the truncation of the
   hit kernel's dense corr, on the flagship captures and on the tool's
   noise corpus (32 x 433,464, L=96, threshold 0.5), and the profiler's
   attempt-only stage, fold off and on, against the plain attempts; the
   threshold tie (the 4B5B preamble's first 39, 48 or 57 samples before a
   frame: lag 0 correlates to 0.9 in exact arithmetic), kernel #1's corr
   there against its plain version bit for bit and the frame found by the
   fast decode and the exact scan; the experiments' kernels: every
   attempt-tile variant (``tools.exp_attempt_tiles``) and base's _nodma,
   _nostore and _u5 against the plain version bit for bit on the tool's
   corpus (32 captures) and an integer-valued copy, each at rings of 1 to
   4 stages, a ring that does not fit refused, and the three offset-add
   forms (``tools.exp_offset_add``) against their plain versions and the
   NumPy oracles, bit for bit; the attempt tiles and the two-stream rows
   on the edge inputs of tests/test_torch_tiles_streams_design.py (the
   tiles' _u1.._u65, _nostore, noop, _nodma and the other kinds at rings of
   1 to 4 on two captures; the streams at L in 2..129 and T in
   129..50,001 around their tile, halo and zero tail, with a hit at the
   last lag, against kernel #1's rows bit for bit and the plain version);
   the probe and the offset add on the edge inputs of
   tests/test_torch_probe_offset_design.py (the probe where x + c rounds,
   near 2^24, at ties, inf, NaN and -0.0, bit for bit; the offset add's
   forms on N(0, 1) inputs within their f32 error bound of float64);
   at the robustness paths' shapes, kernels #1, #3 and #4 against their
   plain versions on every batch those paths decode: the clock search's
   resampled batch (7 x 433,464, equal to the CPU's bit for bit), the
   timing gate's retry batch (16 windows at max_frames=1) on both gate
   captures, each sweep's batch, the decision-directed capture, its
   preamble-trained equalization and its first refit FIR's output (and
   #8's row stats on the capture); the candidate extraction of the timing
   gate's dense hits and its drift estimates against the CPU's; then the
   streaming receive path and the MAC: #1, #3 (#5 on 4B5B) and #4 on every
   buffer those paths decode in phase 2, recorded there by a wrapper of
   ``StreamingDecodePipeline._decode_segment`` and
   ``PhyDecoder._decode_with_cursor`` (the latency warm pass's padded
   segments; the padded buffers of every decode call of the seven MAC
   runs and of the five network runs, each at its true length, address
   and max_frames), stacked by
   bucket, address and max_frames, each path's longest buffer also alone
   (B = 1, as the path launches it); these checks run once phase 2 has
   read its counts; the normalized correlation at L=440 with the chirp's
   f32 norm, as the OFDM sync calls it, on the ofdm_v2_b32, v1,
   ofdm_adaptive_b8 and ofdm_adaptive_loaded_b8 captures and (after
   phase 2) on every bucket the stream PHYs of the OFDM, adaptive OFDM,
   PSK and FSK runs and of the retrain decoded, stacked by length and the
   largest alone, each
   within CORR_ATOL of its plain version and the preamble starts walked
   from the kernel's corr equal to those from the plain corr; the Viterbi
   decoder (``csrc/viterbi.cu``) against its plain version bit for bit on
   coded_manchester_b8's header and payload blocks (256 rows of 62 and 518
   trellis steps), on ofdm_adaptive_b8's and ofdm_adaptive_loaded_b8's
   (128 rows of 62 and 518 each) and on tests/test_torch_convcode.py's
   corpora (hard and
   soft rows at every n_steps mod 4, a 1/8-grid ties corpus with an
   all-zero row, depunctured rate-3/4 blocks, one row, 256 rows, ties
   between the first maximum's tree halves, and the long rows: 62 and
   2,054 steps, the staging ring at 6,145, the shared memory's edge at
   12,448 and the choices in device memory at 16,006); and,
   after phase 2, #1's dense corr (``auto_xcorr``) on every bucket the coded
   MAC run correlated, within CORR_ATOL of its plain version, its hits and
   the starts walked from it equal;
2. the main paths, each with its kernels' launch counts set to 0 just
   before it and read just after: the flagship and fourb5b_b32 through
   ``decode_capture_fast`` (32 noisy captures of 64 frames of 128-byte
   payloads, 200-sample gaps, noise sigma 0.05), then the same captures
   with the sync-refine fold on (manchester_b32_fold, fourb5b_b32_fold:
   one launch each of the refine entry, the fold attempt and the walk, none
   of the hit kernel, and every result equal to the legacy decode's);
   equalized_b32, the
   flagship's frames through the echo channel (taps 1 and 0.45 at delay 7,
   noise sigma 0.02 from a seeded ``torch.Generator``), through
   ``equalize_capture`` and then ``decode_capture_fast``; ask_b16 through
   ``ask.demodulate_fast`` (16 tracks of 64 ASK frames of b"the quick
   brown fox", ``build_track`` seeds 7-22, no noise); and ``auto_xcorr``
   at L=440 once.  Each decode has a payload gate, every row ``ok``,
   agreement with the exact scan on two rows, and each kernel of its path
   launched (equalized_b32: each exactly once).  Then the long-capture
   blocked decode through ``decode_blocked_single_chip``: blocked_600s
   (bench.py's row: 48 frames of bytes([i]) * 64 at (i + 1) * (t // 49) in
   28.8 M samples of noise sigma 0.05, 64 blocks, 8 frames per block, 128
   candidates) and the 4B5B seam capture, each legacy and with the fold
   on: every frame once with its exact start and payload, the speculative
   route ok, one launch of the correlation kernel (or its refine entry)
   and of the shared attempt, one walk per fixpoint turn, and the fold's
   frames equal to the legacy decode's.  Then the profiler path
   (``tools.prof_fused``): every stage on the flagship captures, the
   full-decode stage through the payload gate, the attempt-only stage fold
   off and on each launching one correlation entry, one attempt and no
   walk, and the two-stream experiment's row check; then both
   experiments' ``main()`` (the attempt tiles' six default variants, 5
   calls a repeat, and the three offset-add forms against their
   oracles); then the robustness paths (``dsp/timing.py``,
   ``dsp/equalizer.py``, ``bench/ber.py``), each with #1, #3, #4 and #8's
   counts set to 0 just before it: ``decode_with_clock_search`` on the flagship's 64 frames in
   one capture of 433,464 samples skewed +1000 ppm (the ppm chosen within
   500 of it, the frames in order with the payload digest of the JAX
   package's search, SEARCH_DIGEST: 63 frames, since the grid's -1000 ppm
   row is not the exact inverse of +1000 ppm and loses frame 60 there as
   well); ``decode_with_timing_gate`` on 64 frames, six
   at +-400 ppm, each skewed one followed by 6,600 samples of quiet (the
   exact decode gives the 58 on-clock frames, the gate the six skewed
   ones, fewer than 16 hits retried), and the same frames at the
   flagship's 200-sample gaps (frames and starts equal to the port's CPU
   run; a retry window spans the next frame, and the gate recovers none);
   ``decode_capture_dd`` on a mid-burst capture of 64 frames (echo 0.6 at
   delay 9, the head cut at 0.6 of a frame: the payload digest of the JAX
   package's decode, DD_DIGEST, a strict superset of the stock exact
   scan's); ``ber_sweep`` and ``clock_offset_sweep`` at their defaults and
   20,000 ppm (no loss at 15 dB and at 0 ppm, more than half at 20,000
   ppm); then the streaming receive path and the MAC
   (``link/stream.py``, ``phy/decoder.py:PhyDecoder``, ``link/``), each with
   #1, #3, #5 and #4's counts set to 0 just before it: stream_latency,
   bench.py's latency row (6 s at 48 kHz, 12 frames of 64 B at 1/13
   spacing, noise sigma 0.01, pushed in 25 ms chunks through a new
   ``StreamingDecodePipeline``; every frame out of a push with its
   payload, none from the flush; latency p50 and p99, segments, samples
   shipped), and the MAC runs of MAC_RUNS through ``transfer_over_bus``,
   ``gbn_transfer`` and ``sr_transfer`` on the card (CSMA 1,024 B clean,
   512 B at sigma 0.12, 512 B in 4B5B; GBN and SR with a window of 8,
   1,024 B clean and 4,096 B at sigma 0.45 with the energy threshold at
   3.0): the data arrives and each stats dict equals MAC_EXPECT, the JAX
   package's, with airtime over wall time, decode calls and their
   time; then the network layer (``link/interface.py``, ``net/``), each
   run with #1, #3, #5 and #4's counts set to 0 just before it: the runs of
   PING_RUNS through ``run_ping_simulation`` on the card (3 pings; 2 of
   300 B, over the 200 B MTU, fragmented and reassembled; 3 at sigma 0.12;
   2 over a 4B5B stream PHY that ``phy_factory`` builds from PhyEncoder
   and PhyDecoder, ``LineCodedPhy``) and the router run (an acoustic
   node pings a host on the router's WiFi loopback through ``Router``
   and an ``AcousticRouterPort``, as tests/test_router_acoustic.py
   does): each result equals PING_EXPECT, the JAX package's, every ping
   comes back, the router's reply has the WiFi host's address, ICMP type
   0, the payload and a TTL under 64, and each run ends within 30 s of
   wall time (the reassembler's one wall-clock rule), logged with its
   airtime over wall time, decode calls, exact scans and ms a call; then
   the OFDM modems (``phy/ofdm.py``, ``phy/ofdm_v2.py``), #2's count set to
   0 before each step: ofdm_v2_b32, bench.py's ofdm_v2 row (32 captures of
   32 frames of 64-byte payloads, 400-sample gaps, noise sigma 0.01, built
   on the host), through the batched ``find_preambles`` and
   ``demodulate_at_v2`` (#2 launched once, every payload, the decisions'
   digest equal to OFDM_DIGEST, the JAX package's, each decision at least
   1e-3 of the symbols' RMS from its boundary) and ``OfdmModemV2.decode``
   of capture 0; the same frames through v1 (the batch and
   ``OfdmModem.decode``, and 8 through Hamming(7,4)); the MAC run
   "csma_transfer, ofdm_v2" and the network run "ping, ofdm_v2" above run
   over ``OfdmStreamPhyV2``, logged with its stream calls; then the coded
   PHYs (``phy/coded.py``), each run with its kernels' counts set to 0 just
   before it: coded_manchester_b8 (bench.py:449-478's row, cut nothing: 8
   captures of 32 frames of 64-byte payloads, gaps of 300, noise sigma
   0.05) through ``CodedManchesterPhy.decode_equal_frames`` (every frame of
   every capture, one launch of #1 and two of the Viterbi kernel, the
   decisions' digest equal to CODED_DIGEST, the JAX package's), the coded
   4B5B rate-3/4 batch of tests/test_coded_phy.py the same way
   (CODED4_DIGEST), ``OfdmModem(fec="conv")`` on ofdm_v2_b32's frames (every
   payload; #2 and the Viterbi kernel once each), ``coded_ber_sweep`` at its
   defaults (equal to CODED_BER_EXPECT, the JAX package's; #1, #3, #4 and
   the Viterbi kernel launched) and the MAC run "csma_transfer,
   coded_manchester" above over ``CodedManchesterPhy`` (sigma 0.9, threshold
   0.45, logged with its stream calls); then adaptive OFDM and the
   single-carrier modems (``phy/ofdm_adaptive.py``, ``phy/fsk.py``,
   ``phy/psk.py``, ``phy/stream_sc.py``), each run with its kernels' counts
   set to 0 just before it: ofdm_adaptive_b8 (bench.py:486-515's row, cut
   nothing: 8 captures of 16 frames of 64-byte payloads, gaps of 300, noise
   sigma 0.01, the default loading) and ofdm_adaptive_loaded_b8 (the mixed
   BPSK / QPSK / 16- / 64-QAM loading of tests/test_parallel_ofdm.py at
   sigma 0.004) through ``OfdmAdaptiveStreamPhy.decode_equal_frames``
   (every frame of every capture in order, #2 once and the Viterbi kernel
   twice, the decisions' digests equal to ADAPTIVE_DIGEST and
   ADAPTIVE_LOADED_DIGEST, the JAX package's); the live retrain of
   tests/test_ofdm_adaptive_mac.py (probe, loading, traffic, degradation,
   REPROBE, LOADING with gains, traffic again; equal to RETRAIN_EXPECT, the
   JAX package's); ``FskModem.decode`` and ``PskModem.decode`` (BPSK, QPSK)
   of SC_FRAMES frames each (every payload, #2 once each); and the MAC
   runs "csma_transfer, ofdm_adaptive", "csma_transfer, psk" and
   "csma_transfer, fsk" above over their stream PHYs; then the command
   line (``cli/main.py``, phase 2 (cli)), in process in a temporary
   directory, with the kernels' counts set to 0 just before each call: the
   flagship's 32 captures written at a gain of CLI_GAIN as 16-bit WAV (the
   port's ``io.write_wav``) and as FLAC (``flac_encode`` below, the same
   PCM) and decoded by ``decode <32 files> --addr 2 --output`` (one bucket,
   one ``decode_capture_fast``: its result equal to a direct call on the
   loaded batch, the listed frames and the output file every payload of
   every file, every row ok with no exact scan, #1, #3 and #4 launched; the
   load time, the bucket's decode time by CUDA events, the real-time
   multiple of the whole command by wall clock and the peak memory
   printed), the FLAC batch equal to the WAV batch bit for bit; the same
   for 8 fourb5b_b32 captures in 4B5B (#5); then ``decode --equalize`` of
   one equalized_b32 row (#8 launched, its 64 payloads), ``test`` in both
   codes, ``ask-test --frames 16``, ``ofdm-test --fec conv``, ``ping
   --count 2`` and ``tx --arq sr`` of 512 B, each gated on its exit code and
   outcome line; the phase within CLI_BUDGET_S; after it, phase 1's
   check_path_batch of #1, #3 / #5 and #4 on the two decoded batches;
   then the multi-device decode (``parallel/``, phase 2 (mesh)), each call
   with #1, #3, #5, #4 and #2's counts set to 0 just before it, over
   meshes of the card repeated (and over the distinct cards where
   ``torch.cuda.device_count() > 1``): ``decode_blocked_sharded`` of
   blocked_600s over MESH_SHARDS shards (every shard ok, one launch of #1
   and of #3, one walk a fixpoint turn, the 48 frames equal to
   ``decode_blocked_single_chip``'s) and its exact route; the seam
   scenarios of tests/test_parallel_adversarial.py:119-164 in both line
   codes over 8 shards, both routes, equal to SHARDED_EXPECT (the JAX
   package's) with sequence 99 never decoded; ``batch_sharded_decode`` of
   the flagship over dp = MESH_SHARDS, equal to ``decode_capture_fast``;
   ``decode_ofdm_blocked_sharded`` of ofdm_v2_b32's frames and of the
   loaded adaptive tiers laid end to end across the seams of MESH_SHARDS
   shards (every payload in capture order, equal to the single-device
   pass, #2 once); the optimistic batch (``optimistic_input``) through
   ``decode_capture(optimistic=True)`` and ``decode_capture_fast``, equal
   to OPTIMISTIC_EXPECT, its non-conformant rows equal to the exact scan;
   ``tools.dryrun_multichip`` over 8 shards of the card (the four checks of
   ``__graft_entry__.py``'s dry run); then phase 1 on these inputs (#1,
   #3 / #5 and #4 on the shards' windows at their valid lengths and the
   walk at every fixpoint turn's cursors, #1 on the optimistic batch, #2
   on the OFDM windows); last in the run,
   after the profiler's sessions, MP_PROCS processes of
   ``tools/multihost_dryrun.py`` on the card over gloo, MP_ROWS flagship
   rows each, within MP_TIMEOUT_S;
3. the fallbacks: a Manchester capture that overflows the candidate table,
   a 4B5B capture with a zeroed level inside an attempted frame, and an
   ASK capture of 150 back-to-back chirps before three frames (more fire
   candidates than its table holds) go to the exact scan on the card, and
   each merged batch equals the exact scan; a noise-only batch passes the
   equalizer bit for bit; the 4B5B seam capture with a level zeroed in the
   frame across seam 1 makes the blocked decode's speculative route not
   ok, and decode_blocked_single_chip returns the exact blocked route's
   frames, equal to the sequential exact scan's; 150 back-to-back
   preambles before three frames in one ``PhyDecoder`` call and as one
   streaming segment: the speculative decode not ok, the exact scan on
   the card, the frames and the buffer kept equal to the port's CPU run;
4. timings with CUDA events (median of 30 runs after warm-up) of each
   kernel against its plain version (the sliding dot and the normalized
   correlation also against ``conv1d``), of the equalizer's steps, of
   ``decode_capture_spec`` (legacy and fold, in turns), ``equalize_capture``
   (alone and before the decode) and ``demodulate_spec`` end to end, and of
   the exact scan of one
   row (median of 5), with peak device memory and, for the equalized
   decode, the device's busy share (torch.profiler); at blocked_600s,
   ``decode_blocked_single_chip`` end to end (median of 30, and its
   real-time multiple), its steps (phase A, the fixpoint's walks, the
   compaction), its peak memory and busy share, each shared-capture attempt
   against its plain version and its bound, and one call of the exact
   blocked route; the launch floor, the two-stream experiment's times
   beside the hit kernel's at the tool's shapes with their bound, the
   tools' kernels against their plain versions, and the profiler's stage
   table (min and median of 3 runs of 10 calls); the hit kernel's entries'
   own device time (torch.profiler, median of 30 launches, from a session
   that traced all 30, else "not measured") beside each wrapper's
   CUDA-event time, and kernel #1 over the two-stream kernel at
   the tool's shapes in the same run; the same for every other kernel on
   a path (the sliding dot at L=440 and L=30, the normalized correlation,
   the row stats at L=96 and L=60, the attempts in every form, the walk,
   the ASK kernels), beside its bound and its launches, ranked by
   launches x (device - bound); the raw sliding dot's unfused floor; the
   Manchester and 4B5B attempts' contract floor (each live slot's window
   read once); the registers, spills and FFMA / FMUL / FADD / LDS counts of
   each kernel of sliding_dot.cu, xcorr_norm.cu, xcorr_hits.cu and
   xcorr_streams.cu, which share the register tile of xcorr_tile.cuh, and
   of spec_walk.cu, attempt_manchester.cu, attempt_4b5b.cu, ask_walk.cu,
   ask_fire.cu, ask_chain.cu, attempt_tiles.cu, seq_probe.cu and
   offset_add.cu (cuobjdump); the device time of the window probe, of
   the offset add's three forms, of the attempt tiles' noop and of the
   two-stream kernel, each beside an empty
   kernel at its grid (the probe's and the offset add's also at their
   first design's grid); the record chain on the exact scan's row
   (4,096 columns) and on its first 512 columns, each one launch, and two
   yardsticks that compute part of #10's and #9's functions
   (``torch.cummax`` of the chain rows, ``max_pool1d`` of the masked rows);
   every attempt-tile
   variant of phase 1 (CUDA events and device time) and every offset-add
   form against its plain version and its bound (bf16b's also at the f32
   rate), beside torch.bmm of the body products and torch.matmul with the
   sliced add; the robustness paths end to end (the clock search median
   of 30 and its real-time multiple, the timing gate of 10 on each of
   its two captures, the
   decision-directed decode of 5, each sweep of 3) and their steps (the
   grid's resample and batch decode; the gate's decode and dense
   correlation; the decision-directed bootstraps, one host refit and one
   refit decode, median of 5 each); a ``PhyDecoder`` decode of the clean
   CSMA run's longest buffer, of a 4B5B buffer that falls to the exact
   scan (median of 5), and a streaming segment's pack and readback; the
   normalized correlation at the ofdm_v2_b32 shape against its plain
   version, ``conv1d`` and its bound, with its device time; the ofdm_v2_b32
   decode end to end (median of 30, and its real-time multiple), its steps
   (sync's correlation and walk, the SC refine, windows and FFTs,
   equalization and tracking), its peak memory and busy share, and one
   ``OfdmStreamPhyV2.process_samples`` call on the largest bucket the OFDM
   runs decoded; the coded_manchester_b8 decode end to end (median of 30,
   and its real-time multiple; also through ``decode_equal_frames``), its
   steps (the correlation, the walk, the soft demod and deinterleave, the
   two Viterbi launches), its peak memory and busy share, the Viterbi
   kernel at the payload and header shapes and at one row of 62 and of
   2,054 steps (CUDA events of one call, device time from a CUDA graph of
   50 launches and from torch.profiler, the host time of a call, the time
   a block step) beside its bound and its plain version, and one
   ``CodedManchesterPhy.process_samples`` call on the
   largest bucket the coded MAC run correlated; the ofdm_adaptive_b8 decode
   end to end (median of 30, its real-time multiple, also through
   ``decode_equal_frames``), its steps (the correlation, the walk, the soft
   demap, the deinterleave, the two Viterbi launches with their device time
   from a CUDA graph), its peak memory and busy share, #2 at its shape
   beside its plain version, conv1d and its bound, and one
   ``OfdmAdaptiveStreamPhy.process_samples`` call on the largest bucket the
   adaptive MAC run decoded; the mesh paths (median of 30, the optimistic
   batch's host-loop scans of OPT_RUNS, and peak memory):
   the sharded blocked decode beside ``decode_blocked_single_chip``,
   ``batch_sharded_decode`` beside ``decode_capture_fast``, each sharded
   OFDM decode beside its single-device pass, and the optimistic batch
   (``decode_capture_fast``, the optimistic scan) beside the exact scan of
   its rows; each printed beside the card's name and power limit.

The line before the last is a JSON object with the kernels' measurements:
``launches`` counts each kernel's launches in the main-path runs of
phase 2 (the line-coded paths, the blocked runs, the profiler path, the
robustness paths, the streaming latency run, the MAC runs, the network
runs, the OFDM paths, the coded paths, the adaptive OFDM, retrain and
single-carrier paths, the command line's runs and the mesh paths, the
dry-run processes' own counts included; the probe's in phase 0's health
run; the
batch-folded hit rows are on no path and count 0),
``ms`` and ``plain_ms`` time it at the shapes of its first path, and
``bound_ms`` is the least time the card could take for that work (bytes
over 3.35 TB/s or operations over 67 TFLOP/s, the attempt tiles' bf16
body over 989 TFLOP/s, whichever is larger).  ``attempt_tiles`` and
``offset_add`` give the base variant's and form A's numbers, and count the
launches of the experiments' main() runs.  The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache, partial

import numpy as np

N_FRAMES = 64
BATCH = 32
PAYLOAD = 128
GAP = 200
NOISE = 0.05
MAX_FRAMES = N_FRAMES + 8
N_CAND = 128
LOCAL_ADDR = 2
CORR_ATOL = 1e-5    # summation order differs between kernel and plain version
EDGE_THR = 0.5      # the refine-edge batch's threshold: hits off each preamble's lag
EQ_TAPS = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.45)   # bench.py's equalized row
EQ_NOISE = 0.02
RUNS = 30
GRAPH_LAUNCHES = 50    # launches a CUDA graph holds when timing one kernel's device time
GRAPH_REPLAYS = 5
HOST_CALLS = 200
ASK_BATCH = 16
ASK_FRAMES = 64
ASK_TEXT = b"the quick brown fox"
ASK_MAX_FRAMES = ASK_FRAMES + 8
BLOCKED_SECONDS = 600       # bench.py's blocked_600s row: one 600 s capture
BLOCKED_BLOCKS = 64
BLOCKED_FRAMES = 48
BLOCKED_PAYLOAD = 64
BLOCKED_MFPB = 8            # max_frames_per_block
SEAM_SECONDS = 60           # the 4B5B seam capture: a frame across every seam
SEAM_BLOCKS = 8
# the decision-directed corpus: DD_FRAMES frames of PAYLOAD random bytes
# back to back through an echo of 0.6 at delay 9, noise sigma 0.02, the
# head cut at 0.6 of a frame (tests/test_equalizer.py's mid-burst corpus
# at the flagship's payloads); DD_DIGEST is the payload digest of the JAX
# package's decode_capture_dd on it (tests/test_torch_equalizer_dd.py)
DD_FRAMES = 64
DD_SEED = 0
DD_ECHO = (9, 0.6)
DD_NOISE = 0.02
DD_CUT = 0.6
DD_DIGEST = "34feb2ef1e9a7864"
# the clock search's capture: the flagship's frames (seed SEARCH_SEED) with
# GAP samples between them, 433,464 samples without noise, skewed by
# SEARCH_PPM; SEARCH_DIGEST is the payload digest of the JAX package's
# decode_with_clock_search on it (tests/test_torch_channel_timing.py)
SEARCH_SEED = 0
SEARCH_PPM = 1000.0
SEARCH_DIGEST = "03bcea581fef4402"
# the timing gate's capture: the flagship's frames, each followed by GAP
# samples of silence, six of them skewed (frame index: ppm) and followed by
# GATE_QUIET samples (a retry window spans 12,768 samples, and a frame
# inside it beyond the skewed one spoils its drift estimate), noise sigma
# 0.02 from NumPy
GATE_SKEWS = {5: 400.0, 16: -400.0, 27: 400.0, 38: -400.0, 49: 400.0, 60: -400.0}
GATE_QUIET = 6_600
GATE_SEED = 5
GATE_NOISE = 0.02
SWEEP_PPMS = (0, 50, 100, 200, 500, 1000, 2000, 5000, 20000)   # the defaults and 2%
# the streaming latency run (bench.py's latency row): STREAM_FRAMES frames of
# bytes([i]) * STREAM_PAYLOAD at (i + 1) / (STREAM_FRAMES + 1) of a capture of
# STREAM_SECONDS at 48 kHz, noise sigma STREAM_NOISE from NumPy, pushed in
# chunks of STREAM_CHUNK samples (25 ms)
STREAM_SECONDS = 6
STREAM_FRAMES = 12
STREAM_PAYLOAD = 64
STREAM_NOISE = 0.01
STREAM_CHUNK = 1200
CHECK_ROWS = 128     # buffers a phase-1 batch of a recorded path stacks
# ofdm_v2_b32, bench.py's ofdm_v2 row (bench.py:402-446): OFDM_FRAMES frames
# Frame.new_data(i, 1, 2, p) of random OFDM_PAYLOAD-byte payloads,
# OFDM_GAP samples apart, in OFDM_BATCH captures with noise sigma
# OFDM_NOISE, payloads and noise from default_rng(OFDM_SEED), the waveform
# from the port's modulator on the host; the v1 run sends the same frames
# with noise from default_rng(OFDM_SEED + 1).  OFDM_DIGEST is the digest of
# the JAX package's decisions on these captures, the coarse starts and the
# bits (tests/test_torch_ofdm_v2.py)
OFDM_BATCH = 32
OFDM_FRAMES = 32
OFDM_PAYLOAD = 64
OFDM_GAP = 400
OFDM_NOISE = 0.01
OFDM_SEED = 0
OFDM_DIGEST = "3db8047324c8e4ac"
# coded_manchester_b8, bench.py's coded row (bench.py:449-478): CODED_FRAMES
# frames Frame.new_data(i, 1, 2, p) of random CODED_PAYLOAD-byte payloads,
# CODED_GAP samples apart, through CodedManchesterPhy(PhyConfig()), in
# CODED_BATCH captures with noise sigma CODED_NOISE, payloads and noise from
# default_rng(CODED_SEED), the waveform from the port's encoder on the host.
# CODED_DIGEST is the digest of the JAX package's batched decode of these
# captures, the starts and the bits (tests/test_torch_coded.py)
CODED_BATCH = 8
CODED_FRAMES = 32
CODED_PAYLOAD = 64
CODED_GAP = 300
CODED_NOISE = 0.05
CODED_SEED = 0
CODED_DIGEST = "697064d3d339ccbf"
# the coded 4B5B rate-3/4 batch, tests/test_coded_phy.py's
# test_batched_decode_matches_streaming shape: CODED4_FRAMES frames of random
# CODED4_PAYLOAD-byte payloads through CodedFourB5BPhy at threshold 0.45,
# rate 3/4, in 2 captures with gaps of 257 and 288 samples, a random lead-in
# under 300 samples and 400 of silence after, noise sigma CODED4_NOISE, all
# from default_rng(CODED4_SEED); CODED4_DIGEST is the JAX package's batched
# decode of it at max_frames CODED4_FRAMES + 2 (tests/test_torch_coded.py)
CODED4_FRAMES = 5
CODED4_PAYLOAD = 48
CODED4_NOISE = 0.12
CODED4_SEED = 11
CODED4_DIGEST = "7fe0ea2965c41596"
# the JAX package's coded_ber_sweep() at its defaults (tests/test_torch_coded.py)
CODED_BER_EXPECT = [
    {"snr_db": -8.0, "frames_sent": 16, "uncoded_loss_pct": 100.0, "coded_loss_pct": 100.0},
    {"snr_db": -6.0, "frames_sent": 16, "uncoded_loss_pct": 100.0, "coded_loss_pct": 50.0},
    {"snr_db": -4.0, "frames_sent": 16, "uncoded_loss_pct": 100.0, "coded_loss_pct": 12.5},
    {"snr_db": -2.0, "frames_sent": 16, "uncoded_loss_pct": 93.75, "coded_loss_pct": 0.0},
    {"snr_db": 0.0, "frames_sent": 16, "uncoded_loss_pct": 81.25, "coded_loss_pct": 0.0},
    {"snr_db": 2.0, "frames_sent": 16, "uncoded_loss_pct": 43.75, "coded_loss_pct": 0.0},
    {"snr_db": 4.0, "frames_sent": 16, "uncoded_loss_pct": 0.0, "coded_loss_pct": 0.0},
    {"snr_db": 6.0, "frames_sent": 16, "uncoded_loss_pct": 0.0, "coded_loss_pct": 0.0},
]
# ofdm_adaptive_b8, bench.py's ofdm_adaptive row (bench.py:486-515), cut
# nothing: ADAPTIVE_FRAMES frames Frame.new_data(i, 1, 2, p) of random
# ADAPTIVE_PAYLOAD-byte payloads, ADAPTIVE_GAP samples apart, through
# OfdmAdaptiveStreamPhy at its default loading (uniform QPSK), in
# ADAPTIVE_BATCH captures with noise sigma ADAPTIVE_NOISE, payloads and noise
# from default_rng(ADAPTIVE_SEED), the waveform from the port's encoder on the
# host; ofdm_adaptive_loaded_b8 the same at adaptive_loading() (the mixed
# loading of tests/test_parallel_ofdm.py:90-93: BPSK, QPSK, 16- and 64-QAM)
# with noise sigma ADAPTIVE_LOADED_NOISE from default_rng(ADAPTIVE_SEED + 1).
# The digests are the JAX package's batched decode of these captures, the
# starts and the bits (tests/test_torch_ofdm_adaptive.py)
ADAPTIVE_BATCH = 8
ADAPTIVE_FRAMES = 16
ADAPTIVE_PAYLOAD = 64
ADAPTIVE_GAP = 300
ADAPTIVE_NOISE = 0.01
ADAPTIVE_LOADED_NOISE = 0.004
ADAPTIVE_SEED = 0
ADAPTIVE_DIGEST = "07c4faf6697b8f20"
ADAPTIVE_LOADED_DIGEST = "7466f495039ee418"
ADAPTIVE_N_DATA = 74        # OfdmAdaptiveConfig()'s data bins
# tests/test_ofdm_adaptive_mac.py:187-189's negotiated loading: 16-QAM on
# the low third of the data bins, QPSK on the middle, BPSK on the top
ADAPTIVE_THIRDS = ((4,) * (ADAPTIVE_N_DATA // 3) + (2,) * (ADAPTIVE_N_DATA // 3)
                   + (1,) * (ADAPTIVE_N_DATA - 2 * (ADAPTIVE_N_DATA // 3)))
# the retrain run, tests/test_ofdm_adaptive_mac.py:211-287 (retrain_run),
# its channels' noise from default_rng(RETRAIN_SEED); RETRAIN_EXPECT is the
# JAX package's result (tests/test_torch_ofdm_adaptive_mac.py): the loadings
# and gains as their handshake bytes (pack_loading, pack_gains) in hex
RETRAIN_SEED = 23
RETRAIN_EXPECT = {
    "load0": "333333333333333333333333333333333333333333333333333333333333"
             "33333332222222",
    "load1": "222222222222222222222222222222111110000000000000000000000000"
             "00000000000000",
    "gains1": "fef706f9f200e9f5f706f600fdf50407fefafd0205fcf9fc0105f9050c04"
              "f4e8060e1000000000000000000000000000000000000000000000000000"
              "0000000000000000000000000000",
    "bits0": 282, "bits1": 65, "calm": (False, 0.0), "tripped": (True, 0.14310805462101722),
    "prefec": [0.0, 0.0, 0.0, 0.0, 0.1340540273105086, 0.16262616267563823,
               0.14555709479517118, 0.13019493370275084],
    "control": ["reprobe", "loading"], "negotiated": True,
    "delivered": [[(i, bytes([i]).hex() * 40) for i in range(4)]] * 2,
    "prefec2": [0.0, 0.0, 0.0, 0.0], "degraded2": False}
# the single-carrier modems' batches: SC_FRAMES frames of SC_PAYLOAD bytes
# through FskModem and PskModem (BPSK and QPSK), SC_GAP samples apart, with
# noise sigma SC_NOISE from default_rng(SC_SEED)
SC_FRAMES = 8
SC_PAYLOAD = 32
SC_GAP = 400
SC_NOISE = 0.1
SC_SEED = 0
# phase 2 (mesh), the multi-device decode over meshes of the card repeated:
# blocked_600s and the OFDM captures over MESH_SHARDS shards, the flagship's
# rows over dp = MESH_SHARDS; the seam scenarios of
# tests/test_parallel_adversarial.py:119-164 (8 shards of 16,000 samples:
# evil frames, whose payload embeds the preamble's bytes and a CRC-valid
# frame of sequence 99, and plain frames across seams; a chain of evil
# frames back to back across 8 shards of halo + 200 samples), in both line
# codes, over an 8-shard mesh; SHARDED_EXPECT holds the (start, sequence)
# pairs the JAX package's decode_blocked_sharded gives on them
# (tests/test_torch_parallel.py)
MESH_SHARDS = 4
SEAM_SHARD_BLOCK = 16_000
SEAM_SHARD_MFPB = 8
SEAM_MESHES = {"evil_seam": (2, 4), "chain": (1, 8)}     # (dp, sp)
SHARDED_EXPECT = {
    "evil_seam, manchester": [(15800, 1), (47960, 2), (80011, 3), (111700, 4)],
    "chain, manchester": [(12922, 7), (14026, 7), (15130, 7), (16234, 7), (17338, 7),
                          (18442, 7)],
    "evil_seam, 4b5b": [(15800, 1), (47960, 2), (80011, 3), (111700, 4)],
    "chain, 4b5b": [(8143, 7), (8833, 7), (9523, 7), (10213, 7), (10903, 7), (11593, 7)],
}
# the sharded OFDM captures: ofdm_v2_b32's frames (and OFDM_SHARD_ADAPTIVE
# frames of ADAPTIVE_PAYLOAD bytes through ofdm_adaptive_loaded_b8's
# loading, uncoded) laid end to end with gaps from
# default_rng(OFDM_SHARD_SEED) in OFDM_SHARD_GAPS, noise sigma OFDM_NOISE
# (ADAPTIVE_LOADED_NOISE)
OFDM_SHARD_SEED = 0
OFDM_SHARD_GAPS = (200, 2500)
OFDM_SHARD_ADAPTIVE = 16
# the multi-process dry run: two processes of tools/multihost_dryrun.py on
# the card over gloo, MP_ROWS of the flagship's rows each, within MP_TIMEOUT_S
MP_PROCS = 2
MP_ROWS = 16
MP_TIMEOUT_S = 240
# the optimistic batch: OPT_ROWS captures of the same OPT_FRAMES 4B5B frames
# of random OPT_PAYLOAD-byte payloads at samples_per_level OPT_SPL (which the
# speculative kernels do not cover), OPT_GAP samples apart after OPT_LEAD,
# noise sigma OPT_NOISE, payloads and noise from default_rng(OPT_SEED), the
# rows OPT_BROKEN_ROWS with one symbol of frame 3's payload zeroed (an
# invalid symbol); OPTIMISTIC_EXPECT is the digest of the JAX package's
# conformant flags and frames of decode_capture(optimistic=True) and of
# decode_capture_fast on it (tests/test_torch_optimistic.py)
OPT_SPL = 4
OPT_ROWS = 8
OPT_FRAMES = 16
OPT_PAYLOAD = 64
OPT_GAP = 300
OPT_LEAD = 200
OPT_NOISE = 0.05
OPT_SEED = 0
OPT_BROKEN_ROWS = (2, 5)
OPT_MAX_FRAMES = OPT_FRAMES + 8
OPT_RUNS = 5                # phase 4 times its host-loop scans by a median of 5
OPTIMISTIC_EXPECT = "25135ef0a992fc2a"
DIGEST_FIELDS = ("valid", "frame_bytes", "length", "frame_type", "sequence", "src", "dst",
                 "start")
# the MAC runs over the port's PHY: name -> (ARQ, bytes of bytes(range(256))
# repeated, options: the transfer's keywords, line_coding and
# energy_threshold for its PhyConfig and MacConfig, and phy, the stream PHY
# each node gets in place of the line-coded one); the noisy CSMA run is
# tests/test_link.py's, the noisy window runs tests/test_sr.py's, at
# sigma 0.45 where frames drop and the ARQ paths run, the OFDM run
# tests/test_ofdm_v2_mac.py's, the coded run tests/test_coded_phy.py's
# (sigma 0.9, seed 9, correlation threshold 0.45 for its PhyConfig, carrier
# sense at 3.0), the adaptive run tests/test_ofdm_adaptive_mac.py's (its
# stream PHY's loading), the PSK and FSK runs tests/test_stream_sc.py's
MAC_RUNS = {
    "csma_transfer": ("csma", 1024, {"max_duration_s": 60.0}),
    "csma_transfer, noise": ("csma", 512, {"noise_std": 0.12, "seed": 5,
                                           "max_duration_s": 120.0}),
    "csma_transfer, 4b5b": ("csma", 512, {"line_coding": "4b5b", "max_duration_s": 60.0}),
    "gbn_transfer": ("gbn", 1024, {"window": 8}),
    "sr_transfer": ("sr", 1024, {"window": 8}),
    "gbn_transfer, noise": ("gbn", 4096, {"window": 8, "noise_std": 0.45, "seed": 5,
                                          "max_duration_s": 300.0, "energy_threshold": 3.0}),
    "sr_transfer, noise": ("sr", 4096, {"window": 8, "noise_std": 0.45, "seed": 5,
                                        "max_duration_s": 300.0, "energy_threshold": 3.0}),
    "csma_transfer, ofdm_v2": ("csma", 512, {"phy": "ofdm_v2", "max_duration_s": 120.0}),
    "csma_transfer, coded_manchester": ("csma", 512, {
        "phy": "coded_manchester", "correlation_threshold": 0.45, "noise_std": 0.9, "seed": 9,
        "energy_threshold": 3.0, "max_duration_s": 120.0}),
    "csma_transfer, ofdm_adaptive": ("csma", 512, {
        "phy": "ofdm_adaptive", "loading": ADAPTIVE_THIRDS, "max_duration_s": 120.0}),
    "csma_transfer, psk": ("csma", 512, {"phy": "psk", "max_duration_s": 120.0}),
    "csma_transfer, fsk": ("csma", 512, {"phy": "fsk", "max_duration_s": 120.0}),
}
# the JAX package's stats of each MAC run (tests/test_torch_link.py); the
# port's must equal them, on the card as on the CPU
MAC_EXPECT = {
    "csma_transfer": {"airtime_samples": 72704, "airtime_s": 1.5146666666666666, "acked": 8,
                      "retransmissions": 0, "duplicates": 0,
                      "throughput_bps": 5408.450704225353},
    "csma_transfer, noise": {"airtime_samples": 38016, "airtime_s": 0.792, "acked": 4,
                             "retransmissions": 0, "duplicates": 0,
                             "throughput_bps": 5171.717171717171},
    "csma_transfer, 4b5b": {"airtime_samples": 26112, "airtime_s": 0.544, "acked": 4,
                            "retransmissions": 0, "duplicates": 0,
                            "throughput_bps": 7529.411764705882},
    "gbn_transfer": {"airtime_s": 1.152, "throughput_bps": 7111.111111111111,
                     "retransmit_bursts": 0, "window": 8},
    "sr_transfer": {"airtime_s": 1.1573333333333333, "throughput_bps": 7078.341013824885,
                    "retransmit_bursts": 0, "frames_retransmitted": 0, "window": 8},
    "gbn_transfer, noise": {"airtime_s": 13.677333333333333,
                            "throughput_bps": 2395.7886527588225, "retransmit_bursts": 8,
                            "window": 8},
    "sr_transfer, noise": {"airtime_s": 6.544, "throughput_bps": 5007.334963325184,
                           "retransmit_bursts": 4, "frames_retransmitted": 11, "window": 8},
    "csma_transfer, ofdm_v2": {"airtime_samples": 39936, "airtime_s": 0.832, "acked": 4,
                               "retransmissions": 0, "duplicates": 0,
                               "throughput_bps": 4923.076923076923},
    "csma_transfer, coded_manchester": {"airtime_samples": 71680,
                                        "airtime_s": 1.4933333333333334, "acked": 4,
                                        "retransmissions": 0, "duplicates": 0,
                                        "throughput_bps": 2742.8571428571427},
    "csma_transfer, ofdm_adaptive": {"airtime_samples": 53760, "airtime_s": 1.12, "acked": 4,
                                     "retransmissions": 0, "duplicates": 0,
                                     "throughput_bps": 3657.142857142857},
    "csma_transfer, psk": {"airtime_samples": 126464, "airtime_s": 2.6346666666666665,
                           "acked": 4, "retransmissions": 0, "duplicates": 0,
                           "throughput_bps": 1554.6558704453441},
    "csma_transfer, fsk": {"airtime_samples": 232448, "airtime_s": 4.842666666666666,
                           "acked": 4, "retransmissions": 0, "duplicates": 0,
                           "throughput_bps": 845.8149779735684},
}
# the network layer's runs over the port's PHY (BASELINE.json config 5):
# name -> run_ping_simulation's keywords, with line_coding for a stream PHY
# that phy_factory builds over PhyEncoder and PhyDecoder (LineCodedPhy), or
# phy for the OFDM v2 stream PHY; the clean, fragmented and OFDM pings are
# tests/test_ping.py's, the noisy one at tests/test_link.py's sigma;
# "router" is tests/test_router_acoustic.py's scenario (router_run)
PING_RUNS = {
    "ping": {"count": 3, "max_duration_s": 30.0},
    "ping, fragments": {"count": 2, "payload_size": 300, "max_duration_s": 60.0},
    "ping, noise": {"count": 3, "noise_std": 0.12, "seed": 5, "max_duration_s": 60.0},
    "ping, 4b5b": {"count": 2, "line_coding": "4b5b"},
    "ping, ofdm_v2": {"count": 2, "noise_std": 0.003, "max_duration_s": 60.0,
                      "phy": "ofdm_v2"},
    "router": {},
}
ROUTER_PAYLOAD = b"crossing segments"
# the JAX package's result of each network run (tests/test_torch_ping.py,
# tests/test_torch_router.py); the port's must equal it, on the card as on
# the CPU
PING_EXPECT = {
    "ping": {"sent": 3, "received": 3, "loss_pct": 0.0, "rtt_min_ms": 208.0,
             "rtt_avg_ms": 208.0, "rtt_max_ms": 208.0, "responded": 3,
             "airtime_s": 2.2106666666666666},
    "ping, fragments": {"sent": 2, "received": 2, "loss_pct": 0.0, "rtt_min_ms": 856.0,
                        "rtt_avg_ms": 861.3333333333333, "rtt_max_ms": 866.6666666666666,
                        "responded": 2, "airtime_s": 1.8693333333333333},
    "ping, noise": {"sent": 3, "received": 3, "loss_pct": 0.0, "rtt_min_ms": 208.0,
                    "rtt_avg_ms": 208.0, "rtt_max_ms": 208.0, "responded": 3,
                    "airtime_s": 2.2106666666666666},
    "ping, 4b5b": {"sent": 2, "received": 2, "loss_pct": 0.0, "rtt_min_ms": 152.0,
                   "rtt_avg_ms": 157.33333333333331, "rtt_max_ms": 162.66666666666666,
                   "responded": 2, "airtime_s": 1.1653333333333333},
    "ping, ofdm_v2": {"sent": 2, "received": 2, "loss_pct": 0.0, "rtt_min_ms": 216.0,
                      "rtt_avg_ms": 221.33333333333331, "rtt_max_ms": 226.66666666666666,
                      "responded": 2, "airtime_s": 1.2293333333333334},
    "router": {"pings_seen": 1, "forwarded": 2, "dropped": 0, "airtime_s": 0.184,
               "reply": "4500002d000000003f01f77bc0a80202c0a80102000075fa0099000163726f737369"
                        "6e67207365676d656e7473",
               "frame_type": 1, "src_mac": 1, "src": "192.168.2.2", "dst": "192.168.1.2",
               "ttl": 63, "icmp_type": 0, "payload": b"crossing segments"},
}

# the modules the network runs use, by short name, under either package
NET_MODULES = {"config": "core.config", "audio": "link.audio", "bus": "link.bus",
               "interface": "link.interface", "encoder": "phy.encoder",
               "decoder": "phy.decoder", "ofdm_v2": "phy.ofdm_v2", "ethernet": "net.ethernet",
               "icmp": "net.icmp", "ip": "net.ip", "ports": "net.ports",
               "router": "net.router", "tools": "net.tools"}
WALL_LIMIT_S = 30.0     # the reassembler drops a partial packet after 30 s of wall time
SWEEP_B, SWEEP_T = 3, 50_001  # the tap sweep's captures: T not a multiple of a block's lags
# the raw sliding dot's sweep: every remainder of an 8-tap step near 8, 16
# and 128, the dense dots' 30, the chirp's 440 and the kernel's last 512
RAW_LS = (1, 2, 7, 8, 9, 15, 16, 17, 30, 127, 128, 129, 440, 511, 512)
DENSE_B, DENSE_T = 4, 60_001  # the dense-hit refine captures
DENSE_THR = {"manchester": 0.3, "4b5b": 0.4}   # rows of 0 to 5 and more hits there
FULL_THR = -2.0             # every lag a hit: every slot of every row refined
PROFILE_SESSIONS = 3        # torch.profiler sessions a device time may take
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 on the tensor cores, dense
# the kernel each wrapper launches, where the two names differ
KERNEL_NAMES = {"sliding_dot_scaled": "sliding_dot", "dense_fire_candidates": "ask_fire",
                "normalized_xcorr_dense": "normalized_xcorr", "viterbi_decode": "viterbi"}
# the source of each kernel, where it is not csrc/<name>.cu
SOURCES = {"normalized_xcorr": "xcorr_norm", "xcorr_rowstats": "xcorr_norm",
           "xcorr_hits_2s": "xcorr_streams", "attempt_sum": "attempt_manchester",
           "xcorr_hits_refine": "xcorr_hits", "xcorr_hits_batched": "xcorr_hits",
           "attempt_manchester_fold": "attempt_manchester", "attempt_4b5b_fold": "attempt_4b5b",
           "attempt_manchester_shared": "attempt_manchester",
           "attempt_manchester_fold_shared": "attempt_manchester",
           "attempt_4b5b_shared": "attempt_4b5b", "attempt_4b5b_fold_shared": "attempt_4b5b"}


# --- FLAC files (the CLI's decode reads them through the port's runtime) ---

FLAC_BLOCK = 4096           # samples a FLAC frame (the last one shorter)
FLAC_RATE_CODES = {44_100: 9, 48_000: 10, 96_000: 11}


def _crc8_table() -> np.ndarray:
    t = np.zeros(256, np.uint8)
    for b in range(256):
        c = b
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        t[b] = c
    return t


@lru_cache(maxsize=None)
def _crc16_table(n: int) -> np.ndarray:
    """D[d, b] = the FLAC frame CRC-16 (poly 0x8005, init 0) of byte b
    followed by d zero bytes, for d < n."""
    t = np.zeros(256, np.int64)
    for b in range(256):
        c = b << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        t[b] = c
    d = np.zeros((n, 256), np.int64)
    d[0] = t
    for i in range(1, n):
        d[i] = ((d[i - 1] << 8) & 0xFFFF) ^ t[d[i - 1] >> 8]
    return d.astype(np.uint16)


def flac_crc16(data: bytes) -> int:
    """The FLAC frame CRC-16 of `data`.  A zero-init CRC is linear, so it is
    the XOR of each byte's entry at its distance from the end."""
    b = np.frombuffer(bytes(data), np.uint8)
    if len(b) == 0:
        return 0
    d = _crc16_table(1 << max(len(b) - 1, 1).bit_length())   # a few sizes, each built once
    return int(np.bitwise_xor.reduce(d[np.arange(len(b) - 1, -1, -1), b]))


def _utf8_number(v: int) -> list[int]:
    """FLAC's UTF-8-like coding of a frame number."""
    if v < 0x80:
        return [v]
    for extra, top in ((1, 0xC0), (2, 0xE0), (3, 0xF0), (4, 0xF8), (5, 0xFC)):
        if v < 1 << (5 * extra + 6):
            return ([top | (v >> (6 * extra))]
                    + [0x80 | ((v >> (6 * k)) & 0x3F) for k in range(extra - 1, -1, -1)])
    raise ValueError(f"frame number {v} too large")


def _subframe(s: np.ndarray):
    """(kind, values, widths) of the bit fields of one 16-bit subframe of
    int64 samples s[L]: CONSTANT when every sample is equal, else the
    cheaper of VERBATIM and the FIXED predictors of order 0..4 with one
    Rice partition (parameter 0..14)."""
    n = len(s)
    if (s == s[0]).all():
        return "constant", [0, int(s[0]) & 0xFFFF], [8, 16]
    best = (16 * n, "verbatim", 0, None, 0)
    for order in range(min(4, n - 1) + 1):
        r = np.diff(s, order)
        u = (r << 1) ^ (r >> 63)                 # zigzag: 0, -1, 1, -2, ... -> 0, 1, 2, 3
        k0 = min(int(np.log2(u.mean() + 1.0)), 14)   # the best parameter lies near log2 of the mean
        cost, k = min((int((u >> k).sum()) + (k + 1) * len(u), k)
                      for k in range(max(k0 - 2, 0), min(k0 + 2, 14) + 1))
        if 16 * order + 10 + cost < best[0]:
            best = (16 * order + 10 + cost, f"fixed{order}", order, u, k)
    _, kind, order, u, k = best
    if u is None:
        return kind, np.concatenate([[1 << 1], s & 0xFFFF]), np.concatenate([[8], np.full(n, 16)])
    values = np.concatenate([[(8 + order) << 1], s[:order] & 0xFFFF, [k],
                             (1 << k) | (u & ((1 << k) - 1))])
    widths = np.concatenate([[8], np.full(order, 16), [10], (u >> k) + 1 + k])
    return kind, values, widths


def _pack(values: np.ndarray, widths: np.ndarray) -> bytes:
    """The bit fields (value, width), MSB first, in order, as bytes (a
    multiple of 8 bits in all)."""
    end = np.cumsum(widths)
    field = np.repeat(np.arange(len(widths)), widths)
    shift = end[field] - 1 - np.arange(int(end[-1]))
    bits = (values.astype(np.uint64)[field] >> np.minimum(shift, 63).astype(np.uint64)) & 1
    return np.packbits(np.where(shift < 64, bits, 0).astype(np.uint8)).tobytes()


def flac_encode(pcm, sample_rate: int = 48_000, block: int = FLAC_BLOCK):
    """(the FLAC stream's bytes, the count of each subframe kind) of 16-bit
    PCM int16[N] or int16[C, N], C = 1 or 2 coded as independent channels:
    the STREAMINFO block with the samples' MD5, then frames of `block`
    samples (the last one shorter), each with its header CRC-8, CONSTANT,
    VERBATIM or FIXED subframes with Rice residuals, and its CRC-16."""
    x = np.asarray(pcm, np.int16)
    if x.ndim == 1:
        x = x[None]
    ch, n = x.shape
    crc8 = _crc8_table()
    kinds, frames = {}, []
    for f, start in enumerate(range(0, n, block)):
        size = min(block, n - start)
        bs_code = 12 if size == 4096 else 7
        hdr = [0xFF, 0xF8, (bs_code << 4) | FLAC_RATE_CODES.get(sample_rate, 0),
               ((ch - 1) << 4) | (4 << 1), *_utf8_number(f)]
        if bs_code == 7:
            hdr += [(size - 1) >> 8, (size - 1) & 0xFF]
        c = 0
        for b in hdr:
            c = int(crc8[c ^ b])
        values, widths = [np.array(hdr + [c])], [np.full(len(hdr) + 1, 8)]
        for k in range(ch):
            kind, v, w = _subframe(x[k, start:start + size].astype(np.int64))
            values.append(np.asarray(v))
            widths.append(np.asarray(w))
            kinds[kind] = kinds.get(kind, 0) + 1
        widths.append(np.array([-int(sum(w.sum() for w in widths)) % 8]))
        values.append(np.array([0]))
        frames.append(_pack(np.concatenate(values), np.concatenate(widths).astype(np.int64)))
    info = (sample_rate << 44) | ((ch - 1) << 41) | (15 << 36) | n
    max_frame = max(len(fr) + 2 for fr in frames)
    streaminfo = (block.to_bytes(2, "big") * 2 + (0).to_bytes(3, "big")
                  + max_frame.to_bytes(3, "big") + info.to_bytes(8, "big")
                  + hashlib.md5(x.T.astype("<i2").tobytes()).digest())
    out = bytearray(b"fLaC" + bytes([0x80, 0, 0, 34]) + streaminfo)
    for fr in frames:
        out += fr + flac_crc16(fr).to_bytes(2, "big")
    return bytes(out), kinds


CLI_GAIN = 0.5          # the captures' level in the CLI's files: their peaks (~1.25) clip at full scale
CLI_4B5B_FILES = 8
CLI_MAX_FRAMES = 256    # the CLI's --max-frames default
CLI_BUDGET_S = 30.0     # phase 2 (cli) end to end


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, runs: int = RUNS) -> float:
    """Median milliseconds of `fn` on the card, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def busy_share(torch, fn, calls: int = 5) -> float | None:
    """The share of wall time the card spends in kernels and copies over
    `calls` calls of `fn` (torch.profiler's device events), or None when the
    profiler traced no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy_us / wall_us if busy_us > 0 else None


def peak_memory(torch, fn) -> str:
    """The peak device memory of one call of `fn`, and how far it rose above
    what was resident before it (the inputs of every phase so far)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return (f"{peak / 2**20:.1f} MiB ({(peak - resident) / 2**20:.1f} MiB above the "
            f"{resident / 2**20:.1f} MiB resident before the call)")


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, what sets it) for work moving `n_bytes` and doing `n_ops`."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bench_frames(rng):
    """The bench's 64 frames of random 128-byte payloads."""
    from trackmaker_tpu_torch.core.framing import Frame

    return [Frame.new_data(i & 0xFF, 1, 2, rng.integers(0, 256, PAYLOAD, dtype=np.uint8).tobytes())
            for i in range(N_FRAMES)]


def captures(torch, cfg, seed: int, dev):
    """The bench's input for `cfg`: 64 frames and 32 noisy captures on `dev`."""
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    rng = np.random.default_rng(seed)
    frames = bench_frames(rng)
    wave = PhyEncoder(cfg, device=dev).encode_frames(frames, gap_samples=GAP)
    noise = rng.normal(0, NOISE, (BATCH, wave.shape[0])).astype(np.float32)
    return frames, (wave[None] + torch.from_numpy(noise).to(dev)).contiguous()


def eq_captures(torch, cfg, seed: int, dev):
    """The equalized_b32 input (bench.py's equalized row), built on `dev`:
    64 frames through the echo channel, 32 captures with noise from a
    seeded generator."""
    from trackmaker_tpu_torch.dsp import channel
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    frames = bench_frames(np.random.default_rng(seed))
    wave = PhyEncoder(cfg, device=dev).encode_frames(frames, gap_samples=GAP)
    ech = channel.multipath(wave, EQ_TAPS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((BATCH, ech.shape[0]), generator=gen, device=dev) * EQ_NOISE
    return frames, (ech[None] + noise).contiguous()


def dd_capture(torch, cfg, dev):
    """(the decision-directed corpus f32[T] on `dev`, the payloads sent):
    encoded on the host, the echo added in float64 and the noise drawn by
    NumPy, so that every machine builds the same samples."""
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    rng = np.random.default_rng(DD_SEED)
    frames = [Frame.new_data(i & 0xFF, 1, 2, rng.integers(0, 256, PAYLOAD, dtype=np.uint8).tobytes())
              for i in range(DD_FRAMES)]
    wave = PhyEncoder(cfg, device="cpu").encode_frames(frames, gap_samples=0).numpy()
    wave = np.concatenate([wave, np.zeros(600, np.float32)])
    delay, amp = DD_ECHO
    ech = wave.astype(np.float64)
    ech[delay:] += amp * wave[:-delay].astype(np.float64)
    ech = (ech + rng.normal(0, DD_NOISE, len(ech))).astype(np.float32)
    cut = int((cfg.preamble_len + cfg.frame_samples(PAYLOAD)) * DD_CUT)
    return torch.from_numpy(ech[cut:]).to(dev), [f.data for f in frames]


def search_capture(torch, cfg, dev):
    """(the clock search's capture f32[T] on `dev`, its frames)."""
    from trackmaker_tpu_torch.dsp import channel
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    frames = bench_frames(np.random.default_rng(SEARCH_SEED))
    wave = PhyEncoder(cfg, device=dev).encode_frames(frames, gap_samples=GAP)
    return channel.clock_offset(wave, SEARCH_PPM), frames


def gate_capture(torch, cfg, dev, quiet: int = GATE_QUIET):
    """(the timing gate's capture f32[T] on `dev`, its frames): built on the
    host, each frame of GATE_SKEWS resampled at its ppm by the port's
    ``clock_offset`` (bit for bit the JAX package's) and followed by `quiet`
    samples of silence, the others by GAP, the noise from NumPy."""
    from trackmaker_tpu_torch.dsp import channel
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    rng = np.random.default_rng(GATE_SEED)
    frames = bench_frames(rng)
    enc = PhyEncoder(cfg, device="cpu")
    parts = []
    for i, f in enumerate(frames):
        w = enc.encode_frame(f)
        if i in GATE_SKEWS:
            w = channel.clock_offset(w, GATE_SKEWS[i])
        parts += [w.numpy(), np.zeros(quiet if i in GATE_SKEWS else GAP, np.float32)]
    wave = np.concatenate(parts)
    x = (wave + rng.normal(0, GATE_NOISE, len(wave))).astype(np.float32)
    return torch.from_numpy(x).to(dev), frames


def mac_run(name: str, link, phy_config, mac_config, **kw):
    """(data, received, stats) of MAC_RUNS[name] through `link`, a mapping of
    "csma", "gbn" and "sr" to a package's transfer_over_bus, gbn_transfer and
    sr_transfer, of "ofdm_v2" to its OfdmStreamPhyV2, of "coded_manchester"
    to its CodedManchesterPhy (which takes the run's PhyConfig), of
    "ofdm_adaptive" to its OfdmAdaptiveStreamPhy (which takes the run's
    loading) and of "psk" and "fsk" to its PskStreamPhy and FskStreamPhy,
    with its PhyConfig and MacConfig classes; `kw` goes to the transfer and
    to a stream PHY (the port's `device`)."""
    arq, n_bytes, opts = MAC_RUNS[name]
    opts = dict(opts)
    phy = opts.pop("phy", None)
    cfg = phy_config(**{k: opts.pop(k) for k in ("line_coding", "correlation_threshold")
                        if k in opts})
    if phy is not None:
        args = (cfg,) if phy.startswith("coded") else ()
        phy_kw = {"loading": opts.pop("loading")} if "loading" in opts else {}
        opts["phy_factory"] = lambda addr: link[phy](*args, local_addr=addr, **phy_kw, **kw)
    mac_cfg = mac_config(energy_threshold=opts.pop("energy_threshold", 0.5))
    data = bytes(range(256)) * (n_bytes // 256)
    received, stats = link[arq](data, cfg=cfg, mac_cfg=mac_cfg, **opts, **kw)
    return data, received, stats


def net_modules(package: str) -> dict:
    """The modules of NET_MODULES under `package`, by short name."""
    return {short: importlib.import_module(f"{package}.{path}")
            for short, path in NET_MODULES.items()}


class LineCodedPhy:
    """A stream PHY over a package's PhyEncoder and PhyDecoder: the duck
    type (encode_frames, process_samples, reset) that phy_factory hands
    AcousticInterface."""

    def __init__(self, encoder, decoder):
        self.encoder, self.decoder = encoder, decoder

    def encode_frames(self, frames):
        return self.encoder.encode_frames(frames)

    def process_samples(self, samples):
        return self.decoder.process_samples(samples)

    def reset(self) -> None:
        self.decoder.reset()


def ping_run(name: str, mods, **kw) -> dict:
    """The stats dict of PING_RUNS[name] through the run_ping_simulation of
    `mods` (net_modules of a package); `kw` goes to it and to a stream
    PHY's encoder and decoder (the port's `device`)."""
    opts = dict(PING_RUNS[name])
    coding = opts.pop("line_coding", None)
    if opts.pop("phy", None) == "ofdm_v2":
        opts["phy_factory"] = lambda mac: mods["ofdm_v2"].OfdmStreamPhyV2(local_addr=mac, **kw)
    if coding is not None:
        cfg = mods["config"].PhyConfig(line_coding=coding)
        opts["phy_factory"] = lambda mac: LineCodedPhy(
            mods["encoder"].PhyEncoder(cfg, **kw), mods["decoder"].PhyDecoder(cfg, mac, 8, **kw))
    return mods["tools"].run_ping_simulation(**opts, **kw)


class WifiHost:
    """A host on the router's WiFi loopback (192.168.2.2, MAC ...:03): it
    answers ARP for its address and echoes every ICMP echo request."""

    def __init__(self, mods, port):
        self.eth, self.icmp, self.ip = mods["ethernet"], mods["icmp"], mods["ip"]
        self.port = port
        self.addr = bytes([192, 168, 2, 2])
        self.mac = bytes([0, 0, 0, 0, 0, 3])
        self.pings_seen = 0

    def poll(self) -> None:
        eth, icmp_m, ip = self.eth, self.icmp, self.ip
        while (raw := self.port.recv()) is not None:
            frame = eth.EthernetFrame.from_bytes(raw)
            if frame.ethertype == eth.ETHERTYPE_ARP:
                arp = eth.ArpPacket.from_bytes(frame.payload)
                if arp.opcode == eth.ARP_REQUEST and bytes(arp.target_ip) == self.addr:
                    self.port.send(eth.ArpPacket.reply(self.mac, self.addr, arp.sender_mac,
                                                       arp.sender_ip).to_ethernet())
            elif frame.ethertype == eth.ETHERTYPE_IPV4:
                hdr = ip.Ipv4Header.from_bytes(frame.payload)
                if hdr.protocol != 1:
                    continue
                icmp = icmp_m.IcmpPacket.from_bytes(frame.payload[hdr.ihl_bytes:])
                if icmp.icmp_type != icmp_m.ICMP_ECHO_REQUEST:
                    continue
                self.pings_seen += 1
                reply = icmp_m.IcmpPacket.echo_reply(icmp.identifier, icmp.sequence_number,
                                                     icmp.payload)
                out = ip.build_ipv4_packet(1, hdr.dest_ip, hdr.source_ip, reply.to_bytes())
                self.port.send(eth.EthernetFrame(frame.src_mac, self.mac, eth.ETHERTYPE_IPV4,
                                                 out).to_bytes())


def router_run(mods, **kw) -> dict:
    """The router run of PING_RUNS through `mods` (net_modules of a
    package): the acoustic node 192.168.1.2 (MAC 2) pings the WiFi host
    192.168.2.2 through a Router whose acoustic side (MAC 1) is an
    AcousticRouterPort and whose WiFi side a LoopbackPort pair, until the
    reply comes back over sound or 30 s of airtime pass; `kw` goes to both
    AcousticInterfaces (the port's `device`).  Returns the reply's fields
    and the router's and the host's counters."""
    config, rt, ports = mods["config"], mods["router"], mods["ports"]
    cfg, mac_cfg, net_cfg = config.PhyConfig(), config.MacConfig(), config.NetConfig()
    bus = mods["bus"].SimulatedBus()
    ep_node, ep_router = mods["audio"].AudioEndpoint("node1"), mods["audio"].AudioEndpoint("router")
    iface = mods["interface"].AcousticInterface
    if_node = iface(ep_node, cfg, mac_cfg, net_cfg, local_mac=2, **kw)
    if_router = iface(ep_router, cfg, mac_cfg, net_cfg, local_mac=1, **kw)
    router = rt.Router(rt.RouterConfig(acoustic_mac=1))
    router.register_port(rt.InterfaceType.ACOUSTIC, ports.AcousticRouterPort(if_router))
    wifi_mine, wifi_theirs = ports.LoopbackPort.pair()
    router.register_port(rt.InterfaceType.WIFI, wifi_mine)
    host = WifiHost(mods, wifi_theirs)

    class Node:
        def __init__(self, *tickers):
            self.tickers = tickers

        def on_tick(self, now):
            for tick in self.tickers:
                tick(now)

    bus.attach(ep_node, Node(if_node.on_tick))
    bus.attach(ep_router, Node(if_router.on_tick, lambda now: router.poll(),
                               lambda now: host.poll()))
    echo = mods["icmp"].IcmpPacket.echo_request(0x99, 1, ROUTER_PAYLOAD)
    if_node.send_packet(mods["ip"].build_ipv4_packet(
        1, bytes([192, 168, 1, 2]), bytes([192, 168, 2, 2]), echo.to_bytes(), ttl=64),
        dest_mac=1, frame_type=config.FRAME_TYPE_DATA)
    reply = None
    for _ in range(int(30 * bus.sample_rate / bus.chunk)):
        bus.step()
        if (reply := if_node.recv_packet()) is not None:
            break
    out = {"pings_seen": host.pings_seen, "forwarded": router.forwarded,
           "dropped": router.dropped, "airtime_s": bus.now / bus.sample_rate, "reply": None}
    if reply is not None:
        packet, frame_type, src_mac = reply
        hdr = mods["ip"].Ipv4Header.from_bytes(packet)
        icmp = mods["icmp"].IcmpPacket.from_bytes(packet[hdr.ihl_bytes:])
        out.update(reply=packet.hex(), frame_type=frame_type, src_mac=src_mac,
                   src=".".join(map(str, hdr.source_ip)), dst=".".join(map(str, hdr.dest_ip)),
                   ttl=hdr.ttl, icmp_type=icmp.icmp_type, payload=icmp.payload)
    return out


def stream_capture(encode_frame, rng):
    """(payloads, arrival chunk of each frame, wave) of the streaming latency
    run: `encode_frame(i, payload)` gives frame i's waveform as NumPy."""
    total = 48_000 * STREAM_SECONDS
    wave = np.zeros(total, np.float32)
    step = total // (STREAM_FRAMES + 1)
    payloads, arrival = [], []
    for i in range(STREAM_FRAMES):
        payloads.append(bytes([i]) * STREAM_PAYLOAD)
        w = encode_frame(i, payloads[-1])
        p = (i + 1) * step
        wave[p:p + len(w)] = w
        arrival.append((p + len(w)) // STREAM_CHUNK)
    wave += rng.normal(0, STREAM_NOISE, total).astype(np.float32)
    return payloads, arrival, wave


def ofdm_frames(rng=None):
    """ofdm_v2_b32's frames, drawn from `rng` (default_rng(OFDM_SEED))."""
    from trackmaker_tpu_torch.core.framing import Frame

    rng = np.random.default_rng(OFDM_SEED) if rng is None else rng
    return [Frame.new_data(i, 1, 2, rng.integers(0, 256, OFDM_PAYLOAD, dtype=np.uint8).tobytes())
            for i in range(OFDM_FRAMES)]


def ofdm_input(v1: bool = False):
    """(frames, captures f32[OFDM_BATCH, T] in NumPy) of ofdm_v2_b32, or of
    the v1 run: built on the host, so that every machine builds the same
    samples."""
    from trackmaker_tpu_torch.phy.ofdm import OfdmModem
    from trackmaker_tpu_torch.phy.ofdm_v2 import OfdmModemV2

    rng = np.random.default_rng(OFDM_SEED)
    frames = ofdm_frames(rng)
    modem = OfdmModem(device="cpu") if v1 else OfdmModemV2(device="cpu")
    wave = modem.encode_frames(frames, gap_samples=OFDM_GAP)
    if v1:
        rng = np.random.default_rng(OFDM_SEED + 1)
    return frames, np.stack([(wave + rng.normal(0, OFDM_NOISE, len(wave))).astype(np.float32)
                             for _ in range(OFDM_BATCH)])


def coded_input():
    """(frames, captures f32[CODED_BATCH, T] in NumPy) of coded_manchester_b8,
    built on the host."""
    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.coded import CodedManchesterPhy

    rng = np.random.default_rng(CODED_SEED)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, CODED_PAYLOAD, dtype=np.uint8)
                             .tobytes()) for i in range(CODED_FRAMES)]
    wave = CodedManchesterPhy(PhyConfig(), device="cpu").encode_frames(frames,
                                                                       gap_samples=CODED_GAP)
    return frames, np.stack([(wave + rng.normal(0, CODED_NOISE, len(wave))).astype(np.float32)
                             for _ in range(CODED_BATCH)])


def coded4_input():
    """(frames, captures f32[2, T] in NumPy, zero-padded to the longer) of the
    coded 4B5B rate-3/4 batch, built on the host as
    tests/test_coded_phy.py builds it."""
    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.coded import CodedFourB5BPhy

    phy = CodedFourB5BPhy(PhyConfig(line_coding="4b5b", correlation_threshold=0.45),
                          local_addr=2, rate34=True, device="cpu")
    rng = np.random.default_rng(CODED4_SEED)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, CODED4_PAYLOAD, dtype=np.uint8)
                             .tobytes()) for i in range(CODED4_FRAMES)]
    caps = []
    for b in range(2):
        wave = phy.encode_frames(frames, gap_samples=257 + 31 * b)
        lead = int(rng.integers(0, 300))
        x = np.concatenate([np.zeros(lead, np.float32), wave, np.zeros(400, np.float32)])
        caps.append((x + rng.normal(0, CODED4_NOISE, len(x))).astype(np.float32))
    batch = np.zeros((2, max(len(c) for c in caps)), np.float32)
    for b, c in enumerate(caps):
        batch[b, :len(c)] = c
    return frames, batch


def adaptive_loading() -> tuple:
    """ofdm_adaptive_loaded_b8's loading: tests/test_parallel_ofdm.py:90-93's
    draw, bits {1, 2, 4, 6} with p 0.2 / 0.4 / 0.3 / 0.1 from
    default_rng(3)."""
    rng = np.random.default_rng(3)
    return tuple(int(v) for v in rng.choice([1, 2, 4, 6], size=ADAPTIVE_N_DATA,
                                            p=[0.2, 0.4, 0.3, 0.1]))


def adaptive_input(loaded: bool = False):
    """(frames, captures f32[ADAPTIVE_BATCH, T] in NumPy) of ofdm_adaptive_b8,
    or with `loaded` of ofdm_adaptive_loaded_b8, built on the host."""
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.ofdm_adaptive import OfdmAdaptiveStreamPhy

    phy = OfdmAdaptiveStreamPhy(loading=adaptive_loading() if loaded else None, local_addr=2,
                                device="cpu")
    rng = np.random.default_rng(ADAPTIVE_SEED + int(loaded))
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, ADAPTIVE_PAYLOAD, dtype=np.uint8)
                             .tobytes()) for i in range(ADAPTIVE_FRAMES)]
    wave = phy.encode_frames(frames, gap_samples=ADAPTIVE_GAP)
    sigma = ADAPTIVE_LOADED_NOISE if loaded else ADAPTIVE_NOISE
    return frames, np.stack([(wave + rng.normal(0, sigma, len(wave))).astype(np.float32)
                             for _ in range(ADAPTIVE_BATCH)])


def shaped_channel(wave: np.ndarray, rng, sigma: float, cut_rel: float = 0.55,
                   floor: float = 0.02) -> np.ndarray:
    """tests/test_ofdm_adaptive_mac.py's roll-off channel: the bins above
    `cut_rel` of the OFDM band attenuated to `floor` (a logistic edge 600 Hz
    wide) in the frequency domain of the whole capture, then noise `sigma`
    from `rng`."""
    n = len(wave)
    spec = np.fft.rfft(wave)
    f = np.fft.rfftfreq(n, 1.0 / 48_000)
    lo, hi = 2_062.0, 10_031.0
    cut = lo + cut_rel * (hi - lo)
    width = 600.0
    gain = np.where(f > cut, floor + (1 - floor) / (1 + np.exp((f - cut - width / 2)
                                                               / (width / 6))), 1.0)
    out = np.fft.irfft(spec * gain, n=n).astype(np.float32)
    return out + rng.normal(0, sigma, n).astype(np.float32)


def host(v) -> np.ndarray:
    """A package's array (a tensor on any device, or a JAX array) in NumPy."""
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def retrain_run(adaptive, first_start, **kw) -> dict:
    """tests/test_ofdm_adaptive_mac.py:211-287's live retrain through a
    package's ofdm_adaptive module: the probe on a mild channel and its
    loading, four frames over it, the same four over a bad channel (the
    pre-FEC monitor trips), REPROBE over the handshake mode, the probe again,
    the derated loading and its gains sent back in a LOADING frame, and the
    four frames over the bad channel at the new loading.  `first_start(cfg,
    rx)` gives the first chirp start the package's find_preambles finds in
    rx (NumPy); `kw` goes to the module's entry points (the port's
    `device`).  The channels' noise comes from default_rng(RETRAIN_SEED)."""
    rng = np.random.default_rng(RETRAIN_SEED)
    cfg = adaptive.OfdmAdaptiveConfig()
    nd = len(cfg.data_bin_idx)
    phy = adaptive.OfdmAdaptiveStreamPhy

    def mild(w):
        return shaped_channel(w, rng, sigma=0.004, cut_rel=0.95, floor=0.5)

    def bad(w):
        return shaped_channel(w, rng, sigma=0.01, cut_rel=0.45, floor=0.01)

    def pad(w):
        return np.concatenate([w, np.zeros(4000, np.float32)])

    rxp = mild(pad(adaptive.probe_waveform(cfg, **kw)))
    load0 = adaptive.choose_loading(host(adaptive.estimate_bin_snr(
        cfg, rxp, first_start(cfg, rxp), **kw)))
    tx = phy(cfg, loading=load0, local_addr=1, **kw)
    rx = phy(cfg, loading=load0, local_addr=2, **kw)
    frames = [adaptive.Frame.new_data(i, 1, 2, bytes([i]) * 40) for i in range(4)]
    got = rx.process_samples(mild(pad(tx.encode_frames(frames, 400))))
    calm = (rx.link_degraded(window=4), rx.prefec_ber(4))
    rx.process_samples(bad(pad(tx.encode_frames(frames, 400))))
    tripped = (rx.link_degraded(window=4), rx.prefec_ber(4))
    hs_rx = phy.handshake_mode(cfg, local_addr=1, **kw)
    hs_tx = phy.handshake_mode(cfg, local_addr=1, **kw)
    got_req = hs_tx.process_samples(bad(pad(hs_rx.encode_frames(
        [adaptive.make_reprobe_frame(9, 2, 1)]))))
    rxp2 = bad(pad(adaptive.probe_waveform(cfg, **kw)))
    snr1 = host(adaptive.estimate_bin_snr(cfg, rxp2, first_start(cfg, rxp2), **kw))
    load1 = adaptive.choose_loading(snr1)
    gains1 = adaptive.choose_gains(snr1, load1)
    got_upd = hs_tx.process_samples(bad(pad(hs_rx.encode_frames(
        [adaptive.make_loading_frame(10, 2, 1, load1, gains1)]))))
    ctrl = [adaptive.parse_control(f, nd) for f in (*got_req, *got_upd)]
    _, negotiated, ngains = ctrl[-1] if ctrl and ctrl[-1][0] == "loading" else (None, load1,
                                                                                gains1)
    tx2 = phy(cfg, loading=negotiated, gains=ngains, local_addr=1, **kw)
    rx2 = phy(cfg, loading=negotiated, gains=ngains, local_addr=2, **kw)
    got2 = rx2.process_samples(bad(pad(tx2.encode_frames(frames, 400))))
    return {
        "load0": adaptive.pack_loading(load0).hex(), "load1": adaptive.pack_loading(load1).hex(),
        "gains1": adaptive.pack_gains(gains1).hex(), "bits0": sum(load0), "bits1": sum(load1),
        "calm": calm, "tripped": tripped, "prefec": rx.frame_prefec,
        "control": [c[0] if c else None for c in ctrl],
        "negotiated": negotiated == load1 and ngains == gains1,
        "delivered": [[(f.sequence, f.data.hex()) for f in g] for g in (got, got2)],
        "prefec2": rx2.frame_prefec, "degraded2": rx2.link_degraded(window=4)}


def sc_input():
    """(frames, {modem: (its config's fields, the noisy capture in NumPy)}) of
    the single-carrier modems' batches, built on the host: FSK, BPSK and
    QPSK."""
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy import fsk, psk

    rng = np.random.default_rng(SC_SEED)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, SC_PAYLOAD, dtype=np.uint8)
                             .tobytes()) for i in range(SC_FRAMES)]
    modems = {"fsk": fsk.FskModem(device="cpu"),
              "bpsk": psk.PskModem(psk.PskConfig(bits_per_symbol=1), device="cpu"),
              "qpsk": psk.PskModem(psk.PskConfig(bits_per_symbol=2), device="cpu")}
    out = {}
    for name, modem in modems.items():
        wave = modem.encode_frames(frames, gap_samples=SC_GAP)
        out[name] = (modem.cfg, (wave + rng.normal(0, SC_NOISE, len(wave))).astype(np.float32))
    return frames, out


def sharded_inputs() -> dict:
    """name -> (line coding, capture f32[T] in NumPy, (dp, sp)) of the seam
    scenarios, encoded by the port's encoder on the host."""
    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.parallel.stream import halo_size
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder
    from trackmaker_tpu_torch.tools.dryrun_multichip import evil_frame

    out = {}
    for coding in ("manchester", "4b5b"):
        cfg = PhyConfig(line_coding=coding)
        enc = PhyEncoder(cfg, device="cpu")
        block = SEAM_SHARD_BLOCK
        wave = np.zeros(8 * block, np.float32)
        for pos, frame in ((block - 200, evil_frame(1, b"SHARD-EVIL")),
                           (3 * block - 40, Frame.new_data(2, 1, 2, b"plain")),
                           (5 * block + 11, evil_frame(3, b"INNER")),
                           (7 * block - 300, Frame.new_data(4, 1, 2, b"last-seam"))):
            w = enc.encode_frame(frame).numpy()
            wave[pos:pos + len(w)] = w
        out[f"evil_seam, {coding}"] = (coding, wave, SEAM_MESHES["evil_seam"])
        w = enc.encode_frame(evil_frame(7, b"CHAIN")).numpy()
        block = halo_size(cfg) + 200
        wave = np.zeros(8 * block, np.float32)
        pos, k = block - 60, 0
        while pos + len(w) < 7 * block and k < 6:   # back to back, each across a new seam
            wave[pos:pos + len(w)] = w
            pos += len(w)
            k += 1
        out[f"chain, {coding}"] = (coding, wave, SEAM_MESHES["chain"])
    return out


def ofdm_shard_input(adaptive: bool = False):
    """(modem, frames, their starts, capture f32[T] in NumPy) of a sharded
    OFDM capture, built on the host: the frames laid end to end with gaps,
    some across the seams of MESH_SHARDS shards."""
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.ofdm_adaptive import OfdmAdaptiveConfig, OfdmAdaptiveModem
    from trackmaker_tpu_torch.phy.ofdm_v2 import OfdmModemV2

    if adaptive:
        modem = OfdmAdaptiveModem(OfdmAdaptiveConfig(), loading=adaptive_loading(),
                                  device="cpu")
        rng = np.random.default_rng(OFDM_SHARD_SEED + 1)
        frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, ADAPTIVE_PAYLOAD, dtype=np.uint8)
                                 .tobytes()) for i in range(OFDM_SHARD_ADAPTIVE)]
        sigma = ADAPTIVE_LOADED_NOISE
    else:
        modem = OfdmModemV2(device="cpu")
        frames = ofdm_frames()
        rng = np.random.default_rng(OFDM_SHARD_SEED)
        sigma = OFDM_NOISE
    parts, starts, pos = [np.zeros(500, np.float32)], [], 500
    for f in frames:
        w = modem.encode_frames([f])
        gap = int(rng.integers(*OFDM_SHARD_GAPS))
        parts += [w, np.zeros(gap, np.float32)]
        starts.append(pos)
        pos += len(w) + gap
    wave = np.concatenate(parts + [np.zeros(900, np.float32)])
    wave = (wave + rng.normal(0, sigma, len(wave))).astype(np.float32)
    return modem, frames, starts, wave


def optimistic_input():
    """(frames, captures f32[OPT_ROWS, T] in NumPy, valid lengths int32) of
    the optimistic batch, built on the host."""
    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    cfg = PhyConfig(line_coding="4b5b", samples_per_level=OPT_SPL)
    rng = np.random.default_rng(OPT_SEED)
    frames = [Frame.new_data(i, 1, LOCAL_ADDR, rng.integers(0, 256, OPT_PAYLOAD, dtype=np.uint8)
                             .tobytes()) for i in range(OPT_FRAMES)]
    enc = PhyEncoder(cfg, device="cpu")
    wave = enc.encode_frames(frames, gap_samples=OPT_GAP).numpy()
    t = OPT_LEAD + len(wave) + 500
    x = np.zeros((OPT_ROWS, t), np.float32)
    x[:, OPT_LEAD:OPT_LEAD + len(wave)] = wave
    x += rng.normal(0, OPT_NOISE, x.shape).astype(np.float32)
    step = len(enc.encode_frame(frames[0])) + OPT_GAP
    sym = OPT_LEAD + 3 * step + cfg.preamble_len + 40 * 5 * OPT_SPL   # symbol 40: payload
    x[list(OPT_BROKEN_ROWS), sym:sym + 5 * OPT_SPL] = 0.0
    return frames, x, np.full(OPT_ROWS, t, np.int32)


def optimistic_digest(conformant, opt: dict, fast: dict) -> str:
    """A short SHA-256 of the optimistic scan's conformant flags and fields
    and of the fast decode's fields (DIGEST_FIELDS, NumPy arrays of either
    package): equal digests mean equal decisions, slot for slot."""
    import hashlib

    h = hashlib.sha256(np.ascontiguousarray(conformant, np.uint8).tobytes())
    for fields in (opt, fast):
        for name in DIGEST_FIELDS:
            dtype = np.uint8 if name in ("valid", "frame_bytes") else np.int32
            h.update(np.ascontiguousarray(fields[name], dtype).tobytes())
    return h.hexdigest()[:16]


def ofdm_digest(starts, bits) -> str:
    """A short SHA-256 of a batch decode's decisions (the OFDM or coded
    runs'): the starts as int32 and the bits as uint8, NumPy arrays of any
    package."""
    import hashlib

    h = hashlib.sha256(np.ascontiguousarray(starts, np.int32).tobytes())
    h.update(np.ascontiguousarray(bits, np.uint8).tobytes())
    return h.hexdigest()[:16]


def payload_digest(payloads) -> str:
    """A short SHA-256 of a set of payloads, sorted, each after its length."""
    import hashlib

    h = hashlib.sha256()
    for p in sorted(payloads):
        h.update(len(p).to_bytes(2, "big") + p)
    return h.hexdigest()[:16]


def frame_list(res, row: int | None = None):
    """The valid frames of one capture (of a batch: row `row`), in slot
    order, as comparable tuples."""
    pick = (lambda a: a.cpu().numpy()) if row is None else (lambda a: a[row].cpu().numpy())
    valid = pick(res.valid)
    cols = [pick(getattr(res, f)) for f in
            ("length", "frame_type", "sequence", "src", "dst", "start")]
    fb = pick(res.frame_bytes)
    out = []
    for k in np.nonzero(valid)[0]:
        n = 7 + int(cols[0][k])
        out.append((fb[k, :n].tobytes(), *(int(c[k]) for c in cols)))
    return out


def compare_rows(torch, rows_k, rows_p, corr_p, thr, what: str) -> tuple[float, int, int]:
    """Hit rows of a kernel against its plain version's: a lag within
    CORR_ATOL of the threshold may fall on either side of it, and every
    other lag must give the same hits, counts and refine deltas, with the
    corr at each hit within CORR_ATOL.  Returns (hit corr max |err|, lags
    near the threshold, rows differing there)."""
    b, n_rows, _ = rows_k.shape
    near = (corr_p - thr).abs() < CORR_ATOL
    near_rows = torch.nn.functional.pad(near, (0, n_rows * 128 - near.shape[1]))
    near_rows = near_rows.reshape(b, n_rows, 128).any(-1)
    same = (rows_k[..., :5] == rows_p[..., :5]).all(-1) & (rows_k[..., 9:] == rows_p[..., 9:]).all(-1)
    require(bool((same | near_rows).all()), f"{what} hit rows differ away from the threshold")
    hit_vals = rows_k[..., 5:9].contiguous().view(torch.float32)
    hit_vals_p = rows_p[..., 5:9].contiguous().view(torch.float32)
    val_err = (hit_vals - hit_vals_p)[same].abs().max().item()
    require(val_err <= CORR_ATOL, f"{what} hit corr differs by {val_err}")
    return val_err, int(near.sum()), int((~same).sum())


def refine_kw(cfg) -> dict:
    """The sync-refine fold's settings of `cfg`, as the decode sets them."""
    return dict(sync_off=cfg.preamble_len - cfg.sync_len - cfg.sync_margin,
                n_pos=2 * cfg.sync_margin + 1, sync_len=cfg.sync_len, fall_off=cfg.preamble_len)


def check_xcorr(torch, xcorr_hits, xcorr_hits_plain, x, pre, thr, tag: str):
    """xcorr_hits against its plain version; returns (max |err|, rows, plain corr)."""
    corr_k, rows_k = xcorr_hits(x, pre, thr, emit_corr=True)
    torch.cuda.synchronize()
    corr_p, rows_p = xcorr_hits_plain(x, pre, thr, emit_corr=True)
    err = (corr_k - corr_p).abs().max().item()
    require(err <= CORR_ATOL, f"xcorr_hits ({tag}) corr differs by {err}")
    _, rows_main = xcorr_hits(x, pre, thr)
    require(torch.equal(rows_main, rows_k), f"xcorr_hits ({tag}) rows depend on emit_corr")
    val_err, n_near, n_diff = compare_rows(torch, rows_k, rows_p, corr_p, thr, f"xcorr_hits ({tag})")
    log(f"phase 1: xcorr_hits == plain at L={len(pre)} (corr max |err| {err:.3g}, hit corr "
        f"{val_err:.3g}, {n_near} lags within {CORR_ATOL} of the threshold, "
        f"{n_diff} rows differing there)")
    return max(err, val_err), rows_k, corr_p


def check_fold(torch, sd, xh, cfg, x, vlens, thr, corr_p, tag: str) -> tuple[dict, dict]:
    """Phase 1 for the sync-refine fold at one line code's shapes, at
    threshold `thr`: the refine entry against its plain version and, in
    columns 0..8, the hit kernel's rows bit for bit; its frame starts
    against the legacy attempt kernel's on the same candidates; the fold
    attempt against its plain version and against the legacy kernel.
    Returns the max |err| per kernel and the fold's inputs and outputs."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync.correlate import preamble_energy

    pre = preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    kw = refine_kw(cfg)
    _, rows_k = xh.xcorr_hits(x, pre, thr)
    rows_r = xh.xcorr_hits_refine(x, vlens, pre, sync, thr, **kw)
    torch.cuda.synchronize()
    rows_rp = xh.xcorr_hits_refine_plain(x, vlens, pre, sync, thr, **kw)
    val_err, n_near, n_diff = compare_rows(torch, rows_r, rows_rp, corr_p, thr,
                                           f"xcorr_hits_refine ({tag})")
    require(torch.equal(rows_r[..., :9], rows_k[..., :9]),
            f"xcorr_hits_refine ({tag}) columns 0..8 differ from xcorr_hits' rows")
    cand, _, n_valid, _ = sd.compact_hit_rows(rows_k, N_CAND)
    cand_r, _, n_valid_r, _, fs_r = sd.compact_hit_rows(rows_r, N_CAND, with_fs=True)
    require(torch.equal(cand_r, cand) and torch.equal(n_valid_r, n_valid),
            f"the fold's candidate table ({tag}) differs from the legacy one")
    if cfg.line_coding == "manchester":
        attempt, fold, fold_plain = (sd.attempt_manchester, sd.attempt_manchester_fold,
                                     sd.attempt_manchester_fold_plain)
    else:
        attempt, fold, fold_plain = sd.attempt_4b5b, sd.attempt_4b5b_fold, sd.attempt_4b5b_fold_plain
    legacy = attempt(x, cand, n_valid, vlens, sync, preamble_energy(sync))
    require(torch.equal(fs_r, legacy[1]),
            f"the fold's frame starts ({tag}) differ from {attempt.__name__}'s")
    got = fold(x, fs_r, n_valid)
    torch.cuda.synchronize()
    want = fold_plain(x, fs_r, n_valid)
    fold_err = 0
    for g, w, l_ in zip(got, want, legacy):
        require(torch.equal(g, w), f"{fold.__name__} ({tag}) differs from its plain version")
        require(torch.equal(g, l_), f"{fold.__name__} ({tag}) differs from {attempt.__name__}")
        fold_err = max(fold_err, (g.int() - w.int()).abs().max().item())
    live = sd._live(cand, n_valid)
    hit = rows_r[..., :4] < 2**30
    deltas = rows_r[..., 9:13][hit]
    log(f"phase 1: xcorr_hits_refine == plain at L={len(pre)}, W={len(sync)} ({tag}: hit corr "
        f"{val_err:.3g}, {n_near} lags near the threshold, {n_diff} rows differing there), "
        f"columns 0..8 == xcorr_hits bit for bit, cand + delta == {attempt.__name__}'s fs on all "
        f"{int(live.sum())} live candidates ({deltas.numel()} refined hits, deltas "
        f"{int(deltas.min())}..{int(deltas.max())}); {fold.__name__} == plain and == "
        f"{attempt.__name__}")
    return ({"xcorr_hits_refine": val_err, fold.__name__: fold_err},
            dict(rows=rows_r, hit=hit, fs=fs_r, n_valid=n_valid, kw=kw, sync=sync,
                 hits=int(hit.sum())))


def check_refine_edges(torch, sd, xh, cfg, x, corr_p, tag: str) -> dict:
    """The fold's checks on a batch where the refine must move and must
    fall back: the main path's captures at threshold EDGE_THR, which makes
    hits of the lags around each preamble and in the payload (their sync
    word lies off the expected position), and valid lengths that, in each
    even capture r, cut the refine window of one hit, in a block's last row
    where one lies among the first candidates, to m = r/2 mod (n_pos + 1)
    valid positions (m = 0: the fallback), and every window past it to
    none; odd captures keep their full length.
    Returns the max |err| per kernel."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform

    kw = refine_kw(cfg)
    b, t = x.shape
    _, rows0 = xh.xcorr_hits(x, preamble_waveform(cfg), EDGE_THR)
    cand0 = sd.compact_hit_rows(rows0, N_CAND)[0][:, 8:N_CAND // 2].cpu().numpy()
    vlen = np.full(b, t, np.int64)
    for r in range(0, b, 2):
        last = cand0[r][(cand0[r] // 128) % 8 == 7]
        h = int(last[0] if last.size else cand0[r, 0])
        vlen[r] = h + kw["sync_off"] + kw["sync_len"] - 1 + (r // 2) % (kw["n_pos"] + 1)
    vlens = torch.from_numpy(vlen.astype(np.int32)).to(x.device)
    errs, out = check_fold(torch, sd, xh, cfg, x, vlens, EDGE_THR, corr_p, f"{tag} edges")
    rows, hit = out["rows"], out["hit"]
    pos = rows[..., :4].long()
    n_ok = (vlens.long()[:, None, None] - kw["sync_len"] - kw["sync_off"] - pos + 1).clamp(
        0, kw["n_pos"])                                     # valid refine positions of each hit
    deltas = rows[..., 9:13]
    moved = hit & (deltas != kw["fall_off"])
    last_row = (torch.arange(rows.shape[1], device=x.device) % 8 == 7)[None, :, None]
    trimmed = hit & (n_ok > 0) & (n_ok < kw["n_pos"])
    fallback = hit & (n_ok == 0)
    counts = {"moved": int(moved.sum()), "moved in a block's last row": int((moved & last_row).sum()),
              "trimmed": int(trimmed.sum()), "fallback": int(fallback.sum())}
    require(all(counts.values()), f"xcorr_hits_refine ({tag} edges): a case is missing: {counts}")
    require(bool((deltas[fallback] == kw["fall_off"]).all()),
            f"xcorr_hits_refine ({tag} edges): a hit with no valid position did not fall back")
    require(bool((deltas[trimmed] - kw["sync_off"] - kw["sync_len"] < n_ok[trimmed]).all()),
            f"xcorr_hits_refine ({tag} edges): a trimmed refine chose an invalid position")
    log(f"phase 1: xcorr_hits_refine ({tag} edges, threshold {EDGE_THR}): {out['hits']} refined "
        f"hits, {counts}")
    return errs


def check_tap_sweep(torch, xh, xn, x, pre, thr) -> int:
    """Kernel #1's dense corr against tm_normalized_xcorr's (xcorr_norm.cu,
    the first design's loop), bit for bit, for every pattern length L in
    1..128 (the preamble repeated and cut) on SWEEP_B captures of SWEEP_T
    samples, and its rows against the plain hit rows of that corr, bit for
    bit: every remainder of the kernel's tap steps.  Returns the hits."""
    xx = x[:SWEEP_B, :SWEEP_T].contiguous()
    n_rows = -(-SWEEP_T // 128)
    patterns = np.tile(pre, -(-xh.MAX_PATTERN // len(pre)))
    hits = 0
    for l in range(1, xh.MAX_PATTERN + 1):
        corr, rows = xh.xcorr_hits(xx, patterns[:l], thr, emit_corr=True)
        dense = xn.normalized_xcorr_dense(xx, patterns[:l])
        torch.cuda.synchronize()
        require(torch.equal(corr, dense),
                f"tap sweep: xcorr_hits' corr at L={l} differs from normalized_xcorr's")
        require(torch.equal(rows, xh.hit_rows_plain(corr, n_rows, thr)),
                f"tap sweep: xcorr_hits' rows at L={l} differ from the plain rows of its corr")
        hits += int(rows[..., 4].sum())
    require(hits > 0, "tap sweep: no hit at any pattern length")
    log(f"phase 1: tap sweep: xcorr_hits' corr == normalized_xcorr's bit for bit and its rows == "
        f"the plain rows of that corr at every L in 1..{xh.MAX_PATTERN} on {SWEEP_B} x "
        f"{SWEEP_T} ({hits} hits in all)")
    return hits


def check_dense_refine(torch, sd, xh, xn, cfg, x, tag: str) -> dict:
    """The refine entry on dense hits: the first DENSE_B captures cut to
    DENSE_T samples, at DENSE_THR (rows of 1, 2, 3 and 4 or more hits in
    the same blocks) and at FULL_THR (every slot of every row live), with
    check_fold's checks (deltas equal the plain refine's, cand + delta the
    legacy attempt's frame start).  Returns the max |err| per kernel."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform

    xx = x[:DENSE_B, :DENSE_T].contiguous()
    vlens = torch.full((DENSE_B,), DENSE_T, dtype=torch.int32, device=x.device)
    corr_p = xn.normalized_xcorr_dense_plain(xx, preamble_waveform(cfg))
    errs = {}
    for thr in (DENSE_THR[cfg.line_coding], FULL_THR):
        e, out = check_fold(torch, sd, xh, cfg, xx, vlens, thr, corr_p,
                            f"{tag} dense hits at {thr}")
        for k_name, v in e.items():
            errs[k_name] = max(errs.get(k_name, 0), v)
        counts = out["rows"][..., 4].clamp(max=4)
        need = [1, 2, 3, 4] if thr == DENSE_THR[cfg.line_coding] else [4]
        seen = {n: int((counts == n).sum()) for n in need}
        require(all(seen.values()), f"xcorr_hits_refine ({tag} dense hits at {thr}): rows of "
                                    f"each count {need} wanted, got {seen}")
        log(f"phase 1: xcorr_hits_refine ({tag} dense hits at threshold {thr}, {DENSE_B} x "
            f"{DENSE_T}): rows by hit count (4 = 4 or more) {seen}, {out['hits']} refined hits")
    return errs


def device_ms(torch, fn, kernel: str, calls: int = RUNS) -> tuple[float, int] | None:
    """The median device time (ms) of a launch of the CUDA kernel whose name
    holds `kernel`, over `calls` calls of `fn` (torch.profiler's kernel
    events), and the profiling sessions it took: the first of
    PROFILE_SESSIONS sessions that traced every one of the `calls`
    launches; None when none did (the profiler can drop kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(times) == calls:
            return statistics.median(times), attempt
        log(f"device time of {kernel}: {len(times)} of {calls} launches traced "
            f"(session {attempt} of {PROFILE_SESSIONS})")
    return None


def graph_ms(torch, fn) -> float:
    """Device ms a launch of `fn`: CUDA events around a CUDA graph of
    GRAPH_LAUNCHES calls (captured on a side stream after a warm-up call),
    median of GRAPH_REPLAYS replays.  The graph is timing scaffolding: no
    path of the port launches one."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_LAUNCHES)
    return statistics.median(times)


def traced_ms(torch, fn, kernel: str, calls: int = RUNS) -> tuple[float | None, int]:
    """torch.profiler's median device ms of the kernel whose name holds
    `kernel` over `calls` calls of `fn`, and how many launches it traced
    (one session; None when it traced none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    return (statistics.median(times) if times else None), len(times)


def host_ms(torch, fn, calls: int = HOST_CALLS) -> float:
    """The host's ms for one call of `fn` (time.perf_counter around the
    call, the card synchronised between calls, not inside): median of
    `calls`."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def toolchain(torch, _build) -> str:
    """nvcc's release, the driver's version and torch's build: the large
    launch parameters of xcorr_norm.cu need CUDA 12.1 or later."""
    import subprocess

    nvcc = [line for line in subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                                            text=True, check=True).stdout.splitlines()
            if "release" in line][0]
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True,
                            timeout=60).stdout.strip().splitlines()[0]
    return f"nvcc {nvcc}, driver {driver}, torch {torch.__version__} (CUDA {torch.version.cuda})"


SASS_OPS = ("FFMA", "FMUL", "FADD", "LDS")   # the sums' instructions and shared loads


def kernel_resources(_build, src: str) -> dict[str, dict[str, int]]:
    """The registers, stack, static shared memory and local memory (spills)
    of each kernel function in the library built from csrc/<src>.cu, as
    ``cuobjdump -res-usage`` (beside nvcc) reads them, and the count of each
    of SASS_OPS in its code (``cuobjdump -sass``, any suffix)."""
    import re
    import subprocess
    from pathlib import Path

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    lib = str(_build.library_path(src))
    out = subprocess.run([str(tool), "-res-usage", lib], capture_output=True, text=True,
                         check=True).stdout
    found = {m.group(1): {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)",
                                                            m.group(2))}
             for m in re.finditer(r"Function (\S+):\s*\n([^\n]*)", out)}
    require(bool(found) and all(len(v) == 4 for v in found.values()),
            f"cuobjdump -res-usage on {src} gave no resource line:\n{out}")
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        fn_name, code = part.split("\n", 1)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", code)
        require(fn_name.strip() in found, f"cuobjdump -sass on {src}: unknown function {fn_name}")
        found[fn_name.strip()].update({op: ops.count(op) for op in SASS_OPS})
    require(all(len(v) == 4 + len(SASS_OPS) for v in found.values()),
            f"cuobjdump -sass on {src} did not give every function's code")
    return found


def check_walk_attempt_edges(torch, sd, dev) -> dict:
    """The walk and the four Manchester attempt forms against their plain
    versions, bit for bit, on the edge inputs of
    tests/test_torch_walk_attempt_design.py: walk tables of 1 to 1,000
    candidates (none present, all present, a stop first, duplicate
    positions, a cursor past all, a limit mid-table) at caps 1, L - 1, L
    and C + 1; attempts at windows across T and the valid length, starts at
    every offset mod 4, bases at and past T, a first sample off a 16-byte
    boundary, row stride 0, rows without a live slot and with more hits
    than slots."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_walk_attempt_design as edges

    errs = {"spec_walk": 0}
    n_tables = 0
    for c in edges.WALK_CS:
        for fields, cur0, limit, cap in edges.walk_edge_tables(c):
            args = (fields.to(dev), cur0.to(dev), limit.to(dev), cap)
            got = sd.spec_walk(*args)
            torch.cuda.synchronize()
            for field, g, w in zip(got._fields, got, sd.spec_walk_plain(*args)):
                require(torch.equal(g, w), f"spec_walk {field} differs on the edge table of "
                                           f"{c} candidates (max_frames {cap})")
            n_tables += 1
    inputs = edges.attempt_edge_inputs(dev)
    n_live = 0
    for form in edges.ATTEMPT_FORMS:
        xx, args = inputs[form]
        wrapper, plain = edges.attempt_call(form)
        got = wrapper(xx, *args)
        torch.cuda.synchronize()
        for field, g, w in zip(("bytes", "fs"), got, plain(xx, *args)):
            require(torch.equal(g, w), f"{wrapper.__name__} ({form}) {field} differs from its "
                                       "plain version on the edge inputs")
        k_name = wrapper.__name__ + ("_shared" if xx.stride(0) == 0 else "")
        errs[k_name] = 0
        n_live = int(sd._live(got[1], args[1]).sum())
    log(f"phase 1: spec_walk == plain on {n_tables} edge tables of {list(edges.WALK_CS)} "
        f"candidates; attempt_manchester and its fold form, per row and shared, == plain on "
        f"the edge inputs ({edges.ATT_B} x {edges.ATT_T} samples, {n_live} live slots of "
        f"{edges.ATT_B * edges.ATT_C})")
    return errs


def check_ask_walk_4b5b_edges(torch, sd, ask_spec, dev) -> dict:
    """The four 4B5B attempt forms and the ASK walk against their plain
    versions, bit for bit, on the edge inputs of
    tests/test_torch_ask_walk_4b5b_design.py: attempts at windows across T
    and the valid length, starts at every offset mod 4, bases at and past T,
    a first sample off a 16-byte boundary, row stride 0, rows without a live
    slot and with more hits than slots, near-zero levels and invalid
    symbols at 0 and 525; ASK tables of C+1 in 1..2,048 (a self-loop, a
    cycle, a miss at an emitting node, nonconf with a successor, a clean
    chain longer than max_frames) at max_frames 1..300."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_ask_walk_4b5b_design as edges

    errs = {}
    inputs = edges.fourb5b_edge_inputs(dev)
    n_live = 0
    for form in edges.FOURB_FORMS:
        xx, args = inputs[form]
        wrapper, plain = edges.attempt_4b5b_call(form)
        got = wrapper(xx, *args)
        torch.cuda.synchronize()
        for field, g, w in zip(("bytes", "fs", "first_bad", "first_zero"), got, plain(xx, *args)):
            require(torch.equal(g, w), f"{wrapper.__name__} ({form}) {field} differs from its "
                                       "plain version on the edge inputs")
        errs[wrapper.__name__ + ("_shared" if xx.stride(0) == 0 else "")] = 0
        n_live = int(sd._live(args[0], args[1]).sum())
    n_tables = 0
    for c1 in edges.ASK_C1S:
        fields = edges.ask_edge_tables(c1).to(dev)
        for mf in edges.ASK_MFS:
            got = ask_spec.ask_walk(fields, mf)
            torch.cuda.synchronize()
            for field, g, w in zip(("peaks", "fire_ok", "bad"), got,
                                   ask_spec.ask_walk_plain(fields, mf)):
                require(torch.equal(g, w), f"ask_walk {field} differs on the edge table of "
                                           f"C+1 = {c1} (max_frames {mf})")
            n_tables += 1
    errs["ask_walk"] = 0
    log(f"phase 1: attempt_4b5b and its fold form, per row and shared, == plain on the edge "
        f"inputs ({edges.B4} x {edges.T4} samples, {n_live} live slots of "
        f"{edges.B4 * edges.C4}); ask_walk == plain on {n_tables} edge tables "
        f"(C+1 in {list(edges.ASK_C1S)}, max_frames in {list(edges.ASK_MFS)})")
    return errs


def check_fire_chain_edges(torch, ask, ask_spec, dev) -> None:
    """The fire rule and the record chain against their plain versions, bit
    for bit, on the edge inputs of tests/test_torch_ask_fire_chain_design.py:
    the chain at widths 1..4,096 across its segment (32) and tile (1,024)
    edges, guards 200 and 3 (all -inf, a lone update, ties across a segment
    and a tile edge, fires at the guard, after a segment and a tile edge and
    at the last column, a row that never fires); the fire rule at w 1..11,264
    and T 1..339,453 around its tile of 4,096 and its halo (30% of upd
    set, all, none; ties at the windows' ends), its arrays aligned (float4
    and word loads) and one element into their buffers (scalar loads); w
    = 0 and past FIRE_MAX_W refused, FIRE_MAX_W taken."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_ask_fire_chain_design as edges

    n_rows = 0
    for win in edges.CHAIN_WS:
        for guard in edges.CHAIN_GUARDS:
            vals, base = (a.to(dev) for a in edges.chain_edge_rows(win, guard))
            got = ask.ask_chain(vals, base, guard)
            torch.cuda.synchronize()
            for field, g, w in zip(("fired", "peak"), got, ask.ask_chain_plain(vals, base, guard)):
                require(torch.equal(g, w), f"ask_chain {field} differs on the edge rows of width "
                                           f"{win} (guard {guard})")
            n_rows += vals.shape[0]
    n_inputs = 0
    for w in edges.FIRE_WS:
        cfg = edges.fire_cfg(w)
        for t in edges.FIRE_TS:
            for offset in (0, 1):
                sync, upd = edges.fire_edge_inputs(w, t, offset, dev)
                got = ask_spec.dense_fire_candidates(cfg, sync, upd)
                torch.cuda.synchronize()
                require(torch.equal(got, ask_spec.dense_fire_candidates_plain(cfg, sync, upd)),
                        f"ask_fire differs on the edge inputs at w={w}, T={t}, offset {offset}")
                n_inputs += 1
    sync, upd = edges.fire_edge_inputs(edges.FIRE_MAX_W, 50_001, device=dev)
    cfg = edges.fire_cfg(edges.FIRE_MAX_W)
    got = ask_spec.dense_fire_candidates(cfg, sync, upd)
    torch.cuda.synchronize()
    require(torch.equal(got, ask_spec.dense_fire_candidates_plain(cfg, sync, upd)),
            f"ask_fire differs at w={edges.FIRE_MAX_W}")
    for w in (0, edges.FIRE_MAX_W + 1):
        try:
            ask_spec.dense_fire_candidates(edges.fire_cfg(w), sync, upd)
        except RuntimeError:
            continue
        raise RuntimeError(f"ask_fire took w={w}")
    log(f"phase 1: ask_chain == plain on {n_rows} edge rows (widths {list(edges.CHAIN_WS)}, "
        f"guards {list(edges.CHAIN_GUARDS)}); ask_fire == plain on {n_inputs} edge inputs of 3 "
        f"rows (w in {list(edges.FIRE_WS)}, T in {list(edges.FIRE_TS)}, aligned and one element "
        f"in) and at w={edges.FIRE_MAX_W}; w=0 and w={edges.FIRE_MAX_W + 1} refused")


def digest(tensors) -> str:
    """A short SHA-256 of the tensors' bytes, in order: equal digests from
    two trees mean the same decisions bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def run_main_path(torch, decode_capture_fast, decode_capture, sd, cfg, x, frames,
                  kernels, tag: str, front=None, expect=None) -> dict[str, int]:
    """One main-path run through decode_capture_fast, behind the front-end
    `front` (captures in, captures out) where given, with its gates; returns
    the launch count of each kernel in `kernels`, each of which must be
    positive, or equal to `expect` where given."""
    b = x.shape[0]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if front is not None:
        x = front(x)
    res = decode_capture_fast(cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    what = "decode_capture_fast" if front is None else f"{front.__name__} + decode_capture_fast"
    log(f"phase 2 ({tag}): {what} took {wall * 1e3:.1f} ms (first call), "
        f"kernel launches {launches}")
    if expect is not None:
        require(launches == expect, f"{tag} launches {launches}, expected {expect}")
    for k_name, n in launches.items():
        require(n > 0 or expect is not None, f"the {tag} main path never launched {k_name}")
    counts = res.count.cpu().numpy()
    require(bool((counts == N_FRAMES).all()),
            f"{tag} count gate failed: {sorted(set(counts.tolist()))}")
    fb = res.frame_bytes.cpu().numpy()
    valid = res.valid.cpu().numpy()
    for r in range(b):
        for k, f in zip(np.nonzero(valid[r])[0], frames):
            require(fb[r, k, 7:7 + PAYLOAD].tobytes() == f.data,
                    f"{tag} payload gate failed at row {r} slot {k}")
    spec_res, ok = sd.decode_capture_spec(cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES)
    require(bool(ok.all()), f"a {tag} row is not ok")
    require(all(torch.equal(p, q) for p, q in zip(spec_res, res)),
            f"{tag}: decode_capture_fast differs from decode_capture_spec with every row ok")
    for r in (0, b - 1):
        exact = decode_capture(cfg, x[r], LOCAL_ADDR, MAX_FRAMES)
        require(frame_list(res, r) == frame_list(exact), f"{tag} row {r} differs from the exact scan")
        corr_gap = (res.corr[r][res.valid[r]] - exact.corr[exact.valid]).abs().max().item()
        require(corr_gap <= CORR_ATOL, f"{tag} row {r} corr differs from the exact scan by {corr_gap}")
    log(f"phase 2 ({tag}): payload gate passed ({b} rows x {N_FRAMES} frames), every row ok, "
        f"rows 0 and {b - 1} equal the exact scan; decisions digest {digest(res)}"
        + ("" if front is None else f", front end's output digest {digest([x])}"))
    return launches


def check_fallback(torch, decode_capture_fast, decode_captures, sd, cfg, small, want_frames,
                   tag: str, what: str) -> None:
    """Row 0 of `small` must be not ok and row 1 ok; the merged batch must
    equal the exact scan."""
    _, small_ok = sd.decode_capture_spec(cfg, small, LOCAL_ADDR, max_frames=MAX_FRAMES)
    require(small_ok.tolist() == [False, True], f"{tag} fallback flags {small_ok.tolist()}")
    merged = decode_capture_fast(cfg, small, LOCAL_ADDR, max_frames=MAX_FRAMES)
    exact = decode_captures(cfg, small, LOCAL_ADDR, MAX_FRAMES, [small.shape[1]] * 2)
    require(all(torch.equal(p[0], q[0]) for p, q in zip(merged, exact)),
            f"the {tag} fallback row differs from the exact scan")
    require(frame_list(merged, 1) == frame_list(exact, 1),
            f"the {tag} clean row differs from the exact scan")
    require(merged.count.tolist() == want_frames,
            f"{tag} fallback frames {merged.count.tolist()}, expected {want_frames}")
    log(f"phase 3 ({tag}): fallback row ({what}) re-decoded by the exact scan on the card; "
        f"merged batch equals it ({merged.count.tolist()} frames)")


def payloads_in_order(res) -> tuple[list[bytes], list[int], list[int]]:
    """(payloads, sequence numbers, starts) of a one-capture decode's valid
    slots, in slot order."""
    valid = res.valid.cpu().numpy()
    fb, ln = res.frame_bytes.cpu().numpy(), res.length.cpu().numpy()
    seq, start = res.sequence.cpu().numpy(), res.start.cpu().numpy()
    ks = np.nonzero(valid)[0]
    return ([fb[k, 7:7 + int(ln[k])].tobytes() for k in ks], [int(seq[k]) for k in ks],
            [int(start[k]) for k in ks])


def check_path_batch(torch, sd, xcorr_hits, xcorr_hits_plain, cfg, y, max_frames: int,
                     tag: str, vlens=None, local_addr: int = LOCAL_ADDR) -> float:
    """Kernels #1, #3 (or #5 for 4B5B) and #4 on one batch y f32[B, T] that
    a path decodes, against their plain versions: the hit rows as
    check_xcorr holds them, the attempts and the walk (at `max_frames`, the
    path's own) equal, each row at its true length vlens int32[B] where
    given, else T, the walk's keep flags for `local_addr`.  Returns #1's
    max |err|."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync.correlate import preamble_energy

    pre = preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    err, rows, _ = check_xcorr(torch, xcorr_hits, xcorr_hits_plain, y, pre,
                               cfg.correlation_threshold, tag)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, N_CAND)
    if vlens is None:
        vlens = torch.full((y.shape[0],), y.shape[1], dtype=torch.int32, device=y.device)
    attempt, attempt_plain = ((sd.attempt_manchester, sd.attempt_manchester_plain)
                              if cfg.line_coding == "manchester"
                              else (sd.attempt_4b5b, sd.attempt_4b5b_plain))
    got = attempt(y, cand, n_valid, vlens, sync, preamble_energy(sync))
    torch.cuda.synchronize()
    want = attempt_plain(y, cand, n_valid, vlens, sync, preamble_energy(sync))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{attempt.__name__} differs on the {tag}")
    a = sd.spec_phase_a(cfg, y, local_addr, N_CAND, vlens)
    zeros = torch.zeros_like(vlens)
    no_limit = torch.full_like(vlens, 2**30)
    walk = sd.spec_walk(a.fields, zeros, no_limit, max_frames)
    torch.cuda.synchronize()
    walk_p = sd.spec_walk_plain(a.fields, zeros, no_limit, max_frames)
    require(all(torch.equal(g, w) for g, w in zip(walk, walk_p)),
            f"spec_walk differs on the {tag}")
    log(f"phase 1: the {tag} ({y.shape[0]} x {y.shape[1]}): {attempt.__name__} and spec_walk "
        f"(max_frames={max_frames}) == plain ({int(n_valid.sum())} candidates, "
        f"{int(walk.keep.sum())} frames kept)")
    return err


def check_robustness_kernels(torch, sd, xn, channel, timing, equalizer, ber, xcorr_hits,
                             xcorr_hits_plain, cfg, robust_in, dev) -> dict[str, float]:
    """Phase 1 at the shapes of the robustness paths, each batch as its path
    decodes it (check_path_batch): the clock search's resampled batch
    (len(PPM_GRID) x 433,464, equal to the CPU's bit for bit); the timing
    gate's retry batch (16 windows at max_frames=1, the padded slots'
    windows clamped at the capture's end) on both gate captures; each
    sweep's batch; the decision-directed capture, its preamble-trained
    equalization and its first refit FIR's output (the capture's row stats,
    #8, too).  The gate's dense hits are extracted on the card as on the
    CPU, and its drift estimate on the skewed frames' windows lies within
    0.01 ppm of the CPU's.  Returns the max |err| per kernel."""
    import inspect

    from trackmaker_tpu_torch.phy.decoder import decode_capture, decode_capture_fast
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync import auto_xcorr

    (xs, _), (xg, _), (xd, _), (xgg, _) = robust_in
    pre = preamble_waveform(cfg)
    errs = {"xcorr_hits": 0.0, "attempt_manchester": 0, "spec_walk": 0}

    def batch(y, max_frames: int, tag: str) -> None:
        err = check_path_batch(torch, sd, xcorr_hits, xcorr_hits_plain, cfg, y, max_frames, tag)
        errs["xcorr_hits"] = max(errs["xcorr_hits"], err)

    grid = torch.tensor(timing.PPM_GRID, device=dev)[:, None]
    y = channel.clock_offset(xs, -grid)
    require(torch.equal(y.cpu(), channel.clock_offset(xs.cpu(), -grid.cpu())),
            "clock_offset on the card differs from the CPU's")
    batch(y, MAX_FRAMES, "clock search batch")
    for layout, x in (("quiet", xg), ("flagship gaps", xgg)):
        res = decode_capture_fast(cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES)
        _, n_real, retry = timing._retry_batch(cfg, x, res, 16, 8)
        batch(retry, 1, f"timing gate retry batch, {layout} corpus ({n_real} real windows)")
    for sweep, make in (("ber_sweep", ber._ber_batch), ("clock_offset_sweep", ber._clock_batch)):
        kw = {k: p.default for k, p in inspect.signature(getattr(ber, sweep)).parameters.items()
              if k not in ("cfg", "device")}
        if sweep == "clock_offset_sweep":
            kw["ppms"] = SWEEP_PPMS
        _, noisy = make(cfg, device=dev, **kw)
        batch(noisy, kw["n_frames"] + 8, f"{sweep} batch")
    errs["xcorr_rowstats"] = check_rowstats(torch, xn, xcorr_hits, xd[None], pre,
                                            "decode_dd capture")
    batch(xd[None], DD_FRAMES + 8, "decode_dd capture")
    eq, _ = equalizer.equalize_capture(cfg, xd)
    batch(eq[None], DD_FRAMES + 8, "decode_dd preamble-trained equalization")
    boot = equalizer.decode_capture_eq(cfg, xd, LOCAL_ADDR, max_frames=DD_FRAMES + 8)
    stock = decode_capture(cfg, xd, LOCAL_ADDR, DD_FRAMES + 8)
    boot = stock if int(stock.count) > int(boot.count) else boot
    h, lam = equalizer.refit_channel(cfg, xd.cpu().numpy(), boot.to_frames(),
                                     boot.start.cpu().numpy()[boot.valid.cpu().numpy()])
    g = torch.from_numpy(equalizer._mmse_taps_np(h, lam)).to(dev)
    batch(equalizer._apply_fir(xd[None], g[None]), DD_FRAMES + 8, "decode_dd first refit FIR")

    hits = (auto_xcorr(xg, pre) >= cfg.correlation_threshold)[None]
    for n_cand in (16, 128):
        got = sd.extract_candidates(hits, n_cand)
        want = sd.extract_candidates(hits.cpu(), n_cand)
        require(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
                f"extract_candidates on the card differs from the CPU's ({n_cand})")
    starts = torch.nonzero(hits[0]).flatten()
    max_window = cfg.samples_for_bits((7 + cfg.max_frame_bytes) * 8)
    wins = torch.nn.functional.pad(xg, (0, max_window))[
        starts[:, None] + cfg.preamble_len + torch.arange(max_window, device=dev)]
    n_levels = max_window // cfg.samples_per_level
    est, _ = timing.estimate_frame_ppm(cfg, wins, n_levels)
    est_p, _ = timing.estimate_frame_ppm(cfg, wins.cpu(), n_levels)
    ppm_err = (est.cpu() - est_p).abs().max().item()
    require(ppm_err <= 0.01, f"estimate_frame_ppm on the card differs by {ppm_err} ppm")
    log(f"phase 1: the clock search batch equals the CPU's resample bit for bit; "
        f"extract_candidates on the card == the CPU's on the timing gate capture's "
        f"{int(hits.sum())} hits; estimate_frame_ppm on its {len(starts)} hit windows within "
        f"{ppm_err:.3g} ppm of the CPU's")
    return errs


def count_launches(torch, kernels, fn):
    """(fn(), launches of each kernel in `kernels` during it, wall seconds),
    the counts set to 0 just before."""
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kernels}, time.perf_counter() - t0


def run_robustness_paths(torch, timing, equalizer, ber, decode_capture, cfg, kernels,
                         inputs) -> dict[str, dict[str, int]]:
    """Phase 2's robustness paths, each with its gates: the clock search,
    the timing gate, the decision-directed decode and the two sweeps.
    Returns each path's launches of `kernels` (#1, #3, #4, #8)."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync import auto_xcorr

    (xs, frames_s), (xg, frames_g), (xd, pays_d), (xgg, _) = inputs
    need = {"search": ("xcorr_hits", "attempt_manchester", "spec_walk"),
            "timing_gate": ("xcorr_hits", "attempt_manchester", "spec_walk"),
            "timing_gate_gaps": ("xcorr_hits", "attempt_manchester", "spec_walk"),
            "decode_dd": ("xcorr_hits", "attempt_manchester", "spec_walk", "xcorr_rowstats"),
            "sweeps": ("xcorr_hits", "attempt_manchester", "spec_walk")}
    out = {}

    (res, ppm), out["search"], wall = count_launches(torch, kernels, lambda: (
        timing.decode_with_clock_search(cfg, xs, LOCAL_ADDR, max_frames=MAX_FRAMES)))
    pays, seqs, starts = payloads_in_order(res)
    require(abs(ppm - SEARCH_PPM) <= 500, f"the clock search chose {ppm} ppm")
    require(payload_digest(pays) == SEARCH_DIGEST,
            f"clock search payload digest {payload_digest(pays)}, the JAX package's {SEARCH_DIGEST}")
    require(seqs == sorted(set(seqs)) and starts == sorted(starts)
            and all(p == frames_s[q].data for p, q in zip(pays, seqs)),
            "the clock search's frames are out of order or wrong")
    log(f"phase 2 (clock_search): decode_with_clock_search of one {xs.shape[0]}-sample capture "
        f"skewed {SEARCH_PPM:+.0f} ppm took {wall * 1e3:.1f} ms (first call), kernel launches "
        f"{out['search']}; chose {ppm:+.0f} ppm; {len(pays)} of {len(frames_s)} frames in order "
        f"(frames lost: {sorted(set(range(len(frames_s))) - set(seqs))}), payload digest "
        f"{SEARCH_DIGEST} = the JAX package's")

    (exact, rec), out["timing_gate"], wall = count_launches(torch, kernels, lambda: (
        timing.decode_with_timing_gate(cfg, xg, LOCAL_ADDR, max_frames=MAX_FRAMES)))
    got_exact, _, starts_e = payloads_in_order(exact)
    got_rec = payloads_in_order(rec)[0]
    skewed = sorted(frames_g[i].data for i in GATE_SKEWS)
    on_clock = sorted(f.data for i, f in enumerate(frames_g) if i not in GATE_SKEWS)
    require(sorted(got_exact) == on_clock, "the timing gate's exact decode found "
            f"{len(got_exact)} frames, not the {len(on_clock)} on-clock ones")
    require(sorted(got_rec) == skewed, f"the timing gate recovered {len(got_rec)} frames, "
            f"not the {len(skewed)} skewed ones")
    require(sorted(got_exact + got_rec) == sorted(f.data for f in frames_g),
            "exact and recovered do not give every frame once")
    corr = auto_xcorr(xg, preamble_waveform(cfg))
    lens = exact.length[exact.valid].tolist()
    hit_pos = torch.nonzero(corr >= cfg.correlation_threshold).flatten().tolist()
    left = [h for h in hit_pos if not any(
        s <= h < s + cfg.preamble_len + cfg.frame_samples(n) for s, n in zip(starts_e, lens))]
    require(len(left) < 16, f"the timing gate needs {len(left)} retries, its table holds 16")
    log(f"phase 2 (timing_gate): decode_with_timing_gate of one {xg.shape[0]}-sample capture "
        f"took {wall * 1e3:.1f} ms (first call), kernel launches {out['timing_gate']}; exact "
        f"{len(got_exact)} frames (every on-clock one), {len(left)} hits retried, recovered "
        f"{len(got_rec)} (every skewed one: {sorted(GATE_SKEWS.values())} ppm; each followed "
        f"by {GATE_QUIET} samples of quiet)")

    (exact, rec), out["timing_gate_gaps"], wall = count_launches(torch, kernels, lambda: (
        timing.decode_with_timing_gate(cfg, xgg, LOCAL_ADDR, max_frames=MAX_FRAMES)))
    exact_c, rec_c = timing.decode_with_timing_gate(cfg, xgg.cpu(), LOCAL_ADDR,
                                                    max_frames=MAX_FRAMES)
    require(frame_list(exact) == frame_list(exact_c) and frame_list(rec) == frame_list(rec_c),
            "the timing gate on the flagship-gap capture differs from the port's CPU run")
    log(f"phase 2 (timing_gate, flagship gaps): decode_with_timing_gate of the same frames "
        f"with {GAP}-sample gaps after the skewed ones too ({xgg.shape[0]} samples) took "
        f"{wall * 1e3:.1f} ms (first call), kernel launches {out['timing_gate_gaps']}; exact "
        f"{len(frame_list(exact))} frames, recovered {len(frame_list(rec))} (a retry window "
        f"spans the next frame), frames and starts equal to the port's CPU run (which "
        f"tests/test_torch_channel_timing.py holds to the JAX package's)")

    res, out["decode_dd"], wall = count_launches(torch, kernels, lambda: (
        equalizer.decode_capture_dd(cfg, xd, LOCAL_ADDR, max_frames=DD_FRAMES + 8)))
    pays = payloads_in_order(res)[0]
    stock = payloads_in_order(decode_capture(cfg, xd, LOCAL_ADDR, DD_FRAMES + 8))[0]
    require(payload_digest(pays) == DD_DIGEST,
            f"decode_capture_dd payload digest {payload_digest(pays)}, the JAX package's {DD_DIGEST}")
    require(set(stock) < set(pays) and set(pays) <= set(pays_d),
            "decode_capture_dd's payloads are not a strict superset of the stock decode's")
    log(f"phase 2 (decode_dd): decode_capture_dd of one {xd.shape[0]}-sample mid-burst capture "
        f"took {wall * 1e3:.1f} ms (first call), kernel launches {out['decode_dd']}; "
        f"{len(pays)} of {DD_FRAMES} frames (the stock exact scan {len(stock)}), payload digest "
        f"{DD_DIGEST} = the JAX package's")

    (rows_b, rows_c), out["sweeps"], wall = count_launches(torch, kernels, lambda: (
        ber.ber_sweep(cfg), ber.clock_offset_sweep(cfg, ppms=SWEEP_PPMS)))
    require(rows_b[-1]["frame_loss_pct"] == 0.0, f"ber_sweep loses frames at the top SNR: {rows_b[-1]}")
    require(rows_c[0]["frame_loss_pct"] == 0.0, f"clock_offset_sweep loses frames at 0 ppm: {rows_c[0]}")
    require(rows_c[-1]["clock_ppm"] == 20000 and rows_c[-1]["frame_loss_pct"] > 50.0,
            f"clock_offset_sweep at 20,000 ppm: {rows_c[-1]}")
    log(f"phase 2 (sweeps): ber_sweep and clock_offset_sweep took {wall * 1e3:.1f} ms (first "
        f"call), kernel launches {out['sweeps']}; frame loss % by SNR "
        + ", ".join(f"{r['snr_db']:g} dB {r['frame_loss_pct']:g}" for r in rows_b)
        + "; by clock offset " + ", ".join(f"{r['clock_ppm']:g} ppm {r['frame_loss_pct']:g}"
                                           for r in rows_c))
    for path, names in need.items():
        for k_name in names:
            require(out[path][k_name] > 0, f"the {path} path never launched {k_name}")
    return out


# --- the streaming receive path and the MAC ----------------------------------------


class Recorder:
    """While open, wraps the method `name` of class `cls` to keep
    keep(obj, *args) of each call in `kept`: what a path decoded, for
    phase 1, with no hook in the package and no second run."""

    def __init__(self, cls, name: str, keep):
        self.cls, self.name, self.keep = cls, name, keep
        self.kept = []

    def __enter__(self):
        self.orig = orig = getattr(self.cls, self.name)
        kept, keep = self.kept, self.keep

        def method(obj, *args):
            kept.append(keep(obj, *args))
            return orig(obj, *args)

        setattr(self.cls, self.name, method)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def check_recorded(torch, sd, xcorr_hits, xcorr_hits_plain, cfg, inputs, tag: str) -> float:
    """check_path_batch on every recorded buffer [(f32[bucket] on the card,
    true length, local address, max_frames)]: stacked by bucket, address
    and max_frames in batches of at most CHECK_ROWS, and the longest buffer
    once more alone, as the path launches it (B = 1).  Returns #1's max
    |err|."""
    groups = {}
    for padded, n, addr, max_frames in inputs:
        groups.setdefault((padded.shape[0], addr, max_frames), []).append((padded, n))
    longest = max(inputs, key=lambda rec: rec[1])
    batches = [((longest[0].shape[0], longest[2], longest[3]), [longest[:2]],
                "the longest buffer alone")]
    for key, group in sorted(groups.items()):
        for i in range(0, len(group), CHECK_ROWS):
            part = group[i:i + CHECK_ROWS]
            batches.append((key, part, f"buffers {i + 1}-{i + len(part)} of {len(group)}"))
    err = 0.0
    for (b, addr, max_frames), group, part in batches:
        y = torch.stack([p for p, _ in group])
        vlens = torch.tensor([n for _, n in group], dtype=torch.int32, device=y.device)
        err = max(err, check_path_batch(
            torch, sd, xcorr_hits, xcorr_hits_plain, cfg, y, max_frames,
            f"{tag}: {part} in buckets of {b} samples at address {addr}", vlens=vlens,
            local_addr=addr))
    log(f"phase 1: the {tag}: {len(inputs)} buffers, each held against plain")
    return err


class DecodeTally:
    """While open, wraps the stream PHY class's process_samples (PhyDecoder,
    or OfdmStreamPhy and so its v2) to add up the decodes its calls make
    (the PHY's own decode_calls and exact_calls, which OFDM has not) and
    the wall time of the calls that decoded."""

    def __init__(self, phy_decoder):
        self.cls = phy_decoder
        self.calls = self.exact = 0
        self.seconds = 0.0

    def __enter__(self):
        self.orig = orig = self.cls.process_samples
        tally = self

        def process_samples(dec, samples):
            calls, exact = dec.decode_calls, getattr(dec, "exact_calls", 0)
            t0 = time.perf_counter()
            out = orig(dec, samples)
            if dec.decode_calls > calls:
                tally.seconds += time.perf_counter() - t0
            tally.calls += dec.decode_calls - calls
            tally.exact += getattr(dec, "exact_calls", 0) - exact
            return out

        self.cls.process_samples = process_samples
        return self

    def __exit__(self, *exc):
        self.cls.process_samples = self.orig

    def describe(self, opts: dict) -> str:
        if opts.get("phy") == "coded_manchester":
            return f"{self.calls} stream calls that correlated a bucket"
        if "phy" in opts:
            return f"{self.calls} stream calls that decoded a bucket"
        return f"{self.calls} decode calls ({self.exact} by the exact scan)"

    def figures(self, airtime_s: float, wall_s: float) -> dict:
        return {"airtime_s": airtime_s, "wall_s": wall_s, "calls": self.calls,
                "exact": self.exact, "ms_per_call": self.seconds * 1e3 / self.calls}


def recorded_run(torch, phy_decoder, kernels, run, stream=None):
    """(run(), its launches of `kernels`, its DecodeTally, the buffers its
    PhyDecoders decoded [(f32[bucket] on the card, true length, local
    address, max_frames)], wall seconds), the counts set to 0 just before.
    With `stream` (a stream PHY class of the port and the method that takes
    a padded bucket: OfdmStreamPhy's _starts, the coded PHYs' _correlate)
    the run's stream PHYs are that class: the tally counts theirs and the
    buffers are the buckets they decoded [f32[bucket] on the card]."""
    if stream is None:
        cls, method = phy_decoder, "_decode_with_cursor"

        def keep(dec, padded, n):
            return padded, n, dec.local_addr, dec.max_frames
    else:
        cls, method = stream

        def keep(phy, padded):
            return padded
    with DecodeTally(cls) as tally, Recorder(cls, method, keep) as rec:
        out, launches, wall = count_launches(torch, kernels, run)
    return out, launches, tally, rec.kept, wall


def path_kernels(opts: dict) -> tuple[str, ...]:
    """The kernels a MAC or network run's stream PHY launches: the
    normalized correlation on OFDM v2, PSK and FSK, and with the Viterbi
    decoder on adaptive OFDM, #1 and the Viterbi decoder on the coded PHY,
    else #1, the attempt of its line code and #4."""
    if opts.get("phy") in ("ofdm_v2", "psk", "fsk"):
        return ("normalized_xcorr_dense",)
    if opts.get("phy") == "ofdm_adaptive":
        return ("normalized_xcorr_dense", "viterbi_decode")
    if opts.get("phy") == "coded_manchester":
        return ("xcorr_hits", "viterbi_decode")
    attempt = "attempt_4b5b" if opts.get("line_coding") == "4b5b" else "attempt_manchester"
    return ("xcorr_hits", attempt, "spec_walk")


def time_stream_paths(torch, sd, phy_decoder, lstream, cfg, cfg4, mac_in, segments, card,
                      dev) -> None:
    """Phase 4 on the streaming receive path: a PhyDecoder decode of the
    clean CSMA run's longest recorded buffer (with the card's busy share of
    it, and its decode_capture_spec alone), of a 4B5B buffer that falls to
    the exact scan (a frame cut by the buffer's end reads the zero padding;
    median of 5), and the latency pass's longest segment's pack and
    readback."""
    padded, n, addr, max_frames = max(mac_in["csma_transfer"], key=lambda rec: rec[1])
    dec = phy_decoder(cfg, addr, max_frames, device=dev)
    dec_ms = time_ms(torch, lambda: dec._decode_with_cursor(padded, n))
    busy = busy_share(torch, lambda: dec._decode_with_cursor(padded, n))
    spec_ms = time_ms(torch, lambda: sd.decode_capture_spec(
        cfg, padded[None], addr, max_frames=max_frames, valid_len=n, with_cursor=True))
    log(f"phase 4: PhyDecoder decode of a {n}-sample buffer in a bucket of {padded.shape[0]} "
        f"(the clean CSMA run's longest): {dec_ms:.4f} ms, the card busy "
        + ("not measured" if busy is None else f"{busy:.3f}")
        + f" of it; its decode_capture_spec alone (no readback) {spec_ms:.4f} ms [{card}]")
    dec4 = phy_decoder(cfg4, LOCAL_ADDR, 8, device=dev)
    for padded4, n4, addr4, max_frames4 in mac_in["csma_transfer, 4b5b"]:
        dec4.local_addr, dec4.max_frames = addr4, max_frames4
        exact = dec4.exact_calls
        dec4._decode_with_cursor(padded4, n4)
        if dec4.exact_calls > exact:
            dec_ms = time_ms(torch, lambda: dec4._decode_with_cursor(padded4, n4), runs=5)
            log(f"phase 4: PhyDecoder decode of a {n4}-sample 4B5B buffer that falls to the "
                f"exact scan: {dec_ms:.4f} ms (median of 5) [{card}]")
            break
    seg = max((seg for seg, _ in segments), key=len)
    xn, n = torch.from_numpy(lstream.padded_segment(seg)).to(dev), len(seg)
    seg_ms = time_ms(torch, lambda: lstream.packed_decode(cfg, xn, LOCAL_ADDR, 32).cpu())
    log(f"phase 4: streaming segment of {n} samples in a bucket of {xn.shape[0] - 1}, "
        f"packed_decode and its readback: {seg_ms:.4f} ms [{card}]")


def run_stream_latency(torch, pipeline_cls, cfg, stream_in, kernels,
                       dev) -> tuple[dict, dict, list]:
    """Phase 2 (stream_latency), bench.py's latency row: the capture pushed in
    25 ms chunks through a StreamingDecodePipeline on the card, a warm pass
    that records each segment it decodes, then the timed pass in a new
    one; a frame's latency is (emit chunk - arrival chunk) x 25 ms + the
    emitting push's wall time.  Every frame must come out of a push, none
    of the flush, with its payload.  Returns (the timed pass's launches of
    `kernels`, figures, the warm pass's segments [(samples, max_frames)])."""
    payloads, arrival, wave = stream_in
    with Recorder(pipeline_cls, "_decode_segment",
                  lambda pipe, seg: (seg.copy(), pipe.max_frames)) as rec:
        warm = pipeline_cls(cfg, LOCAL_ADDR, device=dev)
        for i in range(0, len(wave), STREAM_CHUNK):
            warm.push(wave[i:i + STREAM_CHUNK])
        warm.flush()
    pipe = pipeline_cls(cfg, LOCAL_ADDR, device=dev)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    lat, got, decode_s = [], [], 0.0
    t_run = time.perf_counter()
    for ci, i in enumerate(range(0, len(wave), STREAM_CHUNK)):
        segments = pipe.segments_decoded
        t0 = time.perf_counter()
        frames = pipe.push(wave[i:i + STREAM_CHUNK])
        dt = time.perf_counter() - t0
        if pipe.segments_decoded > segments:
            decode_s += dt
        for f in frames:
            got.append(f)
            lat.append((ci - arrival[f.sequence]) * 25.0 + dt * 1e3)
    flushed = pipe.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = {k.__name__: k.launches for k in kernels}
    require(not flushed and [f.data for f in got] == payloads,
            f"stream_latency gate: {len(got)} of {STREAM_FRAMES} frames before the flush, "
            f"{len(flushed)} from it")
    for k_name, n in launches.items():
        require(n > 0, f"the stream_latency path never launched {k_name}")
    lat.sort()
    fig = {"p50": lat[len(lat) // 2], "p99": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
           "segments": pipe.segments_decoded, "shipped": pipe.samples_shipped,
           "ms_per_segment": decode_s * 1e3 / pipe.segments_decoded}
    log(f"phase 2 (stream_latency): {len(wave)} samples ({STREAM_SECONDS} s, {STREAM_FRAMES} "
        f"frames of {STREAM_PAYLOAD} B, noise sigma {STREAM_NOISE}) pushed in {STREAM_CHUNK}-"
        f"sample chunks took {wall * 1e3:.1f} ms; latency p50 {fig['p50']:.3f} ms, p99 "
        f"{fig['p99']:.3f} ms; {fig['segments']} segments, {fig['shipped']} of "
        f"{pipe.samples_seen} samples shipped, {fig['ms_per_segment']:.3f} ms a decoding "
        f"push; kernel launches {launches}; {STREAM_FRAMES} of {STREAM_FRAMES} frames "
        "before the flush, payloads equal")
    return launches, fig, rec.kept


def run_mac_paths(torch, phy_decoder, link, phy_config, mac_config, kernels, streams,
                  dev) -> tuple[dict, dict, dict]:
    """Phase 2's MAC runs (MAC_RUNS) through the port's transfer entry points
    on the card, each with the launch counts set to 0 just before it: the
    data must arrive and the stats equal MAC_EXPECT, the JAX package's.
    Returns (each run's launches of `kernels`, its figures, the buffers its
    PhyDecoders decoded [(f32[bucket] on the card, true length, local
    address, max_frames)], or, for a run over a stream PHY of `streams`
    (name -> recorded_run's `stream`), the buckets its stream PHYs
    decoded)."""
    launches, figs, inputs = {}, {}, {}
    for name, (arq, n_bytes, opts) in MAC_RUNS.items():
        (data, received, stats), launches[name], tally, inputs[name], wall = recorded_run(
            torch, phy_decoder, kernels,
            partial(mac_run, name, link, phy_config, mac_config, device=dev),
            streams.get(opts.get("phy")))
        require(received == data, f"{name}: {len(received)} of {len(data)} bytes arrived intact")
        require(stats == MAC_EXPECT[name],
                f"{name} stats {stats}, the JAX package's {MAC_EXPECT[name]}")
        for k_name in path_kernels(opts):
            require(launches[name][k_name] > 0, f"the {name} path never launched {k_name}")
        figs[name] = tally.figures(stats["airtime_s"], wall)
        log(f"phase 2 ({name}): {arq} transfer of {n_bytes} B took {wall * 1e3:.1f} ms of wall "
            f"time for {stats['airtime_s']:.4f} s of airtime (airtime / wall "
            f"{stats['airtime_s'] / wall:.3f}); {tally.describe(opts)}, "
            f"{figs[name]['ms_per_call']:.3f} ms a call; kernel launches "
            f"{launches[name]}; the data arrived and the stats equal MAC_EXPECT, the JAX "
            f"package's: {stats}")
    return launches, figs, inputs


def run_ping_paths(torch, phy_decoder, mods, kernels, streams,
                   dev) -> tuple[dict, dict, dict]:
    """Phase 2's network runs (PING_RUNS) through the port's entry points
    on the card (`mods`: its net_modules), each with the launch counts set
    to 0 just before it: each result must equal PING_EXPECT, the JAX
    package's, every ping come back, the router's reply carry the WiFi
    host's address, ICMP type 0, the payload and a TTL under 64, and each
    run end within WALL_LIMIT_S of wall time.  Returns (each run's launches
    of `kernels`, its figures, the buffers its PhyDecoders decoded
    [(f32[bucket] on the card, true length, local address, max_frames)], or,
    for an OFDM run, the buckets its stream PHYs decoded)."""
    launches, figs, inputs = {}, {}, {}
    for name, opts in PING_RUNS.items():
        run = (partial(router_run, mods, device=dev) if name == "router"
               else partial(ping_run, name, mods, device=dev))
        got, launches[name], tally, inputs[name], wall = recorded_run(
            torch, phy_decoder, kernels, run, streams.get(opts.get("phy")))
        require(got == PING_EXPECT[name], f"{name}: {got}, the JAX package's {PING_EXPECT[name]}")
        if name == "router":
            require(got["src"] == "192.168.2.2" and got["dst"] == "192.168.1.2"
                    and got["icmp_type"] == 0 and got["payload"] == ROUTER_PAYLOAD
                    and got["ttl"] < 64 and got["pings_seen"] == 1,
                    f"the router run's reply is wrong: {got}")
            what = (f"the echo crossed the router to the WiFi host and its reply came back over "
                    f"sound: {got['src']} -> {got['dst']}, ICMP type {got['icmp_type']}, TTL "
                    f"{got['ttl']}, payload {got['payload']!r}; router forwarded "
                    f"{got['forwarded']}, dropped {got['dropped']}")
        else:
            require(got["received"] == got["sent"] == got["responded"] == opts["count"],
                    f"{name}: {got['received']} of {got['sent']} pings came back")
            what = (f"{got['received']} of {got['sent']} pings back, RTT min / avg / max "
                    f"{got['rtt_min_ms']:.3f} / {got['rtt_avg_ms']:.3f} / "
                    f"{got['rtt_max_ms']:.3f} ms")
        require(wall < WALL_LIMIT_S, f"{name} took {wall:.1f} s of wall time: the reassembler "
                f"drops a partial packet after {WALL_LIMIT_S:.0f} s")
        for k_name in path_kernels(opts):
            require(launches[name][k_name] > 0, f"the {name} path never launched {k_name}")
        figs[name] = tally.figures(got["airtime_s"], wall)
        log(f"phase 2 ({name}): {got['airtime_s']:.4f} s of airtime took {wall * 1e3:.1f} ms of "
            f"wall time (airtime / wall {got['airtime_s'] / wall:.3f}, under "
            f"{WALL_LIMIT_S:.0f} s); {tally.describe(opts)}, "
            f"{figs[name]['ms_per_call']:.3f} ms a call; kernel launches "
            f"{launches[name]}; {what}; the result equals PING_EXPECT, the JAX package's")
    return launches, figs, inputs


# --- the OFDM modems -----------------------------------------------------------------


def ofdm_chirp():
    """(the OFDM preamble, the chirp f32[440], and its norm summed in f32:
    the `pe` find_preambles passes the normalized correlation)."""
    from trackmaker_tpu_torch.phy import ofdm
    from trackmaker_tpu_torch.sync.correlate import pattern_norm

    chirp = ofdm.chirp(ofdm.OfdmConfig())
    return chirp, pattern_norm(chirp)


def check_ofdm_corr(torch, xn, ofdm, inputs, tag: str) -> float:
    """Phase 1 on the OFDM path: #2's normalized form at L=440 with the
    chirp's f32 norm, as find_preambles calls it, against its plain version
    on each batch of `inputs` [(captures f32[B, T] on the card,
    max_frames)], within CORR_ATOL, and the starts sync.walk_starts takes from
    the kernel's corr equal to those from the plain corr, -1 padding
    included.  Returns the max |err|."""
    from trackmaker_tpu_torch.sync import walk_starts

    cfg = ofdm.OfdmConfig()
    chirp, pe = ofdm_chirp()
    err, n_starts = 0.0, 0
    for x, max_frames in inputs:
        got = xn.normalized_xcorr_dense(x, chirp, pe)
        torch.cuda.synchronize()
        want = xn.normalized_xcorr_dense_plain(x, chirp, pe)
        e = (got - want).abs().max().item()
        require(e <= CORR_ATOL, f"normalized_xcorr on the {tag}: max |err| {e}")
        err = max(err, e)
        starts = walk_starts(got, cfg.sync_threshold, max_frames, cfg.preamble_len,
                             cfg.preamble_len)
        require(torch.equal(starts, walk_starts(want, cfg.sync_threshold, max_frames,
                                                cfg.preamble_len, cfg.preamble_len)),
                f"the {tag}: the starts from the kernel's corr differ from the plain corr's")
        n_starts += int((starts >= 0).sum())
    shapes = sorted({tuple(x.shape) for x, _ in inputs})
    log(f"phase 1: normalized_xcorr == plain at L={len(chirp)} with the chirp's f32 norm on the "
        f"{tag} ({len(inputs)} batches, shapes {shapes}; max |err| {err:.3g}); the "
        f"{n_starts} preamble starts found from the kernel's corr equal the plain corr's")
    return err


def bucket_batches(torch, buckets) -> list:
    """The OFDM runs' recorded buckets as phase-1 batches [(f32[n, bucket],
    16)]: stacked by length, CHECK_ROWS at most, and the largest alone
    (B = 1, as the stream PHY launches it)."""
    groups = {}
    for bkt in buckets:
        groups.setdefault(bkt.shape[0], []).append(bkt)
    largest = max(groups)
    batches = [(groups[largest][-1][None], 16)]
    for n in sorted(groups):
        for i in range(0, len(groups[n]), CHECK_ROWS):
            batches.append((torch.stack(groups[n][i:i + CHECK_ROWS]), 16))
    return batches


def ofdm_margin(torch, sym) -> float:
    """min(|Re|, |Im|) of the de-rotated data symbols over their RMS: how far
    the closest QPSK decision lies from its boundary."""
    rms = sym.abs().pow(2).mean().sqrt()
    return (torch.minimum(sym.real.abs(), sym.imag.abs()).min() / rms).item()


def run_ofdm_paths(torch, xn, ofdm, ofdm_v2, frames, x2, x1, dev) -> dict[str, int]:
    """Phase 2 on the OFDM modems, each step with #2's count set to 0 just
    before it and read just after: ofdm_v2_b32 through the batched
    find_preambles and demodulate_at_v2 (#2 launched once; every start
    found, every payload, the decisions' digest equal to OFDM_DIGEST, the
    JAX package's, and each decision at least 1e-3 of the symbols' RMS
    from its boundary), OfdmModemV2.decode of capture 0 (bench.py's gate),
    the same frames through v1 (find_preambles and demodulate_at batched,
    OfdmModem.decode of capture 0; every payload), and 8 of them through
    OfdmModem with Hamming(7,4) and the interleaver, clean.  Returns each
    step's launches of #2."""
    cfg2, cfg1 = ofdm_v2.OfdmV2Config(), ofdm.OfdmConfig()
    n_bits = (7 + OFDM_PAYLOAD) * 8
    payloads = [f.data for f in frames]
    b, t = x2.shape
    k = xn.normalized_xcorr_dense
    launches = {}

    def gate(bits, starts, what: str) -> None:
        require(bool((starts >= 0).all()), f"{what}: a preamble was not found")
        for r in range(bits.shape[0]):
            for i, row in enumerate(bits[r]):
                f = ofdm.Frame.from_bits(row)
                require(f is not None and f.data == payloads[i],
                        f"{what} payload gate failed at capture {r} frame {i}")

    def batch():
        starts = ofdm.find_preambles(cfg2, x2, OFDM_FRAMES)
        return starts, ofdm_v2.demodulate_at_v2(cfg2, x2, n_bits, starts)

    (starts, bits), got, wall = count_launches(torch, (k,), batch)
    launches["ofdm_v2_b32"] = got[k.__name__]
    require(launches["ofdm_v2_b32"] == 1,
            f"ofdm_v2_b32 launched normalized_xcorr {launches['ofdm_v2_b32']} times")
    st, bt = starts.cpu().numpy(), bits.cpu().numpy()
    gate(bt, st, "ofdm_v2_b32")
    dg = ofdm_digest(st, bt)
    require(dg == OFDM_DIGEST, f"ofdm_v2_b32 decisions digest {dg}, the JAX package's "
            f"{OFDM_DIGEST}")
    margin = ofdm_margin(torch, ofdm_v2.symbols_v2(cfg2, x2, cfg2.n_symbols(n_bits), starts))
    require(margin >= 1e-3, f"an ofdm_v2_b32 decision lies {margin:.3g} of the RMS from its "
            "boundary")
    log(f"phase 2 (ofdm_v2_b32): find_preambles + demodulate_at_v2 of {b} x {t} took "
        f"{wall * 1e3:.1f} ms (first call), normalized_xcorr launched once; payload gate "
        f"passed ({b} captures x {OFDM_FRAMES} frames of {OFDM_PAYLOAD} B); decisions digest "
        f"{dg} = the JAX package's; the closest decision {margin:.4f} of the symbols' RMS "
        "from its boundary")
    x0 = x2[0].cpu().numpy()
    got_f, got, _ = count_launches(torch, (k,), lambda: ofdm_v2.OfdmModemV2(device=dev).decode(
        x0, 7 + OFDM_PAYLOAD, max_frames=OFDM_FRAMES))
    launches["OfdmModemV2.decode"] = got[k.__name__]
    require([f.data for f in got_f] == payloads, f"OfdmModemV2.decode of capture 0 gave "
            f"{len(got_f)} of {OFDM_FRAMES} frames")

    def batch1():
        starts = ofdm.find_preambles(cfg1, x1, OFDM_FRAMES)
        return starts, ofdm.demodulate_at(cfg1, x1, n_bits, starts)

    (starts1, bits1), got, wall1 = count_launches(torch, (k,), batch1)
    launches["ofdm_v1_b32"] = got[k.__name__]
    gate(bits1.cpu().numpy(), starts1.cpu().numpy(), "ofdm_v1_b32")
    x10 = x1[0].cpu().numpy()
    got_f, got, _ = count_launches(torch, (k,), lambda: ofdm.OfdmModem(device=dev).decode(
        x10, 7 + OFDM_PAYLOAD, max_frames=OFDM_FRAMES))
    launches["OfdmModem.decode"] = got[k.__name__]
    require([f.data for f in got_f] == payloads, f"OfdmModem.decode of capture 0 gave "
            f"{len(got_f)} of {OFDM_FRAMES} frames")
    ham = ofdm.OfdmModem(fec="hamming", device=dev)
    wave = ham.encode_frames(frames[:8], gap_samples=OFDM_GAP)
    got_f, got, _ = count_launches(torch, (k,), lambda: ham.decode(wave, 7 + OFDM_PAYLOAD, 8))
    launches["OfdmModem(fec='hamming').decode"] = got[k.__name__]
    require([f.data for f in got_f] == payloads[:8], "OfdmModem(fec='hamming') lost frames")
    for what, n in launches.items():
        require(n > 0, f"{what} never launched normalized_xcorr")
    log(f"phase 2 (ofdm_v2_b32): OfdmModemV2.decode of capture 0 gives its {OFDM_FRAMES} "
        f"payloads; v1: find_preambles + demodulate_at of {x1.shape[0]} x {x1.shape[1]} took "
        f"{wall1 * 1e3:.1f} ms (first call), payload gate passed, OfdmModem.decode of capture 0 "
        f"gives its {OFDM_FRAMES} payloads, OfdmModem(fec='hamming') 8 clean frames; launches of "
        f"normalized_xcorr {launches}")
    return launches


def time_ofdm_paths(torch, ofdm, ofdm_v2, x2, buckets, card, dev) -> None:
    """Phase 4 on the OFDM path: the ofdm_v2_b32 decode end to end (median
    of RUNS, and its real-time multiple), its steps (sync's correlation and
    walk, the SC refine, the windows and FFTs, equalization and tracking),
    its peak memory and busy share, and one OfdmStreamPhyV2.process_samples
    call on the largest bucket the OFDM runs decoded."""
    from trackmaker_tpu_torch.sync import walk_starts

    cfg2 = ofdm_v2.OfdmV2Config()
    n_bits = (7 + OFDM_PAYLOAD) * 8
    n_sym = cfg2.n_symbols(n_bits)
    b, t = x2.shape

    def decode():
        return ofdm_v2.demodulate_at_v2(cfg2, x2, n_bits,
                                        ofdm.find_preambles(cfg2, x2, OFDM_FRAMES))

    e2e = time_ms(torch, decode)
    log(f"phase 4: ofdm_v2_b32 find_preambles + demodulate_at_v2 {b} x {t}: {e2e:.4f} ms, "
        f"{b * t / cfg2.sample_rate / (e2e / 1e3):.1f}x real time [{card}]")
    corr = ofdm.preamble_corr(cfg2, x2)
    starts = walk_starts(corr, cfg2.sync_threshold, OFDM_FRAMES, cfg2.preamble_len,
                         cfg2.preamble_len)
    fine = ofdm_v2._sc_refine(cfg2, x2, starts)
    spec = ofdm._windows_spectrum(cfg2, x2, fine, n_sym)
    steps = {
        "sync: the chirp correlation (#2)": lambda: ofdm.preamble_corr(cfg2, x2),
        f"sync: the walk ({OFDM_FRAMES} steps)": lambda: walk_starts(
            corr, cfg2.sync_threshold, OFDM_FRAMES, cfg2.preamble_len, cfg2.preamble_len),
        "SC refine": lambda: ofdm_v2._sc_refine(cfg2, x2, starts),
        "windows + FFT": lambda: ofdm._windows_spectrum(cfg2, x2, fine, n_sym),
        "equalize and track + decisions": lambda: ofdm._qpsk_to_bits(
            ofdm_v2.equalize_track(cfg2, spec).reshape(b, OFDM_FRAMES, -1)),
    }
    for step, fn in steps.items():
        log(f"phase 4: ofdm_v2_b32 step {step}: {time_ms(torch, fn):.4f} ms [{card}]")
    busy = busy_share(torch, decode)
    log(f"phase 4: ofdm_v2_b32 peak device memory {peak_memory(torch, decode)}, device busy "
        + ("not measured" if busy is None else f"{busy:.3f}") + f" of a call [{card}]")
    bucket = max(buckets, key=lambda bkt: bkt.shape[0]).cpu().numpy()
    phy = ofdm_v2.OfdmStreamPhyV2(local_addr=2, device=dev)

    def stream_call():
        phy.reset()
        return phy.process_samples(bucket)

    got = stream_call()
    call_ms = time_ms(torch, stream_call)
    log(f"phase 4: OfdmStreamPhyV2.process_samples of a {len(bucket)}-sample bucket (the OFDM "
        f"runs' largest; {len(got)} frames): {call_ms:.4f} ms [{card}]")


# --- the Viterbi-coded PHYs ----------------------------------------------------------


def coded_starts(phy, x, n_frames: int, payload_len: int):
    """The batched decode's frame starts int32[B, n_frames] in captures x."""
    from trackmaker_tpu_torch.sync import find_pattern_starts

    return find_pattern_starts(x, phy.pre, phy.cfg.correlation_threshold, n_frames,
                               min_sep=phy.frame_samples(payload_len))


def coded_blocks(torch, phy, x, starts, payload_len: int):
    """(header rows, payload rows): the Viterbi decoder's inputs in the
    batched decode of captures x f32[B, T] for the frames at starts int32[B,
    F], f32[B·F, 124] and f32[B·F, 2·(8·payload_len + 6)]."""
    return [b.reshape(-1, b.shape[-1]) for b in phy.soft_blocks(x, starts, payload_len)]


def check_viterbi(torch, convcode, phy, x, dev, extra=()) -> float:
    """Phase 1 for the Viterbi decoder (csrc/viterbi.cu): the kernel against
    its plain version bit for bit on coded_manchester_b8's real header and
    payload blocks (256 rows of 62 and of 518 trellis steps), on the soft
    blocks of `extra` [(name, rows f32[N, 2·(n_bits + 6)], n_bits)] (the
    adaptive OFDM batches' headers and payloads, 128 rows of 62 and of 518
    steps each), and on
    tests/test_torch_convcode.py's corpora (soft rows clean, noisy and very
    noisy and hard rows clean, flipped and random at every n_steps mod 4,
    soft values on a 1/8 grid with a row of all zeros, depunctured rate-3/4
    blocks, one row, 256 rows, ties between the halves of the kernel's
    first-maximum tree, and the long rows: one of 62 steps, one of 2,054 (a
    263-byte frame's payload), two through the staging ring (6,145 steps),
    one at the shared memory's edge (12,448: the longest whose choices fit)
    and two whose choices exceed it (16,006)).  Returns the max |bit
    difference|."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_convcode as corpora

    hdr, pay = coded_blocks(torch, phy, x, coded_starts(phy, x, CODED_FRAMES, CODED_PAYLOAD),
                            CODED_PAYLOAD)
    cases = [("coded_manchester_b8 headers", hdr, phy.HDR_BITS, True),
             ("coded_manchester_b8 payloads", pay, 8 * CODED_PAYLOAD, True)]
    cases += [(name, rows, n_bits, True) for name, rows, n_bits in extra]
    cases += [(name, torch.from_numpy(r).to(dev), n, soft)
              for name, r, n, soft in corpora.viterbi_corpora(big=256, long=True)]
    require(convcode.choices_fit(12448) and not convcode.choices_fit(12449),
            "the long corpora's edge row no longer sits at the shared-memory budget's edge")
    tails = set()
    for name, r, n_bits, soft in cases:
        got = convcode.viterbi_decode(r, n_bits, soft)
        torch.cuda.synchronize()
        require(torch.equal(got, convcode.viterbi_decode_plain(r, n_bits, soft)),
                f"viterbi differs from its plain version on the {name} corpus")
        tails.add((n_bits + 6) % 4)
    require(tails == {0, 1, 2, 3}, f"the Viterbi corpora miss a tail: {sorted(tails)}")
    log(f"phase 1: viterbi == plain bit for bit on {len(cases)} corpora: the "
        f"coded_manchester_b8 headers and payloads ({hdr.shape[0]} rows of {hdr.shape[1]} and "
        f"{pay.shape[1]}), "
        + "".join(f"the {name} ({rows.shape[0]} rows of {rows.shape[1]}), "
                  for name, rows, _ in extra)
        + "hard and soft rows at every n_steps mod 4, a 1/8-grid ties corpus with "
        "an all-zero row, depunctured rate-3/4 blocks, one row, 256 rows, ties between the "
        "tree's halves, one row of 62 and of 2,054 steps, two rows through the staging ring "
        "(6,145), one at the shared memory's edge (12,448) and two with their choices in device "
        "memory (16,006)")
    return 0.0


def check_coded_corr(torch, xcorr_hits_plain, pre, buckets, tag: str) -> float:
    """Phase 1 on the coded stream PHY's correlation: kernel #1's dense corr
    (auto_xcorr, as _correlate calls it) on every recorded bucket of `tag`
    (stacked by length, the largest alone) against its plain version within
    CORR_ATOL, the hits at the threshold equal away from it, and the starts
    sync.walk_starts takes from both equal.  Returns the max |err|."""
    from trackmaker_tpu_torch.sync import auto_xcorr, walk_starts

    thr = MAC_RUNS["csma_transfer, coded_manchester"][2]["correlation_threshold"]
    err = 0.0
    for x, max_frames in bucket_batches(torch, buckets):
        got = auto_xcorr(x, pre)
        torch.cuda.synchronize()
        want, _ = xcorr_hits_plain(x, pre, float("inf"), emit_corr=True)
        e = (got - want).abs().max().item()
        require(e <= CORR_ATOL, f"the {tag}: auto_xcorr differs from plain by {e}")
        err = max(err, e)
        near = (want - thr).abs() < CORR_ATOL
        require(bool((((got >= thr) == (want >= thr)) | near).all()),
                f"the {tag}: hits differ away from the threshold")
        require(torch.equal(walk_starts(got, thr, max_frames, len(pre), len(pre)),
                            walk_starts(want, thr, max_frames, len(pre), len(pre))),
                f"the {tag}: the starts from the kernel's corr differ from the plain corr's")
    log(f"phase 1: xcorr_hits (dense) == plain at L={len(pre)} on the {len(buckets)} {tag} "
        f"(max |err| {err:.3g}); hits and starts at threshold {thr} equal")
    return err


def run_coded_paths(torch, coded, convcode, ofdm, xn, ber, xcorr_hits, spec_kernels, x_c, frames_c,
                    x4, frames4, frames_o, dev) -> dict[str, int]:
    """Phase 2 on the coded PHYs, each run with its kernels' counts set to 0
    just before it: coded_manchester_b8 through decode_equal_frames (every
    frame of every capture, one launch of #1 and two of the Viterbi kernel)
    and its batch decode's digest equal to CODED_DIGEST, the JAX package's;
    the coded 4B5B rate-3/4 batch the same way (CODED4_DIGEST);
    OfdmModem(fec="conv") on ofdm_input's frames with noise sigma
    OFDM_NOISE (every payload; #2 once, the Viterbi kernel once); and
    coded_ber_sweep at its defaults, equal to CODED_BER_EXPECT, the JAX
    package's (#1, #3, #4 and the Viterbi kernel each launched).  Returns the
    launches of each kernel, by name, summed over the runs."""
    from trackmaker_tpu_torch.core.config import PhyConfig

    vit = convcode.viterbi_decode
    total = {}

    def add(got):
        for k_name, n in got.items():
            total[k_name] = total.get(k_name, 0) + n

    for tag, phy, x, frames, n_frames, plen, want_digest, k_hits in (
            ("coded_manchester_b8", coded.CodedManchesterPhy(PhyConfig(), local_addr=2, device=dev),
             x_c, frames_c, CODED_FRAMES, CODED_PAYLOAD, CODED_DIGEST, 1),
            ("coded_4b5b_r34", coded.CodedFourB5BPhy(
                PhyConfig(line_coding="4b5b", correlation_threshold=0.45), local_addr=2,
                rate34=True, device=dev), x4, frames4, CODED4_FRAMES + 2, CODED4_PAYLOAD,
             CODED4_DIGEST, 1)):
        got_f, got, wall = count_launches(
            torch, (xcorr_hits, vit), lambda: phy.decode_equal_frames(x, n_frames, plen))
        require(got == {"xcorr_hits": k_hits, "viterbi_decode": 2},
                f"{tag}: launches {got}, expected one of xcorr_hits and two of viterbi")
        add(got)
        want = [(f.sequence, f.data) for f in frames]
        for r, row in enumerate(got_f):
            require([(f.sequence, f.data) for f in row] == want,
                     f"{tag}: capture {r} gave {len(row)} of {len(want)} frames")
        starts, bits = phy.batched_decode_fn(n_frames, plen)(x)
        dg = ofdm_digest(starts.cpu().numpy(), bits.cpu().numpy())
        require(dg == want_digest, f"{tag}: decisions digest {dg}, the JAX package's {want_digest}")
        log(f"phase 2 ({tag}): decode_equal_frames of {x.shape[0]} x {x.shape[1]} took "
            f"{wall * 1e3:.1f} ms (first call); every capture gave its {len(want)} frames in "
            f"order; launches {got}; decisions digest {dg} = the JAX package's")
    k2 = xn.normalized_xcorr_dense
    modem = ofdm.OfdmModem(fec="conv", device=dev)
    wave = modem.encode_frames(frames_o, gap_samples=OFDM_GAP)
    rng = np.random.default_rng(OFDM_SEED + 2)
    wave = (wave + rng.normal(0, OFDM_NOISE, len(wave))).astype(np.float32)
    got_f, got, wall = count_launches(torch, (k2, vit), lambda: modem.decode(
        wave, 7 + OFDM_PAYLOAD, max_frames=OFDM_FRAMES))
    require(got == {k2.__name__: 1, "viterbi_decode": 1},
            f"OfdmModem(fec='conv') launches {got}")
    require([f.data for f in got_f] == [f.data for f in frames_o],
            f"OfdmModem(fec='conv') gave {len(got_f)} of {len(frames_o)} frames")
    add(got)
    log(f"phase 2 (ofdm_conv): OfdmModem(fec='conv').decode of {len(wave)} samples "
        f"({len(frames_o)} frames of {OFDM_PAYLOAD} B, noise sigma {OFDM_NOISE}) took "
        f"{wall * 1e3:.1f} ms (first call); every payload; launches {got}")
    kernels = (xcorr_hits, *spec_kernels, vit)
    res, got, wall = count_launches(torch, kernels, lambda: ber.coded_ber_sweep(device=dev))
    require(res == CODED_BER_EXPECT, f"coded_ber_sweep gave {res}, the JAX package's "
            f"{CODED_BER_EXPECT}")
    for k_name, n in got.items():
        require(n > 0, f"coded_ber_sweep never launched {k_name}")
    add(got)
    log(f"phase 2 (coded_ber_sweep): the defaults (8 SNRs, 16 frames of 64 B) took "
        f"{wall * 1e3:.1f} ms; the result equals CODED_BER_EXPECT, the JAX package's (coded "
        f"loss {[r['coded_loss_pct'] for r in res]}, uncoded {[r['uncoded_loss_pct'] for r in res]}"
        f" %); launches {got}")
    return total


def viterbi_bound(rows: int, n_bits: int) -> tuple[float, str]:
    """The Viterbi kernel's least time for `rows` blocks of n_bits: the
    received values in and the bits out once; per block of 4 steps, 16 paths
    of 4 adds and a compare for each of 64 states, per tail step 2 adds and a
    compare."""
    n_steps = n_bits + 6
    q, rem = divmod(n_steps, 4)
    return bound(rows * (2 * n_steps * 4 + n_bits),
                 rows * (q * 64 * 16 * 5 + rem * 64 * 3))


def time_viterbi(torch, convcode, hdr, pay, card) -> dict:
    """Phase 4 on the Viterbi kernel at the batch shapes (coded_manchester_b8's
    payloads, 256 rows of 518 steps, and headers, 256 of 62) and the live
    ones (one header row, 62 steps; the 263-byte frame's payload row of
    tests/test_torch_convcode.py's long corpora, 2,054 steps): one call's
    CUDA-event time, the device time of a launch (:func:`graph_ms`, and
    torch.profiler's median over the launches it traced, with their count),
    the host time of a call, the time a block step, the plain version and
    the bound.  Returns the payloads' numbers."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_convcode as corpora

    (frame,) = [r for name, r, _, _ in corpora.viterbi_corpora(long=True)
                if name == "one row of 2,054 steps"]
    shapes = (("payloads", pay, 8 * CODED_PAYLOAD), ("headers", hdr, 56),
              ("one header row", hdr[:1].contiguous(), 56),
              ("one row of a 263-byte frame's payload", torch.from_numpy(frame).to(pay.device),
               2048))
    out = {}
    for what, rows, n_bits in shapes:
        def call(rows=rows, n_bits=n_bits):
            return convcode.viterbi_decode(rows, n_bits, True)

        k_ms = time_ms(torch, call)
        graph = graph_ms(torch, call)
        prof, traced = traced_ms(torch, call, "viterbi_kernel")
        host = host_ms(torch, call)
        p_ms = time_ms(torch, lambda: convcode.viterbi_decode_plain(rows, n_bits, True), runs=5)
        bnd = viterbi_bound(rows.shape[0], n_bits)
        chain = -(-(n_bits + 6) // 4)
        log(f"phase 4: viterbi {what} ({rows.shape[0]} rows of {n_bits + 6} steps): kernel "
            f"{k_ms:.4f} ms (CUDA events, one call), device {graph:.5f} ms a launch (graph of "
            f"{GRAPH_LAUNCHES}, median of {GRAPH_REPLAYS}), profiler "
            + ("none traced" if prof is None else f"{prof:.5f} ms (median of {traced} traced)")
            + f", host {host:.4f} ms a call, {1e3 * graph / chain:.4f} us a block step ({chain} "
            f"block steps, each one barrier), plain {p_ms:.4f} ms (median of 5), bound "
            f"{bnd[0]:.6f} ms ({bnd[1]}) [{card}]")
        if what == "payloads":
            out = {"ms": k_ms, "plain_ms": p_ms, "bound": bnd, "device": graph}
    return out


def time_coded_paths(torch, coded, convcode, phy, x, buckets, card) -> dict:
    """Phase 4 on coded_manchester_b8: the batched decode end to end (median
    of RUNS, and its real-time multiple) and through decode_equal_frames, its
    steps (the correlation, the walk, the soft demod and deinterleave of the
    headers and of the payloads, the two Viterbi launches), its peak memory
    and busy share; the Viterbi kernel at the batch and live shapes
    (:func:`time_viterbi`); and one streaming process_samples call on the
    largest bucket the coded MAC run decoded.  Returns the Viterbi kernel's
    ms, plain_ms, bound and device time at the payload shape."""
    from trackmaker_tpu_torch.sync import auto_xcorr, walk_starts

    fn = phy.batched_decode_fn(CODED_FRAMES, CODED_PAYLOAD)
    e2e = time_ms(torch, lambda: fn(x))
    seconds = x.numel() / phy.cfg.sample_rate
    log(f"phase 4: coded_manchester_b8 batched decode {x.shape[0]} x {x.shape[1]}: {e2e:.4f} ms, "
        f"{seconds / (e2e / 1e3):.1f}x real time [{card}]")
    full = time_ms(torch, lambda: phy.decode_equal_frames(x, CODED_FRAMES, CODED_PAYLOAD))
    log(f"phase 4: coded_manchester_b8 decode_equal_frames (with the host's frame parse): "
        f"{full:.4f} ms, {seconds / (full / 1e3):.1f}x real time [{card}]")
    starts = coded_starts(phy, x, CODED_FRAMES, CODED_PAYLOAD)
    hdr, pay = coded_blocks(torch, phy, x, starts, CODED_PAYLOAD)
    corr = auto_xcorr(x, phy.pre)
    frame_len = phy.frame_samples(CODED_PAYLOAD)
    thr = phy.cfg.correlation_threshold
    steps = {
        "the correlation (#1 dense)": lambda: auto_xcorr(x, phy.pre),
        f"the walk ({CODED_FRAMES} steps)": lambda: walk_starts(corr, thr, CODED_FRAMES,
                                                               phy.preamble_len, frame_len),
        "soft demod + deinterleave (headers and payloads)": lambda: coded_blocks(
            torch, phy, x, starts, CODED_PAYLOAD),
        f"viterbi headers ({hdr.shape[0]} rows, 62 steps)": lambda: convcode.viterbi_decode(
            hdr, phy.HDR_BITS, True),
        f"viterbi payloads ({pay.shape[0]} rows, {8 * CODED_PAYLOAD + 6} steps)":
            lambda: convcode.viterbi_decode(pay, 8 * CODED_PAYLOAD, True),
    }
    for step, f in steps.items():
        log(f"phase 4: coded_manchester_b8 step {step}: {time_ms(torch, f):.4f} ms [{card}]")
    busy = busy_share(torch, lambda: fn(x))
    log(f"phase 4: coded_manchester_b8 peak device memory {peak_memory(torch, lambda: fn(x))}, "
        "device busy " + ("not measured" if busy is None else f"{busy:.3f}")
        + f" of a call [{card}]")
    out = time_viterbi(torch, convcode, hdr, pay, card)
    bucket = max(buckets, key=lambda bkt: bkt.shape[0]).cpu().numpy()
    stream = coded.CodedManchesterPhy(phy.cfg.replace(correlation_threshold=0.45), local_addr=2,
                                      device=x.device)

    def stream_call():
        stream.reset()
        return stream.process_samples(bucket)

    got = stream_call()
    log(f"phase 4: CodedManchesterPhy.process_samples of a {len(bucket)}-sample bucket (the coded "
        f"MAC run's largest; {len(got)} frames): {time_ms(torch, stream_call):.4f} ms [{card}]")
    return out


# --- adaptive OFDM and the single-carrier modems ---------------------------------------


def adaptive_phy(adaptive, loaded: bool, dev):
    """ofdm_adaptive_b8's receiver, or ofdm_adaptive_loaded_b8's."""
    return adaptive.OfdmAdaptiveStreamPhy(loading=adaptive_loading() if loaded else None,
                                          local_addr=2, device=dev)


def adaptive_blocks(torch, ofdm, phy, x):
    """(header rows f32[B·F, 124], payload rows f32[B·F, 1,036]): the Viterbi
    decoder's inputs in the batched decode of adaptive captures x."""
    starts = ofdm.find_preambles(phy.cfg, x, ADAPTIVE_FRAMES)
    return [b.reshape(-1, b.shape[-1]) for b in phy.soft_blocks(x, starts, ADAPTIVE_PAYLOAD)]


def run_adaptive_paths(torch, adaptive, fsk, psk, ofdm, xn, convcode, x_a, frames_a, x_l,
                       frames_l, sc, dev) -> tuple[dict, list]:
    """Phase 2 on adaptive OFDM and the single-carrier modems, each run with
    its kernels' counts set to 0 just before it and read just after:
    ofdm_adaptive_b8 and ofdm_adaptive_loaded_b8 through decode_equal_frames
    (every frame of every capture in order; one launch of #2 and two of the
    Viterbi kernel; the decisions' digest equal to ADAPTIVE_DIGEST /
    ADAPTIVE_LOADED_DIGEST, the JAX package's); the retrain run, equal to
    RETRAIN_EXPECT, the JAX package's; FskModem.decode and PskModem.decode
    (BPSK, QPSK) of SC_FRAMES frames each (every payload; #2 once each).
    Returns (each run's launches, the buckets the retrain's stream PHYs
    decoded)."""
    k2, vit = xn.normalized_xcorr_dense, convcode.viterbi_decode
    out = {}
    for tag, x, frames, loaded, want_digest in (
            ("ofdm_adaptive_b8", x_a, frames_a, False, ADAPTIVE_DIGEST),
            ("ofdm_adaptive_loaded_b8", x_l, frames_l, True, ADAPTIVE_LOADED_DIGEST)):
        phy = adaptive_phy(adaptive, loaded, dev)
        got_f, got, wall = count_launches(torch, (k2, vit), lambda: phy.decode_equal_frames(
            x, ADAPTIVE_FRAMES, ADAPTIVE_PAYLOAD))
        require(got == {k2.__name__: 1, vit.__name__: 2},
                f"{tag}: launches {got}, expected one of normalized_xcorr and two of viterbi")
        out[tag] = got
        want = [(f.sequence, f.data) for f in frames]
        for r, row in enumerate(got_f):
            require([(f.sequence, f.data) for f in row] == want,
                     f"{tag}: capture {r} gave {len(row)} of {len(want)} frames")
        starts, bits = phy.batched_decode_fn(ADAPTIVE_FRAMES, ADAPTIVE_PAYLOAD)(x)
        dg = ofdm_digest(starts.cpu().numpy(), bits.cpu().numpy())
        require(dg == want_digest, f"{tag}: decisions digest {dg}, the JAX package's {want_digest}")
        lv = phy.cfg.resolved_loading()
        classes = {k: int((lv == k).sum()) for k in (1, 2, 4, 6) if (lv == k).any()}
        log(f"phase 2 ({tag}): decode_equal_frames of {x.shape[0]} x {x.shape[1]} took "
            f"{wall * 1e3:.1f} ms (first call); loading {phy.cfg.bits_per_symbol} bits a symbol, "
            f"bins a class {classes}; every capture gave its {len(want)} frames in order; "
            f"launches {got}; decisions digest {dg} = the JAX package's")

    def first_start(cfg, rx):
        return int(ofdm.find_preambles(cfg, torch.from_numpy(rx).to(dev), 1)[0])

    with Recorder(adaptive.OfdmAdaptiveStreamPhy, "_starts", lambda phy, pj: pj) as rec:
        res, got, wall = count_launches(torch, (k2, vit),
                                        lambda: retrain_run(adaptive, first_start, device=dev))
    require(res == RETRAIN_EXPECT, f"the retrain run gave {res}, the JAX package's "
            f"{RETRAIN_EXPECT}")
    require(all(n > 0 for n in got.values()), f"the retrain run launches {got}")
    out["retrain"] = got
    log(f"phase 2 (retrain): the live retrain took {wall * 1e3:.1f} ms; loading "
        f"{res['bits0']} -> {res['bits1']} bits a symbol, pre-FEC BER calm {res['calm'][1]:.4f}, "
        f"tripped {res['tripped'][1]:.4f}, after {max(res['prefec2']):.4f}; control frames "
        f"{res['control']}; every frame delivered before and after; launches {got}; the result "
        "equals RETRAIN_EXPECT, the JAX package's")
    frames, caps = sc
    payloads = [f.data for f in frames]
    for name, (cfg, wave) in caps.items():
        modem = fsk.FskModem(cfg, device=dev) if name == "fsk" else psk.PskModem(cfg, device=dev)
        got_f, got, wall = count_launches(torch, (k2,), lambda: modem.decode(
            wave, 7 + SC_PAYLOAD, max_frames=SC_FRAMES))
        require(got == {k2.__name__: 1}, f"the {name} modem launches {got}")
        require([f.data for f in got_f] == payloads,
                f"the {name} modem gave {len(got_f)} of {SC_FRAMES} payloads")
        out[f"{name} modem"] = got
        log(f"phase 2 ({name} modem): decode of {len(wave)} samples ({SC_FRAMES} frames of "
            f"{SC_PAYLOAD} B, noise sigma {SC_NOISE}) took {wall * 1e3:.1f} ms (first call); "
            f"every payload; launches {got}")
    return out, rec.kept


def time_adaptive_paths(torch, adaptive, convcode, ofdm, x, buckets, card) -> None:
    """Phase 4 on ofdm_adaptive_b8: the batched decode end to end (median of
    RUNS, and its real-time multiple) and through decode_equal_frames, its
    steps (the correlation, the walk, the soft demap, the deinterleave, the
    two Viterbi launches, each also as device time from a CUDA graph), its
    peak memory and busy share, and one OfdmAdaptiveStreamPhy.process_samples
    call on the largest bucket its MAC run decoded."""
    from trackmaker_tpu_torch.sync import walk_starts

    phy = adaptive_phy(adaptive, False, x.device)
    cfg = phy.cfg
    fn = phy.batched_decode_fn(ADAPTIVE_FRAMES, ADAPTIVE_PAYLOAD)
    e2e = time_ms(torch, lambda: fn(x))
    seconds = x.numel() / cfg.sample_rate
    log(f"phase 4: ofdm_adaptive_b8 batched decode {x.shape[0]} x {x.shape[1]}: {e2e:.4f} ms, "
        f"{seconds / (e2e / 1e3):.1f}x real time [{card}]")
    full = time_ms(torch, lambda: phy.decode_equal_frames(x, ADAPTIVE_FRAMES, ADAPTIVE_PAYLOAD))
    log(f"phase 4: ofdm_adaptive_b8 decode_equal_frames (with the host's frame parse): "
        f"{full:.4f} ms, {seconds / (full / 1e3):.1f}x real time [{card}]")
    corr = ofdm.preamble_corr(cfg, x)
    starts = ofdm.find_preambles(cfg, x, ADAPTIVE_FRAMES)
    total = phy._coded_bits(ADAPTIVE_PAYLOAD)
    soft = adaptive.soft_demodulate_at_adaptive(cfg, x, total, starts.clamp(min=0))
    hdr, pay = adaptive_blocks(torch, ofdm, phy, x)
    n_pay = 8 * ADAPTIVE_PAYLOAD
    steps = {
        "sync: the chirp correlation (#2)": lambda: ofdm.preamble_corr(cfg, x),
        f"sync: the walk ({ADAPTIVE_FRAMES} steps)": lambda: walk_starts(
            corr, cfg.sync_threshold, ADAPTIVE_FRAMES, cfg.preamble_len, cfg.preamble_len),
        "soft demap": lambda: adaptive.soft_demodulate_at_adaptive(cfg, x, total,
                                                                   starts.clamp(min=0)),
        "deinterleave": lambda: (phy._deinterleave(soft[..., :phy.HDR_CODED]),
                                 phy._deinterleave(soft[..., phy.HDR_CODED:total])),
        f"viterbi headers ({hdr.shape[0]} rows, 62 steps)": lambda: convcode.viterbi_decode(
            hdr, phy.HDR_BITS, True),
        f"viterbi payloads ({pay.shape[0]} rows, {n_pay + 6} steps)":
            lambda: convcode.viterbi_decode(pay, n_pay, True),
    }
    for step, f in steps.items():
        extra = ""
        if step.startswith("viterbi"):
            extra = f", device {graph_ms(torch, f):.5f} ms a launch (graph of {GRAPH_LAUNCHES})"
        log(f"phase 4: ofdm_adaptive_b8 step {step}: {time_ms(torch, f):.4f} ms{extra} [{card}]")
    busy = busy_share(torch, lambda: fn(x))
    log(f"phase 4: ofdm_adaptive_b8 peak device memory {peak_memory(torch, lambda: fn(x))}, "
        "device busy " + ("not measured" if busy is None else f"{busy:.3f}")
        + f" of a call [{card}]")
    stream = adaptive.OfdmAdaptiveStreamPhy(loading=MAC_RUNS[
        "csma_transfer, ofdm_adaptive"][2]["loading"], local_addr=2, device=x.device)
    bucket = max(buckets, key=lambda bkt: bkt.shape[0]).cpu().numpy()

    def stream_call():
        stream.reset()
        return stream.process_samples(bucket)

    got = stream_call()
    log(f"phase 4: OfdmAdaptiveStreamPhy.process_samples of a {len(bucket)}-sample bucket (the "
        f"adaptive MAC run's largest; {len(got)} frames): {time_ms(torch, stream_call):.4f} ms "
        f"[{card}]")


def check_stream_fallbacks(torch, phy_decoder, stream_mod, cfg, crowded, dev) -> None:
    """Phase 3 (phy_decoder): a buffer that overflows the candidate table
    (150 back-to-back preambles before three frames) in one PhyDecoder call,
    and as one streaming segment: the speculative decode is not ok, the
    exact scan decodes it on the card, and the frames and the buffer left
    (the searched prefix) equal the port's CPU run."""
    x = crowded.cpu().numpy()
    runs = {}
    for where in (dev, "cpu"):
        dec = phy_decoder(cfg, LOCAL_ADDR, MAX_FRAMES, device=where)
        frames = dec.process_samples(x)
        runs[str(where)] = ([(f.sequence, f.dst, f.data) for f in frames], len(dec._buf),
                            dec.decode_calls, dec.exact_calls)
    card, cpu = runs[str(dev)], runs["cpu"]
    require(card[2:] == (1, 1), f"the crowded buffer took {card[3]} exact decodes of {card[2]}")
    require(card == cpu and len(card[0]) == 3,
            f"PhyDecoder on the card {card[:2]} differs from the CPU's {cpu[:2]}")
    seg = np.concatenate([x, np.zeros(2_000, np.float32)])
    xn, n = torch.from_numpy(stream_mod.padded_segment(seg)).to(dev), len(seg)
    pack = stream_mod.packed_decode(cfg, xn, LOCAL_ADDR, MAX_FRAMES).cpu().numpy()
    require(not stream_mod.parse_packed(pack)[0], "the crowded segment's pack is ok")
    segs = {}
    for where in (dev, "cpu"):
        pipe = stream_mod.StreamingDecodePipeline(cfg, LOCAL_ADDR, device=where,
                                                  max_frames_per_segment=MAX_FRAMES)
        frames = pipe.push(x) + pipe.flush()
        segs[str(where)] = ([(f.sequence, f.data) for f in frames], pipe.segments_decoded)
    require(segs[str(dev)] == segs["cpu"] and len(segs["cpu"][0]) == 3,
            f"the pipeline on the card {segs[str(dev)]} differs from the CPU's {segs['cpu']}")
    log(f"phase 3 (phy_decoder): a {len(x)}-sample buffer of 150 back-to-back preambles before "
        f"3 frames: PhyDecoder's speculative decode not ok, the exact scan on the card gives "
        f"{len(card[0])} frames and keeps {card[1]} samples, as on the CPU; as one streaming "
        f"segment ({n} samples in a bucket of {xn.shape[0] - 1}): the pack not ok, "
        f"decode_capture_fast on the card gives the CPU's {len(segs['cpu'][0])} frames")


def ask_captures(torch, ask, cfg, dev):
    """The ask_b16 input (bench.py's ask row): 16 tracks of 64 frames,
    zero-padded to the longest, on `dev`."""
    frames = ask.build_frames(ASK_TEXT, cfg, num_frames=ASK_FRAMES)
    waves = [ask.build_track(cfg, frames, seed=7 + r) for r in range(ASK_BATCH)]
    caps = np.zeros((ASK_BATCH, max(len(w) for w in waves)), np.float32)
    for r, w in enumerate(waves):
        caps[r, :len(w)] = w
    return frames, torch.from_numpy(caps).to(dev)


def chain_rows(torch, rng, n: int, win: int, dev):
    """Random record-chain rows with ties, an empty row and a flat row."""
    vals = np.full((n, win), -np.inf, np.float32)
    mask = rng.random((n, win)) < 0.05
    vals[mask] = rng.normal(1, 0.5, mask.sum()).astype(np.float32)
    vals[3, 40] = vals[3, 60] = np.float32(2.5)
    vals[4] = -np.inf
    vals[5] = np.float32(0.5)
    return (torch.from_numpy(vals).to(dev),
            torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)).to(dev))


def walk_table(torch, rng, b: int, c1: int, dev):
    """A random ASK successor table int32[b, 6, c1]."""
    fields = np.stack([rng.random((b, c1)) < 0.95, rng.random((b, c1)) < 0.95,
                       rng.random((b, c1)) < 0.95, rng.integers(-5, 400_000, (b, c1)),
                       rng.integers(-1, c1, (b, c1)), rng.random((b, c1)) < 0.03], axis=1)
    return torch.from_numpy(fields.astype(np.int32)).to(dev)


def chain_columns(torch, vals, base, guard: int) -> int:
    """The columns the record chain needs on these rows: each row up to its
    first fire, all of it when it never fires."""
    n, win = vals.shape
    m = torch.nn.functional.pad(vals.cummax(-1).values[:, :-1], (1, 0), value=-np.inf)
    upd = vals > m
    idx = base[:, None] + torch.arange(win, dtype=torch.int32, device=vals.device)
    rec = torch.where(upd, idx, -(2**30)).cummax(-1).values
    rec = torch.nn.functional.pad(rec[:, :-1], (1, 0), value=-(2**30))
    fire = ~upd & (idx > rec + guard) & (m > -np.inf)
    lane = torch.arange(win, device=vals.device)
    return int((torch.where(fire, lane, win - 1).amin(-1) + 1).sum())


def check_ask_kernels(torch, ask, ask_spec, sdot, cfg, xa, rng) -> tuple[dict, dict]:
    """Phase 1 for the four ASK kernels at the ask_b16 shapes; returns
    (max |err| per kernel, the inputs phase 4 times them on)."""
    dev = xa.device
    b = xa.shape[0]
    pre = ask._chirp_np(cfg)
    k30 = ask._demod_dense_tables_np(cfg)[0]
    demod_in = ask.demod_dense_input(cfg, xa)
    errs = dict.fromkeys(("sliding_dot", "ask_fire", "ask_chain", "ask_walk"), 0)

    def record(k_name: str, got, want, what: str) -> None:
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"{k_name} differs {what}")
        errs[k_name] = max([errs[k_name]] + [(g.double() - w.double()).abs().max().item()
                                             for g, w in zip(got, want)])

    for x, pattern, scale in ((xa, pre, 1.0 / cfg.sync_divisor), (demod_in, k30, 1.0)):
        got = sdot.sliding_dot_scaled(x, pattern, scale)
        torch.cuda.synchronize()
        record("sliding_dot", [got], [sdot.sliding_dot_scaled_plain(x, pattern, scale)],
               f"at L={len(pattern)}")
    log(f"phase 1: sliding_dot == plain at L=440 on {b} x {xa.shape[1]} and at L=30 on "
        f"{demod_in.shape[0]} x {demod_in.shape[1]}")
    xx = xa[:SWEEP_B, :SWEEP_T].contiguous()
    patterns = np.tile(pre, -(-sdot.MAX_PATTERN // len(pre)))
    for l in RAW_LS:
        got = sdot.sliding_dot_scaled(xx, patterns[:l], 1.0 / cfg.sync_divisor)
        torch.cuda.synchronize()
        record("sliding_dot", [got],
               [sdot.sliding_dot_scaled_plain(xx, patterns[:l], 1.0 / cfg.sync_divisor)],
               f"at L={l} on {SWEEP_B} x {SWEEP_T}")
    log(f"phase 1: sliding_dot == plain bit for bit at every L in {list(RAW_LS)} (the chirp "
        f"repeated and cut) on {SWEEP_B} x {SWEEP_T}")

    power, sync, upd_ok = ask.dense_arrays(cfg, xa)
    hits = ask_spec.dense_fire_candidates(cfg, sync, upd_ok)
    torch.cuda.synchronize()
    record("ask_fire", [hits], [ask_spec.dense_fire_candidates_plain(cfg, sync, upd_ok)],
           "on the batch's sync")
    log(f"phase 1: ask_fire == plain ({int(upd_ok.sum())} updates, {int(hits.sum())} fire "
        "candidates)")

    cand, n_valid, overflow = ask_spec.extract_candidates(hits, 96)
    virt = torch.full((b, 1), -(cfg.frame_samples + 1), dtype=torch.int32, device=dev)
    cand_full = torch.cat([virt, cand], dim=1)
    vals, base, _ = ask_spec.chain_windows(cfg, xa, power, sync, upd_ok, cand_full)
    rows = [(vals, base)] + [chain_rows(torch, rng, 300, win, dev) for win in (1000, 1024, 4096)]
    for v, bs in rows:
        got = ask.ask_chain(v, bs, cfg.peak_guard)
        torch.cuda.synchronize()
        record("ask_chain", got, ask.ask_chain_plain(v, bs, cfg.peak_guard),
               f"on rows of {v.shape[1]}")
    log(f"phase 1: ask_chain == plain on the batch's {vals.shape[0]} chain rows "
        f"({int(ask.ask_chain(vals, base, cfg.peak_guard)[0].sum())} fire) and on random rows "
        "with ties (widths 1000, 1024, 4096)")

    fields = ask_spec.phase_b(cfg, xa, power, sync, upd_ok, cand_full)
    tables = [(fields, ASK_MAX_FRAMES)] + [(walk_table(torch, rng, 16, 97, dev), mf)
                                           for mf in (1, 72, 128)]
    for f, mf in tables:
        got = ask_spec.ask_walk(f, mf)
        torch.cuda.synchronize()
        record("ask_walk", got, ask_spec.ask_walk_plain(f, mf), f"(max_frames {mf})")
    log(f"phase 1: ask_walk == plain on the batch's table (candidates per capture "
        f"{int(n_valid.min())}..{int(n_valid.max())}, overflow {int(overflow.sum())}) and on "
        "three random tables")
    return errs, dict(demod_in=demod_in, sync=sync, upd_ok=upd_ok, vals=vals, base=base,
                      fields=fields, k30=k30, pre=pre)


def run_ask_main_path(torch, ask, ask_spec, cfg, xa, frames, kernels) -> dict[str, int]:
    """The ask_b16 main path through ask.demodulate_fast, with its gates;
    returns the launch count of each kernel in `kernels`."""
    b = xa.shape[0]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ask.demodulate_fast(cfg, xa, max_frames=ASK_MAX_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {KERNEL_NAMES.get(k.__name__, k.__name__): k.launches for k in kernels}
    log(f"phase 2 (ask_b16): demodulate_fast took {wall * 1e3:.1f} ms (first call), "
        f"kernel launches {launches}")
    for k_name, n in launches.items():
        require(n > 0, f"the ask_b16 main path never launched {k_name}")
    spec_res, ok = ask_spec.demodulate_spec(cfg, xa, max_frames=ASK_MAX_FRAMES)
    require(bool(ok.all()), "an ask_b16 row is not ok")
    require(all(torch.equal(p, q) for p, q in zip(spec_res, res)),
            "ask_b16: demodulate_fast differs from demodulate_spec with every row ok")
    counts = res.count.cpu().numpy()
    require(bool((counts == ASK_FRAMES).all()),
            f"ask_b16 count gate failed: {sorted(set(counts.tolist()))}")
    bits, valid = res.bits.cpu().numpy(), res.valid.cpu().numpy()
    for r in range(b):
        require(np.array_equal(bits[r][valid[r]], frames[:, 8:]),
                f"ask_b16 payload gate failed at row {r}")
    for r in (0, b - 1):
        exact = ask.demodulate(cfg, xa[r], max_frames=ASK_MAX_FRAMES)
        require(all(torch.equal(p[r], q) for p, q in zip(res, exact)),
                f"ask_b16 row {r} differs from the exact scan")
    log(f"phase 2 (ask_b16): payload gate passed ({b} rows x {ASK_FRAMES} frames), every row "
        f"ok, rows 0 and {b - 1} equal the exact scan in all four fields; decisions digest "
        f"{digest(res)}")
    return launches


def check_ask_fallback(torch, ask, ask_spec, cfg, dev) -> None:
    """Row 0, 150 back-to-back chirps before three frames, overflows its
    candidate table; row 1, the three frames alone, is clean.  The merged
    batch must equal the exact scan."""
    frames = ask.build_frames(b"fallback", cfg, num_frames=3)
    tail = ask.build_track(cfg, frames, seed=2)
    crowded = np.concatenate([np.tile(ask._chirp_np(cfg), 150), np.zeros(500, np.float32), tail])
    clean = np.pad(tail, (0, len(crowded) - len(tail)))
    small = torch.from_numpy(np.stack([crowded, clean])).to(dev)
    _, small_ok = ask_spec.demodulate_spec(cfg, small, max_frames=ASK_MAX_FRAMES)
    require(small_ok.tolist() == [False, True], f"ask fallback flags {small_ok.tolist()}")
    merged = ask.demodulate_fast(cfg, small, max_frames=ASK_MAX_FRAMES)
    for r in range(2):
        exact = ask.demodulate(cfg, small[r], max_frames=ASK_MAX_FRAMES)
        require(all(torch.equal(p[r], q) for p, q in zip(merged, exact)),
                f"ask fallback row {r} differs from the exact scan")
    require(merged.count.tolist() == [2, 3],
            f"ask fallback frames {merged.count.tolist()}, expected [2, 3]")
    log("phase 3 (ask): fallback row (150 back-to-back chirps, more fire candidates than the "
        f"table holds) re-decoded by the exact scan on the card; merged batch equals it "
        f"({merged.count.tolist()} frames)")


def rows_of(torch, corr, n_rows: int):
    """corr f32[B, N] padded with -3.4e38 to rows of 128 lags."""
    return torch.nn.functional.pad(corr, (0, n_rows * 128 - corr.shape[1]),
                                   value=-3.4e38).reshape(corr.shape[0], n_rows, 128)


def check_rowstats(torch, xn, xcorr_hits, x, pre, tag: str) -> float:
    """xcorr_rowstats against its plain version (row maxima within
    CORR_ATOL, positions equal on rows whose two largest lags differ by
    more) and, exactly, against the row reduction of normalized_xcorr's
    dense corr and, at L <= 128, of xcorr_hits'; returns the max |err|
    against the plain version."""
    from trackmaker_tpu_torch.sync.correlate import pattern_norm, preamble_energy

    require(pattern_norm(pre) == float(np.float32(preamble_energy(pre))),
            f"xcorr_rowstats ({tag}): the two norms of the pattern differ")
    rowmax, rowpos = xn.xcorr_rowstats(x, pre)
    torch.cuda.synchronize()
    rowmax_p, rowpos_p = xn.xcorr_rowstats_plain(x, pre)
    b, n_rows = rowmax.shape
    require(rowmax_p.shape == (b, n_rows) and rowpos.shape == (b, n_rows),
            f"xcorr_rowstats ({tag}) shapes {list(rowmax.shape)} / {list(rowmax_p.shape)}")
    err = (rowmax - rowmax_p).abs().max().item()
    require(err <= CORR_ATOL, f"xcorr_rowstats ({tag}) row maxima differ by {err}")
    top2 = rows_of(torch, xn.normalized_xcorr_dense_plain(x, pre), n_rows).topk(2, -1).values
    clear = top2[..., 0] - top2[..., 1] > CORR_ATOL
    require(torch.equal(rowpos[clear], rowpos_p[clear]),
            f"xcorr_rowstats ({tag}) positions differ on an unambiguous row")
    denses = {"normalized_xcorr": xn.normalized_xcorr_dense(x, pre)}
    if len(pre) <= 128:
        denses["xcorr_hits"] = xcorr_hits(x, pre, float("inf"), emit_corr=True)[0]
    for k_name, dense in denses.items():
        mx, lane = rows_of(torch, dense, n_rows).max(-1)
        pos = (torch.arange(n_rows, device=x.device) * 128 + lane).to(torch.int32)
        require(torch.equal(rowmax, mx) and torch.equal(rowpos, pos),
                f"xcorr_rowstats ({tag}) differs from the row reduction of {k_name}' corr")
    log(f"phase 1: xcorr_rowstats == plain at L={len(pre)} on {b} x {x.shape[1]} (row max "
        f"|err| {err:.3g}, positions equal on {int(clear.sum())} of {clear.numel()} unambiguous "
        f"rows) and == the row reduction of {' and '.join(denses)}' dense corr, bit for bit")
    return err


def check_dense(torch, xn, xcorr_hits, xa, chirp, xe, pre) -> float:
    """normalized_xcorr_dense against its plain version at L=440 on the
    ask_b16 captures and, exactly, against xcorr_hits' dense corr at L=96;
    returns the max |err| against the plain version."""
    got = xn.normalized_xcorr_dense(xa, chirp)
    torch.cuda.synchronize()
    want = xn.normalized_xcorr_dense_plain(xa, chirp)
    require(got.shape == want.shape, f"normalized_xcorr shape {list(got.shape)}")
    err = (got - want).abs().max().item()
    require(err <= CORR_ATOL, f"normalized_xcorr at L={len(chirp)} differs by {err}")
    corr, _ = xcorr_hits(xe, pre, float("inf"), emit_corr=True)
    require(torch.equal(xn.normalized_xcorr_dense(xe, pre), corr),
            f"normalized_xcorr at L={len(pre)} differs from xcorr_hits' dense corr")
    log(f"phase 1: normalized_xcorr == plain at L={len(chirp)} on {xa.shape[0]} x {xa.shape[1]} "
        f"(max |err| {err:.3g}, peak corr {got.max().item():.4f}) and == xcorr_hits' dense corr "
        f"at L={len(pre)} on {xe.shape[0]} x {xe.shape[1]}, bit for bit")
    return err


def check_equalizer_noise(torch, equalizer, cfg, dev, seed: int) -> None:
    """A noise-only batch passes the equalizer bit for bit, untrained."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((4, 40_000), generator=gen, device=dev) * 0.1
    out, info = equalizer.equalize_capture(cfg, noise)
    require(not bool(info["applied"].any()), "the equalizer trained on noise")
    require(torch.equal(out, noise), "a noise-only capture came back changed")
    log("phase 3 (equalizer): a noise-only batch of 4 passes unchanged (quality "
        f"{info['quality'].max().item():.3f} < 0.5, output bit-identical)")


def planted_capture(torch, cfg, frames, starts, t: int, seed: int, dev):
    """`frames` at `starts` in t samples of noise (sigma NOISE, a seeded
    numpy generator), as bench.py builds its long capture, on `dev`."""
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    enc = PhyEncoder(cfg, device=dev)
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, NOISE, t).astype(np.float32)).to(dev)
    for s, f in zip(starts, frames):
        w = enc.encode_frame(f)
        x[s:s + w.shape[0]] += w
    return x


def blocked_input(torch, cfg, seed: int, dev):
    """bench.py's blocked_600s input: 48 frames of bytes([i]) * 64 at
    (i + 1) * (t // 49) in 600 s; returns (frames, starts, capture f32[t])."""
    from trackmaker_tpu_torch.core.framing import Frame

    t = BLOCKED_SECONDS * cfg.sample_rate
    frames = [Frame.new_data(i, 1, 2, bytes([i]) * BLOCKED_PAYLOAD) for i in range(BLOCKED_FRAMES)]
    starts = [(i + 1) * (t // (BLOCKED_FRAMES + 1)) for i in range(BLOCKED_FRAMES)]
    return frames, starts, planted_capture(torch, cfg, frames, starts, t, seed, dev)


def seam_input(torch, stream, cfg, seed: int, dev):
    """The 4B5B seam capture: 60 s in 8 blocks, a frame starting 1,000
    samples before each seam and one in the middle of each block."""
    from trackmaker_tpu_torch.core.framing import Frame

    t = SEAM_SECONDS * cfg.sample_rate
    block = stream.spec_block(t, SEAM_BLOCKS)
    starts = sorted([k * block - 1000 for k in range(1, SEAM_BLOCKS)]
                    + [k * block + block // 2 for k in range(SEAM_BLOCKS)])
    frames = [Frame.new_data(i, 1, 2, bytes([100 + i]) * BLOCKED_PAYLOAD)
              for i in range(len(starts))]
    return frames, starts, planted_capture(torch, cfg, frames, starts, t, seed, dev)


def flat_input(torch, stream, x, n_blocks: int):
    """(flat capture f32[1, n_blocks * block], block, vlens int32[n_blocks]),
    as decode_blocked_spec pads a capture."""
    t = x.shape[0]
    block = stream.spec_block(t, n_blocks)
    xf = torch.nn.functional.pad(x, (0, n_blocks * block - t))[None].contiguous()
    return xf, block, torch.full((n_blocks,), t, dtype=torch.int32, device=x.device)


def shared_attempts(sd, cfg):
    """(legacy, fold, legacy plain, fold plain) attempt wrappers of cfg's
    line code."""
    if cfg.line_coding == "manchester":
        return (sd.attempt_manchester, sd.attempt_manchester_fold, sd.attempt_manchester_plain,
                sd.attempt_manchester_fold_plain)
    return sd.attempt_4b5b, sd.attempt_4b5b_fold, sd.attempt_4b5b_plain, sd.attempt_4b5b_fold_plain


def check_shared(torch, sd, xh, stream, cfg, x, n_blocks: int, tag: str,
                 need_past_2_24: bool) -> tuple[dict, dict]:
    """Phase 1 for the shared-capture attempts on one long capture: the
    legacy and fold forms against their plain versions, the fold's frame
    starts against the legacy form's; some live candidate must read past
    its block's end (a kernel reading one block's samples fails there)
    and, where asked, lie past 2^24.  Returns the max |err| per kernel and
    the inputs phase 4 times them on."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync.correlate import preamble_energy

    pre = preamble_waveform(cfg)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    thr = cfg.correlation_threshold
    xf, block, vlens = flat_input(torch, stream, x, n_blocks)
    rows = xh.xcorr_hits(xf, pre, thr)[1][0].reshape(n_blocks, block // 128, -1)
    rows_r = xh.xcorr_hits_refine(xf, vlens[:1], pre, sync, thr, **refine_kw(cfg))
    rows_r = rows_r[0].reshape(n_blocks, block // 128, -1)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, N_CAND)
    cand_r, _, n_valid_r, _, fs_r = sd.compact_hit_rows(rows_r, N_CAND, with_fs=True)
    require(torch.equal(cand_r, cand) and torch.equal(n_valid_r, n_valid),
            f"the fold's candidate tables ({tag}) differ from the legacy ones")
    legacy, fold, legacy_plain, fold_plain = shared_attempts(sd, cfg)
    xe = xf.expand(n_blocks, -1)    # every block reads the one capture: row stride 0
    calls = {f"{legacy.__name__}_shared": (legacy, legacy_plain,
                                           (xe, cand, n_valid, vlens, sync, preamble_energy(sync))),
             f"{fold.__name__}_shared": (fold, fold_plain, (xe, fs_r, n_valid))}
    errs, outs = {}, {}
    for k_name, (kernel, plain, args) in calls.items():
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        for g, w in zip(got, want):
            require(torch.equal(g, w), f"{k_name} ({tag}) differs from its plain version")
        errs[k_name] = max((g.long() - w.long()).abs().max().item() for g, w in zip(got, want))
        outs[k_name] = got
    for g, w in zip(*outs.values()):
        require(torch.equal(g, w), f"the shared fold attempt ({tag}) differs from the legacy one")
    live = sd._live(cand, n_valid)
    fs = outs[f"{legacy.__name__}_shared"][1]
    body = (sd.FRAME_BYTES * 8 * sd.BIT_SAMPLES if cfg.line_coding == "manchester"
            else sd.ZERO_SYMBOLS * sd.SYMBOL_SAMPLES)
    block_end = (torch.arange(n_blocks, device=x.device)[:, None] + 1) * block
    crossing = int((live & (fs + body > block_end)).sum())
    past = int((live & (cand >= 2**24)).sum())
    require(crossing > 0, f"no live candidate of {tag} reads past its block's end")
    require(past > 0 or not need_past_2_24, f"no live candidate of {tag} lies past 2^24")
    log(f"phase 1: {' and '.join(calls)} == plain on {tag} ({x.shape[0]} samples, {n_blocks} "
        f"blocks of {block}): {int(live.sum())} live candidates, {crossing} reading past their "
        f"block's end, {past} past 2^24; the fold's frame starts and bytes == the legacy form's")
    return errs, dict(calls=calls, live=int(live.sum()), xf=xf, block=block, vlens=vlens)


def frame_set(res):
    """The valid frames of a flat result as sorted (start, sequence, bytes)."""
    return sorted((s, q, b) for b, _, _, q, _, _, s in frame_list(res))


def run_blocked_path(torch, sd, stream, cfg, x, frames, starts, n_blocks: int, counters,
                     tag: str, cross_check: bool):
    """One main-path run of decode_blocked_single_chip with its gates: every
    frame once, at its start, with its payload; the speculative route ok
    and equal to the returned frames; each kernel in `counters` (name,
    wrapper, counter attribute, expected launches or None for one per
    fixpoint turn) launched as expected.  With `cross_check`, the plain
    walk's fixpoint on the same candidate tables must take as many turns,
    and more than one.  Returns (the launches, the frames)."""
    for _, fn, attr, _ in counters:
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = stream.decode_blocked_single_chip(cfg, x, LOCAL_ADDR, n_blocks, BLOCKED_MFPB, N_CAND)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(fn, attr) for name, fn, attr, _ in counters}
    log(f"phase 2 ({tag}): decode_blocked_single_chip took {wall * 1e3:.1f} ms (first call), "
        f"kernel launches {launches}")
    spec_res, ok, turns = stream.decode_blocked_spec(cfg, x, LOCAL_ADDR, n_blocks, BLOCKED_MFPB,
                                                     N_CAND)
    require(bool(ok), f"the {tag} speculative route is not ok")
    require(all(torch.equal(p, q) for p, q in zip(spec_res, res)),
            f"{tag}: decode_blocked_single_chip differs from its speculative route")
    expect = {name: turns if n is None else n for name, _, _, n in counters}
    require(launches == expect, f"{tag} launches {launches}, expected {expect}")
    if cross_check:
        xf, block, vlens = flat_input(torch, stream, x, n_blocks)
        a = sd.spec_phase_a(cfg, xf[0], LOCAL_ADDR, N_CAND, vlens, flat_blocks=(n_blocks, block))
        block_starts = torch.arange(n_blocks, dtype=torch.int32, device=x.device) * block
        _, plain_turns = stream.seam_fixpoint(sd.spec_walk_plain, a.fields, block_starts,
                                              block_starts + block, BLOCKED_MFPB)
        require(plain_turns == turns > 1, f"{tag}: the fixpoint took {turns} turn(s), the "
                f"plain walk's {plain_turns}; more than one expected")
    got = frame_set(res)
    want = sorted((s, f.sequence, f.to_bytes()) for s, f in zip(starts, frames))
    require([q for _, q, _ in got] == [q for _, q, _ in want] and got == want,
            f"{tag} payload gate failed: {len(got)} of {len(frames)} frames, sequences "
            f"{[q for _, q, _ in got]}")
    log(f"phase 2 ({tag}): payload gate passed ({len(frames)} frames, starts up to "
        f"{max(starts)}, each exact), ok, {turns} fixpoint turn(s), one walk each")
    return launches, res


def check_blocked_fallback(torch, stream, decode_capture, cfg, x, starts) -> None:
    """The 4B5B seam capture with a level zeroed inside the frame across
    seam 1 (a near-zero level the attempt kernel reads otherwise than the
    receiver): the speculative route is not ok, decode_blocked_single_chip
    returns the exact route's frames, and they equal the sequential exact
    scan's."""
    seam = stream.spec_block(x.shape[0], SEAM_BLOCKS)
    require(seam - 1000 in starts, "no frame across seam 1 of the seam capture")
    zeroed = x.clone()
    level0 = seam - 1000 + cfg.preamble_len + 20 * 15 + 3
    zeroed[level0:level0 + 3] = 0.0
    _, ok, _ = stream.decode_blocked_spec(cfg, zeroed, LOCAL_ADDR, SEAM_BLOCKS, BLOCKED_MFPB, N_CAND)
    require(not bool(ok), "the zeroed level did not make the speculative route not ok")
    got = stream.decode_blocked_single_chip(cfg, zeroed, LOCAL_ADDR, SEAM_BLOCKS, BLOCKED_MFPB,
                                            N_CAND)
    exact = stream.decode_blocked_exact(cfg, zeroed, LOCAL_ADDR, SEAM_BLOCKS, BLOCKED_MFPB)
    require(all(torch.equal(p, q) for p, q in zip(got, exact)),
            "decode_blocked_single_chip did not return the exact route's frames")
    seq = decode_capture(cfg, zeroed, LOCAL_ADDR, max_frames=len(starts) + 8)
    require(frame_set(got) == frame_set(seq), "the exact blocked route differs from the exact scan")
    log(f"phase 3 (blocked 4b5b): a zeroed level across seam 1 makes the speculative route not "
        f"ok; decode_blocked_single_chip returned the exact route's {len(frame_set(got))} frames "
        f"(of {len(starts)} planted), equal to the sequential exact scan's")


def checked_walk(torch, sd, calls: list):
    """spec_walk with each call held against its plain version on the same
    fields, cursors and limits (the seam fixpoint's own); appends each
    call's start cursors to `calls`."""
    def walk(fields, cur, limit, max_frames):
        got = sd.spec_walk(fields, cur, limit, max_frames)
        torch.cuda.synchronize()
        want = sd.spec_walk_plain(fields, cur, limit, max_frames)
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                "spec_walk differs from its plain version at a fixpoint turn's cursors")
        calls.append(cur.tolist())
        return got
    return walk


def check_sharded(torch, sd, stream, xcorr_hits, xcorr_hits_plain, cfg, capture, mesh,
                  max_frames: int, tag: str) -> float:
    """Phase 1 on a sharded decode's own inputs: #1, #3 (#5) and #4 on the
    shards' windows at their valid lengths, a batch a device
    (check_path_batch), and #4 at every turn of the speculative route's
    seam fixpoint, on its cursors.  Returns #1's max |err|."""
    sw = stream.shard_windows(capture, mesh, stream.halo_size(cfg))
    err = 0.0
    for dev, (idx, wins) in sw.groups.items():
        vlens = torch.tensor([sw.vlens[i] for i in idx], dtype=torch.int32, device=dev)
        err = max(err, check_path_batch(torch, sd, xcorr_hits, xcorr_hits_plain, cfg, wins,
                                        max_frames, f"{tag} windows", vlens=vlens))
    calls = []
    _, ok, turns = stream.sharded_spec_run(cfg, capture, LOCAL_ADDR, mesh, max_frames, N_CAND,
                                           walk=checked_walk(torch, sd, calls))
    require(bool(ok.all()) and len(calls) == turns, f"the {tag}: not ok, or {len(calls)} walks "
            f"in {turns} turns")
    log(f"phase 1: the {tag}: spec_walk == plain at each of the seam fixpoint's {turns} turns "
        f"(start cursors {calls})")
    return err


def mesh_frames(res) -> list[tuple[int, int]]:
    """The (start, sequence) pairs of a sharded decode's valid frames."""
    valid = res.valid.cpu().numpy()
    return sorted(zip(res.start.cpu().numpy()[valid].tolist(),
                      res.sequence.cpu().numpy()[valid].tolist()))


def run_mesh_paths(torch, sd, stream, mesh_mod, ofdm_stream, decoder_mod, cfg, xb, frames_b,
                   starts_b, x, frames, kernels, dev) -> tuple[dict, dict]:
    """phase 2 (mesh): the multi-device decode over meshes of the card
    repeated (and of distinct cards where more than one is visible), each
    call with the kernels' counts set to 0 just before it; returns (the
    launches of each kernel over these runs, the inputs phases 1 and 4
    use)."""
    from trackmaker_tpu_torch.core.config import PhyConfig

    total: dict[str, int] = {}

    def counted(fn):
        out, got, wall = count_launches(torch, kernels, fn)
        for k_name, n in got.items():
            total[k_name] = total.get(k_name, 0) + n
        return out, got, wall

    m4 = mesh_mod.make_mesh(sp=MESH_SHARDS, devices=[dev] * MESH_SHARDS)
    mdp = mesh_mod.make_mesh(dp=MESH_SHARDS, devices=[dev] * MESH_SHARDS)
    n_cards = torch.cuda.device_count()
    log(f"phase 2 (mesh): meshes of the card repeated: (1, {MESH_SHARDS}) {m4.flat}, "
        f"({MESH_SHARDS}, 1) {mdp.flat}, and (2, 4) / (1, 8) of 8 x {dev} for the seam "
        "scenarios; " + ("a mesh over the distinct cards runs too" if n_cards > 1 else
                         "a mesh over distinct cards: not run, torch.cuda.device_count() is 1"))
    want_b = sorted((s, f.sequence, f.to_bytes()) for s, f in zip(starts_b, frames_b))
    res, got, wall = counted(lambda: stream.decode_blocked_sharded(cfg, xb, LOCAL_ADDR, m4,
                                                                   n_cand=N_CAND))
    spec, ok, turns = stream.sharded_spec_run(cfg, xb, LOCAL_ADDR, m4, 32, N_CAND)
    require(bool(ok.all()), f"blocked_600s over {MESH_SHARDS} shards: a shard is not ok "
            f"({ok.tolist()})")
    require(all(torch.equal(p, q) for p, q in zip(res, spec)),
            "decode_blocked_sharded differs from its speculative route with every shard ok")
    single = stream.decode_blocked_single_chip(cfg, xb, LOCAL_ADDR, BLOCKED_BLOCKS, BLOCKED_MFPB,
                                               N_CAND)
    require(frame_set(res) == frame_set(single) == want_b,
            f"blocked_600s over {MESH_SHARDS} shards: {len(frame_set(res))} of "
            f"{len(frames_b)} frames, or not decode_blocked_single_chip's")
    expect = {"xcorr_hits": 1, "attempt_manchester": 1, "attempt_4b5b": 0, "spec_walk": turns,
              "normalized_xcorr_dense": 0}
    require(got == expect, f"blocked_600s over {MESH_SHARDS} shards: launches {got}, "
            f"expected {expect}")
    log(f"phase 2 (mesh, blocked_600s): decode_blocked_sharded of {xb.shape[0]} samples over "
        f"{MESH_SHARDS} shards took {wall * 1e3:.1f} ms (first call), every shard ok, "
        f"{turns} fixpoint turn(s), launches {got}; the {len(frames_b)} frames, their starts "
        "and payloads, equal to decode_blocked_single_chip's")
    res_x, got_x, wall_x = counted(lambda: stream.decode_blocked_sharded(
        cfg, xb, LOCAL_ADDR, m4, n_cand=N_CAND, use_spec=False))
    require(frame_set(res_x) == want_b, "blocked_600s over the exact route: frames differ")
    log(f"phase 2 (mesh, blocked_600s, use_spec=False): the exact route took "
        f"{wall_x * 1e3:.1f} ms, launches {got_x}; the same {len(frames_b)} frames")
    if n_cards > 1:
        cards = mesh_mod.make_mesh(sp=n_cards)
        res_c, got_c, wall_c = counted(lambda: stream.decode_blocked_sharded(
            cfg, xb, LOCAL_ADDR, cards, n_cand=N_CAND))
        require(frame_set(res_c) == want_b, f"blocked_600s over {n_cards} cards: frames differ")
        log(f"phase 2 (mesh, blocked_600s over {n_cards} cards {cards.flat}): took "
            f"{wall_c * 1e3:.1f} ms, launches {got_c}; the same {len(frames_b)} frames")

    for name, (coding, wave, (dp, sp)) in sharded_inputs().items():
        c = PhyConfig(line_coding=coding)
        m8 = mesh_mod.make_mesh(dp=dp, sp=sp, devices=[dev] * 8)
        xw = torch.from_numpy(wave).to(dev)
        _, ok, turns = stream.sharded_spec_run(c, xw, LOCAL_ADDR, m8, SEAM_SHARD_MFPB, N_CAND)
        require(bool(ok.all()), f"{name}: the speculative route is not ok")
        for use_spec in (True, False):
            res, got, _ = counted(lambda: stream.decode_blocked_sharded(
                c, xw, LOCAL_ADDR, m8, SEAM_SHARD_MFPB, N_CAND, use_spec=use_spec))
            pairs = mesh_frames(res)
            require(pairs == SHARDED_EXPECT[name], f"{name} (use_spec={use_spec}): {pairs}, "
                    f"the JAX package's {SHARDED_EXPECT[name]}")
            require(all(q != 99 for _, q in pairs), f"{name}: the embedded frame decoded")
            log(f"phase 2 (mesh, {name}): decode_blocked_sharded over ({dp}, {sp}) "
                f"use_spec={use_spec}: {pairs} == SHARDED_EXPECT, sequence 99 decoded 0 times"
                + (f", {turns} fixpoint turn(s)" if use_spec else "") + f"; launches {got}")

    res, got, wall = counted(lambda: mesh_mod.batch_sharded_decode(
        cfg, x, LOCAL_ADDR, mdp, max_frames=MAX_FRAMES))
    whole = decoder_mod.decode_capture_fast(cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES)
    require(all(torch.equal(p, q) for p, q in zip(res, whole)),
            "batch_sharded_decode differs from decode_capture_fast on the whole batch")
    for r in range(x.shape[0]):
        require([f.data for f in res.to_frames(r)] == [f.data for f in frames],
                f"batch_sharded_decode: row {r}'s payloads differ from the flagship's")
    log(f"phase 2 (mesh, flagship): batch_sharded_decode of {x.shape[0]} x {x.shape[1]} over "
        f"dp={MESH_SHARDS} took {wall * 1e3:.1f} ms (first call), launches {got}; every row "
        f"equals decode_capture_fast's on the whole batch and the flagship's {N_FRAMES} payloads")

    ofdm_in = {}
    for tag, adaptive in (("ofdm_v2", False), ("ofdm_adaptive_loaded", True)):
        modem, fr, st, wave = ofdm_shard_input(adaptive)
        xo = torch.from_numpy(wave).to(dev)
        fb_len = len(fr[0].to_bytes())
        got_f, got, wall = counted(lambda: ofdm_stream.decode_ofdm_blocked_sharded(
            modem.cfg, xo, fb_len, m4))
        single = ofdm_stream.decode_ofdm_blocked_sharded(
            modem.cfg, xo, fb_len, mesh_mod.make_mesh(devices=[dev]), len(fr) + 8)
        require([f.data for f in got_f] == [f.data for f in fr],
                f"decode_ofdm_blocked_sharded ({tag}): {len(got_f)} of {len(fr)} payloads in order")
        require([f.to_bytes() for f in got_f] == [f.to_bytes() for f in single],
                f"decode_ofdm_blocked_sharded ({tag}) differs from the single-device pass")
        block = -(-len(wave) // MESH_SHARDS)
        flen = len(modem.encode_frames([fr[0]]))
        across = [p for p in st if p % block + flen > block]
        require(len(across) > 0, f"{tag}: no frame across a seam")
        require(got["normalized_xcorr_dense"] == 1, f"{tag}: launches {got}")
        log(f"phase 2 (mesh, {tag}): decode_ofdm_blocked_sharded of {len(wave)} samples over "
            f"{MESH_SHARDS} shards took {wall * 1e3:.1f} ms (first call), launches {got}; the "
            f"{len(fr)} payloads in capture order, the {len(across)} frames across seams "
            f"(at {across}) each once, equal to the single-device pass")
        ofdm_in[tag] = (modem.cfg, xo, fb_len, len(fr))

    frames_o, x_opt, vl = optimistic_input()
    cfg_o = PhyConfig(line_coding="4b5b", samples_per_level=OPT_SPL)
    xt = torch.from_numpy(x_opt).to(dev)
    rows, got, wall = counted(lambda: [decoder_mod.decode_capture(
        cfg_o, xt[r], LOCAL_ADDR, OPT_MAX_FRAMES, valid_len=int(vl[r]), optimistic=True)
        for r in range(OPT_ROWS)])
    fast, got_f, wall_f = counted(lambda: decoder_mod.decode_capture_fast(
        cfg_o, xt, LOCAL_ADDR, OPT_MAX_FRAMES, valid_len=vl.tolist()))
    conformant = [ok for _, ok in rows]
    opt = {name: torch.stack([getattr(r, name) for r, _ in rows]).cpu().numpy()
           for name in DIGEST_FIELDS}
    fast_np = {name: getattr(fast, name).cpu().numpy() for name in DIGEST_FIELDS}
    got_digest = optimistic_digest(conformant, opt, fast_np)
    require(got_digest == OPTIMISTIC_EXPECT,
            f"the optimistic batch's digest {got_digest}, the JAX package's {OPTIMISTIC_EXPECT}")
    broken = [r for r, ok in enumerate(conformant) if not ok]
    require(broken == list(OPT_BROKEN_ROWS), f"rows {broken} not conformant")
    for r in range(OPT_ROWS):
        exact = decoder_mod.decode_capture(cfg_o, xt[r], LOCAL_ADDR, OPT_MAX_FRAMES,
                                           valid_len=int(vl[r]))
        require(all(torch.equal(p[r], q) for p, q in zip(fast, exact)),
                f"the optimistic batch's row {r} differs from the exact scan")
        if r not in broken:
            require([f.data for f in fast.to_frames(r)] == [f.data for f in frames_o],
                    f"the optimistic batch's row {r}: payloads differ")
    log(f"phase 2 (mesh, optimistic): decode_capture(optimistic=True) of {OPT_ROWS} rows of "
        f"{x_opt.shape[1]} samples (4B5B, samples_per_level={OPT_SPL}) took {wall * 1e3:.1f} ms, "
        f"launches {got}; rows {broken} not conformant; decode_capture_fast took "
        f"{wall_f * 1e3:.1f} ms, launches {got_f}, every row equal to the exact scan; digest "
        f"{got_digest} == OPTIMISTIC_EXPECT")
    from trackmaker_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    dry, got, wall = counted(lambda: dryrun_multichip(8, [dev] * 8))
    log(f"phase 2 (mesh, dryrun_multichip): the four checks of __graft_entry__.py's dry run "
        f"over 8 x {dev} took {wall * 1e3:.1f} ms: mesh {dry['mesh']}, blocked counts "
        f"{dry['counts']}, dp counts {dry['dp_counts']}, {dry['ofdm_frames']} OFDM frames, "
        f"evil-seam frames {dry['evil_seam']}; launches {got}")
    return total, dict(m4=m4, mdp=mdp, ofdm=ofdm_in, opt=(cfg_o, xt, vl))


def run_multiprocess(torch, frames, seed: int) -> dict[str, int]:
    """phase 2 (mesh, multi-process): MP_PROCS processes of
    tools/multihost_dryrun.py on the card over gloo, MP_ROWS of the
    flagship's rows each; each must exit 0 within MP_TIMEOUT_S with every
    row's payloads the flagship's, else both are killed and the run fails.
    Returns the kernels' launches the processes report."""
    import socket
    import subprocess
    import tempfile

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        # each process writes to files, not pipes: a process blocked on a
        # full pipe would never reach the barrier the other waits at
        files = [(open(os.path.join(tmp, f"{pid}.out"), "w+"),
                  open(os.path.join(tmp, f"{pid}.err"), "w+")) for pid in range(MP_PROCS)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "trackmaker_tpu_torch.tools.multihost_dryrun",
             f"127.0.0.1:{port}", str(MP_PROCS), str(pid), "--flagship", str(MP_ROWS),
             "--seed", str(seed)], cwd=root, stdout=out, stderr=err, text=True)
            for pid, (out, err) in enumerate(files)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, MP_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            require(False, f"the multi-process dry run did not end within {MP_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        outs = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
            out.close()
            err.close()
    launches: dict[str, int] = {}
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"dry-run process {pid} exited {p.returncode}: {err[-2000:]}")
        got = json.loads(out.strip().splitlines()[-1])
        rows = [[bytes.fromhex(h) for _, _, h in row] for row in got["frames"]]
        require(got["ok"] and len(rows) == MP_ROWS
                and all(row == [f.data for f in frames] for row in rows),
                f"dry-run process {pid}: payloads differ from the flagship's")
        for k_name, n in got["launches"].items():
            launches[k_name] = launches.get(k_name, 0) + n
        log(f"phase 2 (mesh, multi-process): process {pid} of {MP_PROCS} on {got['devices']} "
            f"over gloo: exit 0, rows {pid * MP_ROWS}-{(pid + 1) * MP_ROWS - 1} of the flagship, "
            f"every row's {N_FRAMES} payloads the flagship's; launches {got['launches']}")
    log(f"phase 2 (mesh, multi-process): both processes done in {wall:.1f} s (limit "
        f"{MP_TIMEOUT_S} s)")
    return launches


def time_mesh_paths(torch, stream, mesh_mod, ofdm_stream, decoder_mod, cfg, xb, x, mesh_in,
                    card) -> None:
    """Phase 4 of the mesh paths: each call beside its one-device
    counterpart, CUDA events (median of RUNS), with its peak memory."""
    m4, mdp = mesh_in["m4"], mesh_in["mdp"]
    one = mesh_mod.make_mesh(devices=[x.device])
    cfg_o, xt, vl = mesh_in["opt"]
    calls = {
        f"decode_blocked_sharded blocked_600s ({MESH_SHARDS} shards)": (lambda: (
            stream.decode_blocked_sharded(cfg, xb, LOCAL_ADDR, m4, n_cand=N_CAND)), True),
        f"decode_blocked_single_chip blocked_600s ({BLOCKED_BLOCKS} blocks)": (lambda: (
            stream.decode_blocked_single_chip(cfg, xb, LOCAL_ADDR, BLOCKED_BLOCKS, BLOCKED_MFPB,
                                              N_CAND)), True),
        f"batch_sharded_decode flagship (dp={MESH_SHARDS})": (lambda: (
            mesh_mod.batch_sharded_decode(cfg, x, LOCAL_ADDR, mdp, max_frames=MAX_FRAMES)), False),
        "decode_capture_fast flagship": (lambda: decoder_mod.decode_capture_fast(
            cfg, x, LOCAL_ADDR, max_frames=MAX_FRAMES), False),
        f"optimistic batch: decode_capture_fast ({OPT_ROWS} rows, 4B5B spl={OPT_SPL})": (
            lambda: decoder_mod.decode_capture_fast(cfg_o, xt, LOCAL_ADDR, OPT_MAX_FRAMES,
                                                    valid_len=vl.tolist()), False),
        f"optimistic batch: decode_capture(optimistic=True), {OPT_ROWS} rows": (lambda: [
            decoder_mod.decode_capture(cfg_o, xt[r], LOCAL_ADDR, OPT_MAX_FRAMES,
                                       valid_len=int(vl[r]), optimistic=True)
            for r in range(OPT_ROWS)], False),
        f"optimistic batch: the exact scan of the same {OPT_ROWS} rows": (
            lambda: decoder_mod.decode_captures(cfg_o, xt, LOCAL_ADDR, OPT_MAX_FRAMES,
                                                vl.tolist()), False),
    }
    for tag, (cfg_x, xo, fb_len, n_frames) in mesh_in["ofdm"].items():
        calls[f"decode_ofdm_blocked_sharded {tag} ({MESH_SHARDS} shards)"] = (
            lambda c=cfg_x, xo=xo, n=fb_len: ofdm_stream.decode_ofdm_blocked_sharded(
                c, xo, n, m4), False)
        calls[f"decode_ofdm_blocked_sharded {tag} (one shard: the single-device pass)"] = (
            lambda c=cfg_x, xo=xo, n=fb_len, k=n_frames: ofdm_stream.decode_ofdm_blocked_sharded(
                c, xo, n, one, k + 8), False)
    for what, (fn, realtime) in calls.items():
        # the optimistic batch's scans are host loops of a third of a second
        runs = OPT_RUNS if what.startswith("optimistic") else RUNS
        med = time_ms(torch, fn, runs=runs)
        rt = (f", {xb.shape[0] / cfg.sample_rate / (med / 1e3):.1f}x real time"
              if realtime else "")
        log(f"phase 4: {what}: {med:.4f} ms (median of {runs}){rt}; peak memory "
            f"{peak_memory(torch, fn)} [{card}]")


def check_mesh_inputs(torch, sd, stream, mesh_mod, xn, ofdm, ofdm_stream, xcorr_hits,
                      xcorr_hits_plain, cfg, xb, mesh_in, dev) -> tuple[float, float]:
    """Phase 1 on phase 2 (mesh)'s own inputs: #1, #3 (#5) and #4 on the
    sharded windows of blocked_600s and of the seam scenarios and at their
    fixpoints' cursors (check_sharded), #1 on the optimistic batch, and #2's
    normalized form on the sharded OFDM windows.  Returns (#1's, #2's max
    |err|)."""
    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform

    err = check_sharded(torch, sd, stream, xcorr_hits, xcorr_hits_plain, cfg, xb, mesh_in["m4"],
                        32, f"blocked_600s over {MESH_SHARDS} shards")
    for name, (coding, wave, (dp, sp)) in sharded_inputs().items():
        err = max(err, check_sharded(
            torch, sd, stream, xcorr_hits, xcorr_hits_plain, PhyConfig(line_coding=coding),
            torch.from_numpy(wave).to(dev), mesh_mod.make_mesh(dp=dp, sp=sp, devices=[dev] * 8),
            SEAM_SHARD_MFPB, name))
    cfg_o, xt, _ = mesh_in["opt"]
    err = max(err, check_xcorr(torch, xcorr_hits, xcorr_hits_plain, xt, preamble_waveform(cfg_o),
                               cfg_o.correlation_threshold, "optimistic batch")[0])
    windows = []
    for cfg_x, xo, fb_len, _ in mesh_in["ofdm"].values():
        sw = stream.shard_windows(xo, mesh_in["m4"], ofdm_stream.ofdm_halo_size(cfg_x, fb_len * 8))
        windows += [(wins, 16) for _, wins in sw.groups.values()]
    return err, check_ofdm_corr(torch, xn, ofdm, windows, "sharded OFDM windows")


def shared_bound(sd, cfg, k_name: str, info: dict) -> tuple[float, str]:
    """The least time of a shared-capture attempt: the samples its live
    candidates need (at most the whole capture) and its small inputs read,
    its outputs written; the refine taps (legacy forms) and the decode's
    operations of each live candidate."""
    slots = info["vlens"].numel() * N_CAND
    fold = "_fold" in k_name
    if cfg.line_coding == "manchester":
        body, out_per_slot = sd.FRAME_BYTES * 8 * sd.BIT_SAMPLES, sd.FRAME_BYTES + 4
        refine, decode_ops = (13 + 47, 13 * 48 * 4), sd.FRAME_BYTES * 8 * 6
    else:
        body, out_per_slot = sd.ZERO_SYMBOLS * sd.SYMBOL_SAMPLES, sd.FRAME_BYTES + 12
        refine, decode_ops = (31 + 29, 31 * 30 * 4), sd.ZERO_SYMBOLS * 5 * 4
    window = body + (0 if fold else refine[0])
    reads = min(info["xf"].numel(), info["live"] * window) * 4
    small = slots * 4 + info["vlens"].numel() * 4 * (1 if fold else 2)
    return bound(reads + small + slots * out_per_slot,
                 info["live"] * (decode_ops + (0 if fold else refine[1])))


def check_tools(torch, hp, exs, pf, sd, xh, xn, cfg, x, vlens, corr_p, tool) -> dict:
    """Phase 1 for the tools' kernels: the probe against its plain version
    (exact); the two-stream rows against their plain version and, bit for
    bit, against kernel #1's rows, and the noep form against its plain
    version and, bit for bit, against the truncation of kernel #1's dense
    corr, on the flagship captures and on the tool's noise corpus; the
    attempt-only stage, fold off and on, against the plain attempts on its
    compacted candidates.  Returns the max |err| per kernel."""
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync.correlate import preamble_energy

    xk = torch.from_numpy(np.random.default_rng(5).normal(0, 100, (8, 128)).astype(np.float32))
    xk = xk.to(x.device)
    got = hp.seq_probe(xk)
    torch.cuda.synchronize()
    want = hp.seq_probe_plain(xk)
    require(torch.equal(got, want), "seq_probe differs from its plain version")
    errs = {"seq_probe": (got - want).abs().max().item(), "xcorr_hits_2s": 0.0}
    log("phase 1: seq_probe == plain (128 blocks x 64 threads, 128 float4 stores of x + c into "
        "shared memory a thread, then x + 127 written once)")
    pre = preamble_waveform(cfg)
    xt, pat_t = tool
    for tag, xx, pattern, thr, cp in (
            ("flagship", x, pre, cfg.correlation_threshold, corr_p),
            ("the tool's noise", xt, pat_t, exs.THR, xn.normalized_xcorr_dense_plain(xt, pat_t))):
        rows = exs.xcorr_hits_2s(xx, pattern, thr)
        torch.cuda.synchronize()
        require(torch.equal(rows, xh.xcorr_hits(xx, pattern, thr)[1]),
                f"xcorr_hits_2s ({tag}) rows differ from kernel #1's")
        val_err, n_near, n_diff = compare_rows(torch, rows, exs.xcorr_hits_2s_plain(
            xx, pattern, thr), cp, thr, f"xcorr_hits_2s ({tag})")
        errs["xcorr_hits_2s"] = max(errs["xcorr_hits_2s"], val_err)
        noep = exs.xcorr_hits_2s(xx, pattern, thr, epilogue=False)
        torch.cuda.synchronize()
        edge = exs.noep_plain(((cp.abs() - 1.0).abs() < CORR_ATOL).float(), rows.shape[1]) > 0
        require(bool(((noep == exs.xcorr_hits_2s_plain(xx, pattern, thr, epilogue=False))
                      | edge).all()), f"xcorr_hits_2s noep ({tag}) differs from its plain version")
        dense, _ = xh.xcorr_hits(xx, pattern, thr, emit_corr=True)
        require(torch.equal(noep, exs.noep_plain(dense, rows.shape[1])),
                f"xcorr_hits_2s noep ({tag}) differs from the truncation of kernel #1's corr")
        log(f"phase 1: xcorr_hits_2s == kernel #1's rows bit for bit and == plain on {tag} "
            f"({xx.shape[0]} x {xx.shape[1]}, L={len(pattern)}, threshold {thr}: "
            f"{int(rows[..., 4].sum())} hits, hit corr {val_err:.3g}, {n_near} lags near the "
            f"threshold, {n_diff} rows differing there); noep == plain and == int(kernel #1's "
            f"corr) bit for bit ({int((noep != 0).sum())} nonzero lanes)")
    # exact +-1 copies of the preamble's first 64 samples in silence
    # correlate to +-1 (integer sums, and sqrt(64) is exact in f32, so the
    # division gives exactly +-1): the noep form's nonzero lanes
    pre64 = pre[:64]
    xe = torch.zeros((2, 40_000), dtype=torch.float32, device=x.device)
    pre_t = torch.from_numpy(pre64).to(x.device)
    copies = [(0, 128 * 3 + 2, 1.0), (0, 128 * 100 + 15, -1.0), (1, 128 * 7, 1.0)]
    for r, lag, sign in copies:
        xe[r, lag:lag + len(pre64)] = sign * pre_t
    noep = exs.xcorr_hits_2s(xe, pre64, cfg.correlation_threshold, epilogue=False)
    torch.cuda.synchronize()
    dense, _ = xh.xcorr_hits(xe, pre64, cfg.correlation_threshold, emit_corr=True)
    require(torch.equal(noep, exs.noep_plain(dense, noep.shape[1])),
            "xcorr_hits_2s noep (exact copies) differs from the truncation of kernel #1's corr")
    require([int(noep[r, lag // 128, lag % 128]) for r, lag, _ in copies]
            == [int(sg) for _, _, sg in copies] and int((noep != 0).sum()) == len(copies),
            "xcorr_hits_2s noep (exact copies): the +-1 lanes are not where the copies are")
    log(f"phase 1: xcorr_hits_2s noep on {len(copies)} exact +-1 copies of the preamble's first "
        "64 samples in silence == "
        "int(kernel #1's corr) bit for bit, +-1 at each copy's lane and 0 elsewhere")
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    thr = cfg.correlation_threshold
    legacy = pf.attempt_sum(cfg, x, vlens, False)
    fold = pf.attempt_sum(cfg, x, vlens, True)
    torch.cuda.synchronize()
    cand, _, n_valid, _ = sd.compact_hit_rows(xh.xcorr_hits(x, pre, thr)[1], N_CAND)
    _, _, _, _, fs = sd.compact_hit_rows(xh.xcorr_hits_refine(x, vlens, pre, sync, thr,
                                                              **refine_kw(cfg)),
                                         N_CAND, with_fs=True)
    for got, want, what in (
            (legacy, sd.attempt_manchester_plain(x, cand, n_valid, vlens, sync,
                                                 preamble_energy(sync)), "fold off"),
            (fold, sd.attempt_manchester_fold_plain(x, fs, n_valid), "fold on"),
            (fold, legacy, "fold on against fold off")):
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"attempt_sum ({what}) differs from the plain attempt")
    errs["attempt_sum"] = 0
    log(f"phase 1: attempt_sum == the plain attempts on its {int(n_valid.sum())} compacted "
        "candidates, fold off and on, and the two equal")
    return errs


def run_profiler_path(torch, pf, exs, cfg, x, frames, vlens, tool, kernels) -> dict[str, int]:
    """The profiler path: every stage of ``prof_fused.stages`` on the
    flagship captures, the full-decode stage through the payload gate; the
    attempt-only stage fold off and on, each call launching one
    correlation entry, one attempt and no walk; the two-stream experiment's
    row check.  Returns the launches of `kernels` (name -> wrapper)."""
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = {name: fn(x) for name, fn in pf.stages(cfg, x, vlens).items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res, ok = outs["full spec decode"]
    require(bool(ok.all()), "a row of the profiler's full-decode stage is not ok")
    counts = res.count.cpu().numpy()
    require(bool((counts == N_FRAMES).all()),
            f"the profiler's full-decode count gate failed: {sorted(set(counts.tolist()))}")
    fb, valid = res.frame_bytes.cpu().numpy(), res.valid.cpu().numpy()
    for r in range(x.shape[0]):
        for k, f in zip(np.nonzero(valid[r])[0], frames):
            require(fb[r, k, 7:7 + PAYLOAD].tobytes() == f.data,
                    f"the profiler's full-decode payload gate failed at row {r} slot {k}")
    for fold in (False, True):
        before = {n: k.launches for n, k in kernels.items()}
        pf.attempt_sum(cfg, x, vlens, fold)
        torch.cuda.synchronize()
        delta = {n: k.launches - before[n] for n, k in kernels.items() if n != "xcorr_hits_2s"}
        expect = {"xcorr_hits": int(not fold), "xcorr_hits_refine": int(fold),
                  "attempt_manchester": int(not fold), "attempt_manchester_fold": int(fold),
                  "spec_walk": 0}
        require(delta == expect, f"attempt_sum (fold {fold}) launched {delta}, expected {expect}")
    exs.check_streams(*tool, exs.THR)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    for k_name, n in launches.items():
        require(n > 0, f"the profiler path never launched {k_name}")
    log(f"phase 2 (profiler): {len(outs)} stages of prof_fused.stages took {wall * 1e3:.1f} ms "
        f"(first calls); full-decode payload gate passed ({x.shape[0]} rows x {N_FRAMES} frames), "
        "every row ok; attempt_sum fold off and on each launched one correlation entry, one "
        f"attempt and no walk; exp_xcorr_streams' 2stream rows == current; launches {launches}")
    return launches


def empty_kernel(torch, dev):
    """An empty kernel's launcher, (blocks, threads) -> None, built from
    ``tools/exp_walk_attempt.py``'s source: the floor a tiny kernel's device
    time is read against."""
    import ctypes

    from trackmaker_tpu_torch import _build
    from trackmaker_tpu_torch.tools.exp_walk_attempt import EMPTY_SOURCE, build_source

    fn = ctypes.CDLL(str(build_source("empty", EMPTY_SOURCE))).tm_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    return lambda blocks, threads: _build.check(fn(blocks, threads, stream), "empty")


def tiles_bound(et, variant: str, inputs, bf16_rate: bool = True) -> tuple[float, str]:
    """(least ms, what sets it) of one attempt-tile call on `inputs`: the
    output written once (zero-filled), the rows of x each candidate reads,
    the table rows this run's candidates read (sync slices from q, body
    slices from the sync's best), each once, and w; every multiply-add of
    the sync, the body and the pack, the body's at the bf16 tensor-core
    rate for bf16b (with `bf16_rate`; else at the f32 rate, the function
    as the port defines it: its sums stay on the FP32 pipes) and all
    others at the f32 rate."""
    spec = et.parse_variant(variant)
    x, ts, tsc, tb, tbn, w, wn = inputs
    b, n = x.shape[0], spec.n_cand
    out_bytes = b * et.NV * et.BROWS * et.LANES * 4
    if spec.kind == "noop":          # x01[0, 0:8] of the 8 slabs, an add each
        return bound(b * 8 * 8 * 4 + out_bytes, b * n * 8)
    best = et.sync_plain(spec, x, ts, tsc)[3].cpu().numpy()
    c = np.arange(n)
    q = 37 * c % et.DROW
    o2 = (53 * c + best) % et.DROW                     # [b, n]
    rows = {}                                          # table -> rows read, as v * 768 + row
    for table, starts in ((tsc if spec.merged else ts, q), (tbn if spec.n128 else tb, o2)):
        key = (table.data_ptr(), table.shape[-1])
        first = (starts % 8) * et.TROWS + starts - starts % 8
        rows.setdefault(key, set()).update(np.unique(first.reshape(-1)[:, None]
                                                     + np.arange(et.DROW)).tolist())
    table_bytes = sum(len(r) * width * 4 for (_, width), r in rows.items())
    half, bits = (64, 64) if spec.n128 else (128, 128)
    body = 2 * et.BROWS * half * et.DROW * 2 * b * n                 # flops
    rest = (et.BROWS * et.LANES * bits + et.SYNC_LANES * 4 * et.DROW) * 2 * b * n
    x_bytes = b * (9 * 7 + et.SLAB_ROWS) * et.DROW * 4
    by_bytes = (out_bytes + x_bytes + table_bytes + (wn if spec.n128 else w).numel() * 4) \
        / HBM_BYTES_PER_S * 1e3
    by_ops = (body / (BF16_OPS_PER_S if spec.kind == "bf16b" and bf16_rate else F32_OPS_PER_S)
              + rest / F32_OPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def probe_bound() -> tuple[float, str]:
    """(least ms, what sets it) of the window probe: x f32[8, 128] read
    once, the f32[256, 128] output written once, 128 adds an element.
    Whatever implements it; the stores it stages on chip are not counted."""
    return bound(8 * 128 * 4 + 256 * 128 * 4, 128 * 256 * 128)


def offset_bound(form: str) -> tuple[float, str]:
    """(least ms, what sets it) of one offset-add form: the rows of x and
    the columns of t it reads, the output, and its multiply-adds."""
    x_rows, t_cols, sums = {"A": (33, 256, 32 * 128 * 768), "B": (2, 256, 128 * 768),
                            "C": (33, 128, 32 * 128 * 384)}[form]
    return bound((x_rows * 384 + 384 * t_cols + 32 * 128) * 4, 2 * sums)


def check_threshold_tie(torch, xh, decode_capture_fast, decode_capture, cfg4, pre4, dev) -> None:
    """The 4B5B preamble's first n samples before a frame, on the card: lag
    0 correlates to 54/60 = 0.9 in exact arithmetic and, dividing as the
    reference does, to 0.8999999 in f32.  Kernel #1's corr at lag 0 must
    equal the plain version's bit for bit, below the threshold, and the
    fast decode and the exact scan must find the frame at n."""
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    wave = PhyEncoder(cfg4, device=dev).encode_frames([Frame.new_data(5, 1, 2, b"hello")],
                                                      gap_samples=0)
    thr = cfg4.correlation_threshold
    for n in (39, 48, 57):
        x = torch.cat([torch.from_numpy(pre4[:n]).to(dev), wave])[None].contiguous()
        corr, _ = xh.xcorr_hits(x, pre4, thr, emit_corr=True)
        torch.cuda.synchronize()
        corr_p, _ = xh.xcorr_hits_plain(x, pre4, thr, emit_corr=True)
        c0, p0 = corr[0, 0].item(), corr_p[0, 0].item()
        require(c0 == p0 and c0 < thr and abs(c0 - thr) < 1e-6,
                f"threshold tie (n={n}): corr at lag 0 {c0!r}, plain {p0!r}")
        for res in (decode_capture_fast(cfg4, x, LOCAL_ADDR, max_frames=4),
                    decode_capture(cfg4, x[0], LOCAL_ADDR, 4)):
            valid = res.valid.reshape(-1)
            require(int(valid.sum()) == 1 and int(res.start.reshape(-1)[valid].item()) == n,
                    f"threshold tie (n={n}): the frame at {n} was not found alone")
    log(f"phase 1: threshold tie (4B5B preamble's first 39/48/57 samples before a frame): "
        f"kernel #1's corr at lag 0 == plain bit for bit ({c0!r} < {thr}), decode_capture_fast "
        "and the exact scan find the frame at its start")


TILE_CHECKS = ("noop", "base", "n128", "sync1", "both", "bf16b", "base_nodma", "base_nostore",
               "base_u5")


def check_experiments(torch, et, eo, dev) -> tuple[dict, dict]:
    """Phase 1 for the two experiments' kernels: every attempt-tile variant,
    and base's _nodma, _nostore and _u5, against the plain version on the
    tool's corpus and on an integer-valued copy (x of integers -2..2), bit
    for bit both (the products are exact and both sum in k order), at
    rings of 1 to 4 stages; a ring that does not fit refused; the three
    offset-add forms against their plain versions and the NumPy oracles,
    bit for bit.  Returns (max |err| per kernel, the inputs phase 4 times
    them on)."""
    errs = {"attempt_tiles": 0.0, "offset_add": 0.0}
    corpora = {"normal": et.tool_input(dev), "integer": et.tool_input(dev, integer=True)}
    for tag, inputs in corpora.items():
        for variant in TILE_CHECKS:
            want = et.attempt_tiles_plain(variant, *inputs)
            for pipe in range(1, et.PIPE + 1):
                got = et.attempt_tiles(variant, *inputs, pipe=pipe)
                torch.cuda.synchronize()
                n_diff = int((got != want).sum())
                errs["attempt_tiles"] = max(errs["attempt_tiles"], (got - want).abs().max().item())
                require(n_diff == 0, f"attempt_tiles {variant} ({tag} corpus, ring {pipe}): "
                        f"{n_diff} values differ from the plain version")
                require(bool(torch.isfinite(got).all()), f"attempt_tiles {variant}: not finite")
        log(f"phase 1: attempt_tiles == plain bit for bit on the tool's {tag} corpus "
            f"({inputs[0].shape[0]} x {et.NV} candidates) for {', '.join(TILE_CHECKS)}, each at "
            f"rings of 1 to {et.PIPE} stages")
    launches = et.attempt_tiles.launches
    try:
        et.attempt_tiles("base", *corpora["normal"], pipe=5)
        refused = False
    except ValueError:
        refused = True
    require(refused and et.attempt_tiles.launches == launches,
            "attempt_tiles took a ring of 5 stages, which does not fit a block")
    log(f"phase 1: attempt_tiles refuses a ring of 5 stages ({5 * et.STAGE_BYTES} B), runs 4 "
        f"({et.stage_smem(et.parse_variant('base'), 4)} B of the {et.SMEM_PER_BLOCK} each of "
        f"{et.BLOCKS_PER_SM} blocks an SM may use)")
    x, t = eo.tool_input(dev)
    for form in eo.FORMS:
        got = eo.offset_add(form, x, t)
        torch.cuda.synchronize()
        require(torch.equal(got, eo.offset_add_plain(form, x, t)),
                f"offset_add {form} differs from its plain version")
        max_abs, max_rel = eo.errors(form, got, x, t)
        errs["offset_add"] = max(errs["offset_add"], max_abs)
        require(max_abs == 0.0, f"offset_add {form} differs from its oracle by {max_abs}")
    log(f"phase 1: offset_add A, B, C == plain and == the NumPy oracles bit for bit "
        f"(lane shift {eo.lane_shift(x)} from a sum of {int(x[0, :8].sum())})")
    return errs, {"tiles": corpora["normal"], "offset": (x, t)}


def check_tiles_streams_edges(torch, et, exs, xh, dev) -> None:
    """The attempt tiles and the two-stream rows on the edge inputs of
    tests/test_torch_tiles_streams_design.py: the tiles' edge variants
    (_u1, _u2, _u5, _u13, _u65, _nostore, noop, _nodma and the other kinds)
    at rings of 1 to 4 on two captures of the normal corpus, bit for bit;
    the streams at L in 2..129 and T in 129..50,001 around the tile of
    1,024 lags, the second stream's 128 samples and the 8 zero-filled past
    them, with a hit at the last lag: the rows and the noep form equal
    kernel #1's bit for bit (L <= 128) and the plain version's away from
    the threshold and from |corr| = 1."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_tiles_streams_design as edges

    inputs = edges.tile_edge_input(dev)
    for variant in edges.TILE_EDGE_VARIANTS:
        want = et.attempt_tiles_plain(variant, *inputs)
        for pipe in edges.TILE_RINGS:
            got = et.attempt_tiles(variant, *inputs, pipe=pipe)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"attempt_tiles {variant} differs on the edge input "
                                            f"at ring {pipe}")
    n_hits = 0
    for l in edges.STREAM_LS:
        for t in edges.STREAM_TS:
            x, pattern = edges.stream_edge_input(l, t, dev)
            rows = exs.xcorr_hits_2s(x, pattern, edges.STREAM_THR)
            noep = exs.xcorr_hits_2s(x, pattern, edges.STREAM_THR, epilogue=False)
            torch.cuda.synchronize()
            if l <= 128:
                corr, rows_1 = xh.xcorr_hits(x, pattern, edges.STREAM_THR, emit_corr=True)
                require(torch.equal(rows, rows_1) and torch.equal(
                    noep, exs.noep_plain(corr, noep.shape[1])),
                    f"xcorr_hits_2s differs from kernel #1 at L={l}, T={t}")
            corr_p = exs.normalized_xcorr_dense_plain(x, pattern)
            try:
                edges.assert_rows_agree(rows.cpu(), exs.xcorr_hits_2s_plain(
                    x, pattern, edges.STREAM_THR).cpu(), corr_p.cpu(), edges.STREAM_THR)
            except AssertionError as exc:
                raise AssertionError(f"xcorr_hits_2s differs from plain at L={l}, T={t}") from exc
            edge = exs.noep_plain(((corr_p.abs() - 1.0).abs() < CORR_ATOL).float(),
                                  noep.shape[1]) > 0
            require(bool(((noep == exs.xcorr_hits_2s_plain(x, pattern, edges.STREAM_THR, False))
                          | edge).all()), f"xcorr_hits_2s noep differs from plain at L={l}, T={t}")
            require(int(rows[0, (t - l) // 128, 4]) >= 1, f"no hit at the last lag, L={l} T={t}")
            n_hits += int(rows[..., 4].sum())
    log(f"phase 1: attempt_tiles == plain bit for bit on the edge input (2 captures) for "
        f"{', '.join(edges.TILE_EDGE_VARIANTS)} at rings {list(edges.TILE_RINGS)}; xcorr_hits_2s "
        f"== kernel #1's rows and noep bit for bit (L <= 128) and == plain at L in "
        f"{list(edges.STREAM_LS)}, T in {list(edges.STREAM_TS)} ({n_hits} hits, one at each "
        "last lag)")


def check_probe_offset_edges(torch, hp, eo, dev) -> None:
    """The window probe and the offset add on the edge inputs of
    tests/test_torch_probe_offset_design.py: the probe where x + c rounds
    (near 2^24, ties at 3 * 2^23, inf, NaN, -0.0), bit for bit as its plain
    version (NaN as NaN); the offset add's forms on N(0, 1) inputs, C also
    at the lane shifts 0, 63 and 59, within 2 * 768 * 2^-24 * sum |x_j t_jk|
    of a float64 product and epilogue."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import test_torch_probe_offset_design as edges

    for kind in edges.PROBE_EDGES:
        x = edges.probe_edge_input(kind, dev)
        got = hp.seq_probe(x)
        torch.cuda.synchronize()
        try:
            edges.assert_probe_equal(got.cpu().numpy(), hp.seq_probe_plain(x).cpu().numpy())
        except AssertionError as exc:
            raise AssertionError(f"seq_probe differs from plain on the {kind} input") from exc
    worst = 0.0
    for form, head in [(form, None) for form in eo.FORMS] + [
            ("C", h) for h, _ in edges.SHIFT_HEADS.values()]:
        x, t = edges.offset_random_input(7, head, dev)
        got = eo.offset_add(form, x, t)
        torch.cuda.synchronize()
        err = np.abs(got.cpu().numpy().astype(np.float64) - edges.reference64(form, x, t))
        bnd = edges.error_bound(form, x, t)
        require(bool(np.all(err <= bnd)), f"offset_add {form} (head {head}) is off the float64 "
                f"product by {err.max()}, past its bound")
        worst = max(worst, float((err / bnd).max()))
    log(f"phase 1: seq_probe == plain bit for bit on {', '.join(edges.PROBE_EDGES)} (NaN as "
        f"NaN); offset_add A, B, C on N(0, 1) inputs (C also at lane shifts 0, 63, 59) within "
        f"2 * 768 * 2^-24 * sum |x t| of float64, at most {worst:.4f} of it")


def run_experiments(torch, et, eo) -> dict[str, int]:
    """Phase 2 for the experiments: both tools' main(), the attempt tiles'
    over its default variants (5 calls a repeat), with the launch counts
    set to 0 just before and read just after."""
    et.attempt_tiles.launches = eo.offset_add.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    et.main(["5"])
    eo.main([])
    torch.cuda.synchronize()
    launches = {"attempt_tiles": et.attempt_tiles.launches, "offset_add": eo.offset_add.launches}
    require(launches == {"attempt_tiles": len(et.VARIANTS) * (1 + 3 * 5), "offset_add": 3},
            f"the experiments' main() launched {launches}")
    log(f"phase 2 (experiments): exp_attempt_tiles.main and exp_offset_add.main took "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches {launches}")
    return launches


def pcm16(rows: np.ndarray) -> np.ndarray:
    """The int16 PCM that io.write_wav writes for f32 rows: clamped to
    [-1, 1], times 32767, truncated."""
    return (np.clip(rows, -1.0, 1.0) * 32767.0).astype("<i2")


def _write_flac(job) -> dict:
    """Encode 16-bit PCM and write it to a FLAC file, job = (path, pcm);
    returns the subframe kinds (a process pool's task)."""
    path, pcm = job
    data, kinds = flac_encode(pcm)
    with open(path, "wb") as fh:
        fh.write(data)
    return kinds


def write_capture_files(io_mod, rows: np.ndarray, directory: str, stem: str):
    """(WAV paths, FLAC paths, each FLAC file's subframe kinds) of f32 rows
    [B, T] at CLI_GAIN: 16-bit WAV by the port's io.write_wav, FLAC by
    flac_encode of the same PCM, so that both load to the same samples.
    The FLAC files are encoded by a pool of up to 8 processes (spawned, and
    shut down on return): the encoder is NumPy passes over small arrays,
    which threads would serialize on the interpreter lock."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    rows = np.asarray(rows, np.float32) * np.float32(CLI_GAIN)
    wavs = [os.path.join(directory, f"{stem}{i:02d}.wav") for i in range(len(rows))]
    flacs = [path[:-4] + ".flac" for path in wavs]
    for path, r in zip(wavs, rows):
        io_mod.write_wav(path, r)
    workers = min(8, os.cpu_count() or 1, len(rows))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        kinds = list(pool.map(_write_flac, zip(flacs, pcm16(rows))))
    return wavs, flacs, kinds


def cli_call(cli_main, argv: list) -> tuple[int, str, float]:
    """(exit code, standard output, wall seconds) of one in-process call of
    the CLI's main(argv)."""
    import contextlib
    import io as stdio

    buf = stdio.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            cli_main(argv)
            code = 0
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    return code, buf.getvalue(), time.perf_counter() - t0


def listed_frames(text: str) -> dict[str, list[tuple[int, int, int, int]]]:
    """The frames that a multi-capture decode lists, by file:
    (seq, src, dst, len) from its `    seq= src= dst= len=` lines."""
    import re

    out, current = {}, None
    for line in text.splitlines():
        m = re.match(r"^  (\S.*): \d+ frames$", line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"^\s+seq=(\d+) src=(\d+) dst=(\d+) len=(\d+)$", line)
        if m and current is not None:
            current.append(tuple(int(v) for v in m.groups()))
    return out


def run_cli_decode(torch, cli_main, io_pkg, decoder_mod, cfg, paths, frames, kernels,
                   out_path: str, tag: str, card: str) -> dict:
    """One `decode <files> --addr 2 --output` call of the CLI on the card,
    with the kernels' counts set to 0 just before it and read just after.
    Gates: exit code 0; one decode_capture_fast call (one bucket) whose
    result equals a direct decode_capture_fast of the same loaded batch;
    the frames listed for each file equal that result's; every payload of
    `frames` in each file's frames and, in order, in the output file; no
    exact scan (every row ok); each kernel launched.  Returns the launches,
    the batch and its true lengths."""
    calls, exact_rows, load_s = [], [0], [0.0]
    real_fast, real_exact, real_load = (decoder_mod.decode_capture_fast,
                                        decoder_mod.decode_captures, io_pkg.load_audio)

    def timed_fast(c, x, addr, max_frames=64, valid_len=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = real_fast(c, x, addr, max_frames=max_frames, valid_len=valid_len)
        end.record()
        end.synchronize()
        calls.append((x, valid_len, max_frames, res, start.elapsed_time(end)))
        return res

    def counted_exact(c, x, *a, **kw):
        exact_rows[0] += x.shape[0]
        return real_exact(c, x, *a, **kw)

    def timed_load(path, mono=True):
        t0 = time.perf_counter()
        got = real_load(path, mono)
        load_s[0] += time.perf_counter() - t0
        return got

    argv = ["decode", *paths, "--addr", str(LOCAL_ADDR), "--output", out_path]
    if cfg.line_coding == "4b5b":
        argv += ["--encoding", "4b5b"]
    decoder_mod.decode_capture_fast, decoder_mod.decode_captures = timed_fast, counted_exact
    io_pkg.load_audio = timed_load
    try:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        code, text, wall = cli_call(cli_main, argv)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = {k.__name__: k.launches for k in kernels}
    finally:
        decoder_mod.decode_capture_fast, decoder_mod.decode_captures = real_fast, real_exact
        io_pkg.load_audio = real_load
    require(code == 0, f"{tag}: the CLI exited {code}:\n{text}")
    require(len(calls) == 1, f"{tag}: {len(calls)} decode_capture_fast calls, expected 1 bucket")
    x, vlens, max_frames, res, decode_ms = calls[0]
    require(x.is_cuda and x.shape[0] == len(paths), f"{tag}: the batch {tuple(x.shape)} "
            f"on {x.device}")
    direct = real_fast(cfg, x, LOCAL_ADDR, max_frames=max_frames, valid_len=vlens)
    require(all(torch.equal(p, q) for p, q in zip(res, direct)),
            f"{tag}: the CLI's decode differs from a direct decode_capture_fast of its batch")
    listed = listed_frames(text)
    want = [f.data for f in frames]
    payloads = b""
    for r, path in enumerate(paths):
        got = direct.to_frames(r)
        require(listed.get(path) == [(f.sequence, f.src, f.dst, len(f.data)) for f in got],
                f"{tag}: the frames listed for {path} differ from the direct decode's")
        require([f.data for f in got] == want, f"{tag}: {path} lost a payload "
                f"({len(got)} frames)")
        payloads += b"".join(want)
    with open(out_path, "rb") as fh:
        require(fh.read() == payloads, f"{tag}: the output file differs from the payloads")
    require(exact_rows[0] == 0, f"{tag}: {exact_rows[0]} rows fell to the exact scan")
    for k_name, n in launches.items():
        require(n > 0, f"{tag}: the CLI's decode never launched {k_name}")
    seconds = sum(vlens) / cfg.sample_rate
    log(f"phase 2 ({tag}): exit 0, {len(paths)} files of {max(vlens)} samples in one bucket of "
        f"{x.shape[1]}, every frame equal to a direct decode_capture_fast of the loaded batch, all "
        f"{len(paths)} x {len(want)} payloads in the output file, every row ok (no exact scan); "
        f"kernel launches {launches}")
    log(f"phase 2 ({tag}): load {load_s[0] * 1e3:.1f} ms ({len(paths)} files), decode "
        f"{decode_ms:.4f} ms (CUDA events around the bucket's decode_capture_fast, first call), "
        f"the whole command {wall * 1e3:.1f} ms of wall time for {seconds:.3f} s of audio: "
        f"{seconds / wall:.1f}x real time; peak device memory {peak / 2**20:.1f} MiB "
        f"({(peak - resident) / 2**20:.1f} MiB above the {resident / 2**20:.1f} MiB resident) "
        f"[{card}]")
    return {"launches": launches, "batch": x, "vlens": vlens, "max_frames": max_frames}


def run_cli_paths(torch, cli, io_pkg, decoder_mod, cfg, cfg4, x, frames, x4, frames4, xe,
                  frames_e, spec_kernels, kernels, card) -> tuple[dict, list]:
    """Phase 2 (cli): the port's command line in process on the card, in a
    temporary directory.  The flagship's 32 rows as 16-bit WAV and as FLAC
    files through `decode` (each file set one batched call), 8 fourb5b_b32
    rows the same in 4B5B; then `decode --equalize` of one equalized_b32
    row, `test` in both codes, `ask-test --frames 16`, `ofdm-test --fec
    conv`, `ping --count 2` and `tx --arq sr`, each gated on its exit code
    and outcome line.  Returns each run's launches of `kernels` and the
    decoded batches [(tag, cfg, batch, true lengths, max_frames)]."""
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    text_in = os.path.join(repo, "assets", "think-different.txt")
    t_phase = time.perf_counter()
    runs, batches = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sets = {"manchester": write_capture_files(io_pkg, x.cpu().numpy(), tmp, "man"),
                "4b5b": write_capture_files(io_pkg, x4[:CLI_4B5B_FILES].cpu().numpy(), tmp,
                                            "fbf")}
        eq_wav = os.path.join(tmp, "echoic.wav")
        io_pkg.write_wav(eq_wav, xe[0].cpu().numpy() * np.float32(CLI_GAIN))
        kinds = {}
        for _, _, file_kinds in sets.values():
            for got in file_kinds:
                for kind, n in got.items():
                    kinds[kind] = kinds.get(kind, 0) + n
        log(f"phase 2 (cli): wrote {len(x)} + {CLI_4B5B_FILES} captures as 16-bit WAV and FLAC at "
            f"gain {CLI_GAIN} (FLAC subframes {dict(sorted(kinds.items()))}) and one "
            f"equalized_b32 row as WAV in {time.perf_counter() - t0:.1f} s")
        loaded = {}
        for coding, c, fr, spec in (("manchester", cfg, frames, spec_kernels["manchester"]),
                                    ("4b5b", cfg4, frames4, spec_kernels["4b5b"])):
            wavs, flacs, _ = sets[coding]
            for fmt, paths in (("wav", wavs), ("flac", flacs)):
                tag = f"cli, decode {len(paths)} {fmt.upper()} files, {coding}"
                got = run_cli_decode(torch, cli.main, io_pkg, decoder_mod, c, paths, fr, spec,
                                     os.path.join(tmp, f"{coding}_{fmt}.bin"), tag, card)
                runs[tag] = got["launches"]
                loaded[fmt] = got
            require(torch.equal(loaded["wav"]["batch"], loaded["flac"]["batch"]),
                    f"cli {coding}: the FLAC files loaded to other samples than the WAV files")
            batches.append((f"cli {coding} batch", c, loaded["wav"]["batch"],
                            loaded["wav"]["vlens"], loaded["wav"]["max_frames"]))
            log(f"phase 2 (cli, {coding}): the FLAC batch equals the WAV batch bit for bit")

        payload_in = os.path.join(tmp, "payload.bin")
        with open(payload_in, "wb") as fh:
            fh.write(bytes(range(256)) * 2)
        eq_out = os.path.join(tmp, "echoic.bin")
        checks = (
            ("decode --equalize", ["decode", eq_wav, "--equalize", "--output", eq_out],
             ("equalizer: trained at sample", f"decoded {len(frames_e)} frames")),
            ("test", ["test"], ("exact: True",)),
            ("test --encoding 4b5b", ["test", "--encoding", "4b5b"], ("exact: True",)),
            ("ask-test --frames 16", ["ask-test", "--frames", "16", "--input", text_in],
             ("ASK loopback: 16/16 frames, prefix exact: True",)),
            ("ofdm-test --fec conv", ["ofdm-test", "--fec", "conv", "--input", text_in],
             ("exact: True",)),
            ("ping --count 2", ["ping", "--count", "2"], ("2 transmitted, 2 received, 0% loss",)),
            ("tx --arq sr", ["tx", "--input", payload_in, "--output",
                             os.path.join(tmp, "sr.bin"), "--arq", "sr"], ('"exact": true',)),
        )
        for what, argv, expect in checks:
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            code, text, wall = cli_call(cli.main, argv)
            torch.cuda.synchronize()
            got = {k.__name__: k.launches for k in kernels if k.launches}
            require(code == 0 and all(e in text for e in expect),
                    f"cli {what}: exit {code}, expected {expect} in:\n{text}")
            if what == "decode --equalize":
                with open(eq_out, "rb") as fh:
                    require(fh.read() == b"".join(f.data for f in frames_e),
                            "cli decode --equalize: the payloads differ")
                require(got.get("xcorr_rowstats", 0) > 0,
                        "cli decode --equalize never launched xcorr_rowstats")
            if what == "tx --arq sr":
                with open(os.path.join(tmp, "sr.bin"), "rb") as fh:
                    require(fh.read() == bytes(range(256)) * 2, "cli tx --arq sr: the bytes differ")
            runs[f"cli, {what}"] = got
            outcome = [ln for ln in text.splitlines() if any(e in ln for e in expect)]
            log(f"phase 2 (cli, {what}): exit 0 in {wall * 1e3:.1f} ms, {outcome[-1].strip()!r}; "
                f"kernel launches {got}")
    took = time.perf_counter() - t_phase
    require(took < CLI_BUDGET_S, f"phase 2 (cli) took {took:.1f} s, over {CLI_BUDGET_S} s")
    log(f"phase 2 (cli): {len(runs)} runs in {took:.1f} s [{card}]")
    return runs, batches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from trackmaker_tpu_torch import PhyConfig, _build
    except ImportError as exc:
        raise SystemExit(f"chip_smoke.py must run from a checkout of the repository: {exc}")
    from trackmaker_tpu_torch.bench import ber
    from trackmaker_tpu_torch.core import convcode
    from trackmaker_tpu_torch.core.config import MacConfig
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.dsp import channel, equalizer, timing
    from trackmaker_tpu_torch.link import gbn, sr, transfer
    from trackmaker_tpu_torch.link import stream as lstream
    from trackmaker_tpu_torch.parallel import mesh as mesh_mod
    from trackmaker_tpu_torch.parallel import ofdm_stream, stream
    from trackmaker_tpu_torch.phy import (
        ask, ask_spec, coded, fsk, ofdm, ofdm_adaptive, ofdm_v2, psk, stream_sc)
    from trackmaker_tpu_torch.phy import spec_decode as sd
    from trackmaker_tpu_torch.phy.decoder import (
        PhyDecoder, decode_capture, decode_capture_fast, decode_captures)
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
    from trackmaker_tpu_torch.sync import auto_xcorr
    from trackmaker_tpu_torch.sync import sliding_dot as sdot
    from trackmaker_tpu_torch.sync import xcorr_norm as xn
    from trackmaker_tpu_torch.sync.correlate import preamble_energy
    from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits, xcorr_hits_plain
    from trackmaker_tpu_torch.tools import exp_attempt_tiles as et
    from trackmaker_tpu_torch.tools import exp_fire_chain as efc
    from trackmaker_tpu_torch.tools import exp_offset_add as eo
    from trackmaker_tpu_torch.tools import exp_probe_offset as epo
    from trackmaker_tpu_torch.tools import exp_xcorr_streams as exs
    from trackmaker_tpu_torch.tools import health as hp
    from trackmaker_tpu_torch.tools import prof_fused as pf
    xh = importlib.import_module("trackmaker_tpu_torch.sync.xcorr_hits")   # the module
    cli = importlib.import_module("trackmaker_tpu_torch.cli.main")
    io_pkg = importlib.import_module("trackmaker_tpu_torch.io")
    runtime = importlib.import_module("trackmaker_tpu_torch.runtime")
    decoder_mod = importlib.import_module("trackmaker_tpu_torch.phy.decoder")

    # --- phase 0: setup ------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = hp.card_line()
    log(card)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    # the host runtime's g++ build beside the kernels' nvcc builds: the CLI's
    # FLAC loads in phase 2 then time the decoder, not the compiler
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(runtime.ensure_built)
        for path in _build.build_all():
            log(f"built {path.name}")
        log(f"built {host_lib.result().name} (the host runtime, g++)")
    empty = empty_kernel(torch, dev)     # built here: no compiler runs once profiling starts
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s; {toolchain(torch, _build)}")
    hp.seq_probe.launches = 0
    torch.cuda.synchronize()
    snap = hp.health(dev)
    torch.cuda.synchronize()
    probe_launches = hp.seq_probe.launches
    require(probe_launches == 1 + hp.LAUNCHES * hp.REPEATS,
            f"the health probe launched seq_probe {probe_launches} times")
    require(all(np.isfinite(snap[k]) and snap[k] > 0
                for k in ("rtt_ms", "noop_kernel_us", "stream_gbps")), f"health gave {snap}")
    log(f"phase 0: health: rtt_ms {snap['rtt_ms']:.4f}, noop_kernel_us "
        f"{snap['noop_kernel_us']:.4f}, stream_gbps {snap['stream_gbps']:.1f} "
        f"({probe_launches} seq_probe launches) [{card}]")

    cfg = PhyConfig()
    cfg4 = PhyConfig(line_coding="4b5b")
    frames, x = captures(torch, cfg, args.seed, dev)
    frames4, x4 = captures(torch, cfg4, args.seed + 1, dev)
    frames_e, xe = eq_captures(torch, cfg, args.seed + 2, dev)
    b, t = x.shape
    t4 = x4.shape[1]
    acfg = ask.AskConfig()
    frames_a, xa = ask_captures(torch, ask, acfg, dev)
    frames_b, starts_b, xb = blocked_input(torch, cfg, args.seed + 3, dev)
    frames_s, starts_s, xs = seam_input(torch, stream, cfg4, args.seed + 4, dev)
    robust_in = (search_capture(torch, cfg, dev), gate_capture(torch, cfg, dev),
                 dd_capture(torch, cfg, dev), gate_capture(torch, cfg, dev, quiet=GAP))
    enc = PhyEncoder(cfg, device=dev)
    stream_in = stream_capture(lambda i, p: enc.encode_frame(
        Frame.new_data(i, 1, LOCAL_ADDR, p)).cpu().numpy(), np.random.default_rng(args.seed + 29))
    mac_link = {"csma": transfer.transfer_over_bus, "gbn": gbn.gbn_transfer,
                "sr": sr.sr_transfer, "ofdm_v2": ofdm_v2.OfdmStreamPhyV2,
                "coded_manchester": coded.CodedManchesterPhy,
                "ofdm_adaptive": ofdm_adaptive.OfdmAdaptiveStreamPhy,
                "psk": stream_sc.PskStreamPhy, "fsk": stream_sc.FskStreamPhy}
    streams = {"ofdm_v2": (ofdm.OfdmStreamPhy, "_starts"),
               "coded_manchester": (coded._CodedPhyBase, "_correlate"),
               "ofdm_adaptive": (ofdm_adaptive.OfdmAdaptiveStreamPhy, "_starts"),
               "psk": (stream_sc._SingleCarrierStreamPhy, "_starts"),
               "fsk": (stream_sc._SingleCarrierStreamPhy, "_starts")}
    frames_o, caps_o = ofdm_input()
    _, caps_o1 = ofdm_input(v1=True)
    x_o, x_o1 = torch.from_numpy(caps_o).to(dev), torch.from_numpy(caps_o1).to(dev)
    frames_c, caps_c = coded_input()
    frames_c4, caps_c4 = coded4_input()
    x_c, x_c4 = torch.from_numpy(caps_c).to(dev), torch.from_numpy(caps_c4).to(dev)
    coded_phy = coded.CodedManchesterPhy(cfg, local_addr=LOCAL_ADDR, device=dev)
    frames_ad, caps_ad = adaptive_input()
    frames_al, caps_al = adaptive_input(loaded=True)
    x_a, x_al = torch.from_numpy(caps_ad).to(dev), torch.from_numpy(caps_al).to(dev)
    sc_in = sc_input()
    log(f"flagship input: {b} x {t} samples; fourb5b_b32 input: {b} x {t4} samples; "
        f"equalized_b32 input: {b} x {xe.shape[1]} samples; {N_FRAMES} frames per capture; "
        f"ask_b16 input: {xa.shape[0]} x {xa.shape[1]} samples, {ASK_FRAMES} frames per capture; "
        f"blocked_600s input: {xb.shape[0]} samples, {len(frames_b)} frames; 4B5B seam input: "
        f"{xs.shape[0]} samples, {len(frames_s)} frames; clock search input: "
        f"{robust_in[0][0].shape[0]} samples; timing gate inputs: {robust_in[1][0].shape[0]} "
        f"samples (quiet after the skewed frames) and {robust_in[3][0].shape[0]} (flagship "
        f"gaps); decision-directed input: {robust_in[2][0].shape[0]} samples; stream_latency "
        f"input: {len(stream_in[2])} samples, {STREAM_FRAMES} frames; ofdm_v2_b32 input: "
        f"{x_o.shape[0]} x {x_o.shape[1]} samples, {OFDM_FRAMES} frames per capture (v1: "
        f"{x_o1.shape[0]} x {x_o1.shape[1]}); coded_manchester_b8 input: {x_c.shape[0]} x "
        f"{x_c.shape[1]} samples, {CODED_FRAMES} frames per capture; coded 4B5B rate-3/4 input: "
        f"{x_c4.shape[0]} x {x_c4.shape[1]} samples, {CODED4_FRAMES} frames per capture; "
        f"ofdm_adaptive_b8 input: {x_a.shape[0]} x {x_a.shape[1]} samples, {ADAPTIVE_FRAMES} "
        f"frames per capture (loaded: {x_al.shape[0]} x {x_al.shape[1]}); single-carrier "
        f"inputs: {', '.join(f'{k} {len(w)}' for k, (_, w) in sc_in[1].items())} samples, "
        f"{SC_FRAMES} frames each")
    pre, pre4 = preamble_waveform(cfg), preamble_waveform(cfg4)
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    sync4 = pre4[cfg4.preamble_len - cfg4.sync_len:]
    sync_e, sync_e4 = preamble_energy(sync), preamble_energy(sync4)
    vlens = torch.full((b,), t, dtype=torch.int32, device=dev)
    vlens4 = torch.full((b,), t4, dtype=torch.int32, device=dev)
    errs = {}

    # --- phase 1: kernels against their plain versions -------------------------
    errs["xcorr_hits"], rows_k, corr_p = check_xcorr(
        torch, xcorr_hits, xcorr_hits_plain, x, pre, cfg.correlation_threshold, "flagship")
    err4, rows4, corr_p4 = check_xcorr(
        torch, xcorr_hits, xcorr_hits_plain, x4, pre4, cfg4.correlation_threshold, "4b5b")
    errs["xcorr_hits"] = max(errs["xcorr_hits"], err4)
    rows_b = xh.xcorr_hits_batched(x, pre, cfg.correlation_threshold)
    torch.cuda.synchronize()
    require(torch.equal(rows_b, rows_k), "xcorr_hits_batched differs from xcorr_hits' rows")
    errs["xcorr_hits_batched"], n_near, n_diff = compare_rows(
        torch, rows_b, xh.xcorr_hits_batched_plain(x, pre, cfg.correlation_threshold), corr_p,
        cfg.correlation_threshold, "xcorr_hits_batched")
    log(f"phase 1: xcorr_hits_batched (8 captures a block) == xcorr_hits' rows bit for bit and "
        f"== plain at the flagship shape (hit corr {errs['xcorr_hits_batched']:.3g}, {n_near} "
        f"lags near the threshold, {n_diff} rows differing there)")

    cand, _, n_valid, _ = sd.compact_hit_rows(rows_k, N_CAND)
    bytes_k, fs_k = sd.attempt_manchester(x, cand, n_valid, vlens, sync, sync_e)
    torch.cuda.synchronize()
    bytes_p, fs_p = sd.attempt_manchester_plain(x, cand, n_valid, vlens, sync, sync_e)
    require(torch.equal(bytes_k, bytes_p), "attempt_manchester bytes differ")
    require(torch.equal(fs_k, fs_p), "attempt_manchester fs differ")
    errs["attempt_manchester"] = max(
        (bytes_k.int() - bytes_p.int()).abs().max().item(),
        (fs_k - fs_p).abs().max().item())
    log(f"phase 1: attempt_manchester == plain on {int(n_valid.sum())} candidates "
        f"(n_valid per capture {int(n_valid.min())}..{int(n_valid.max())})")

    cand4, _, n_valid4, _ = sd.compact_hit_rows(rows4, N_CAND)
    got4 = sd.attempt_4b5b(x4, cand4, n_valid4, vlens4, sync4, sync_e4)
    torch.cuda.synchronize()
    want4 = sd.attempt_4b5b_plain(x4, cand4, n_valid4, vlens4, sync4, sync_e4)
    errs["attempt_4b5b"] = 0
    for field, g, w in zip(("bytes", "fs", "first_bad", "first_zero"), got4, want4):
        require(torch.equal(g, w), f"attempt_4b5b {field} differs")
        errs["attempt_4b5b"] = max(errs["attempt_4b5b"], (g.int() - w.int()).abs().max().item())
    log(f"phase 1: attempt_4b5b == plain (bytes, fs, first_bad, first_zero) on "
        f"{int(n_valid4.sum())} candidates (n_valid per capture "
        f"{int(n_valid4.min())}..{int(n_valid4.max())}, "
        f"{int(((got4[3] < sd.ZERO_SYMBOLS) & sd._live(cand4, n_valid4)).sum())} "
        "with a near-zero level in their 640 symbols)")
    fold_in = {}
    for tag, c, xx, vl, cp in (("flagship", cfg, x, vlens, corr_p),
                                ("fourb5b_b32", cfg4, x4, vlens4, corr_p4)):
        fold_errs, fold_in[tag] = check_fold(torch, sd, xh, c, xx, vl, c.correlation_threshold,
                                             cp, tag)
        for e in (fold_errs, check_refine_edges(torch, sd, xh, c, xx, cp, tag)):
            for k_name, v in e.items():
                errs[k_name] = max(errs.get(k_name, 0), v)
    fold_in, fold_in4 = fold_in["flagship"], fold_in["fourb5b_b32"]
    check_tap_sweep(torch, xh, xn, x, pre, cfg.correlation_threshold)
    for tag, c, xx in (("flagship", cfg, x), ("fourb5b_b32", cfg4, x4)):
        for k_name, v in check_dense_refine(torch, sd, xh, xn, c, xx, tag).items():
            errs[k_name] = max(errs.get(k_name, 0), v)
    shared_in = {}
    for tag, c, xx, n_blocks, past in (("blocked_600s", cfg, xb, BLOCKED_BLOCKS, True),
                                       ("the 4B5B seam capture", cfg4, xs, SEAM_BLOCKS, False)):
        shared_errs, shared_in[c.line_coding] = check_shared(torch, sd, xh, stream, c, xx,
                                                             n_blocks, tag, past)
        errs.update(shared_errs)
    tool = exs.tool_input(dev)
    errs.update(check_tools(torch, hp, exs, pf, sd, xh, xn, cfg, x, vlens, corr_p, tool))
    check_threshold_tie(torch, xh, decode_capture_fast, decode_capture, cfg4, pre4, dev)
    exp_errs, exp_in = check_experiments(torch, et, eo, dev)
    errs.update(exp_errs)
    check_tiles_streams_edges(torch, et, exs, xh, dev)
    check_probe_offset_edges(torch, hp, eo, dev)
    del corr_p, corr_p4, cp, rows_b     # the dense corr: keep it out of phase 4's peak memory

    rng = np.random.default_rng(args.seed + 17)
    walk_err = 0
    tables = []
    for cap in (1, 2, 5, 72, 128, 256):
        pos = np.full((b, N_CAND), 2**30, np.int64)
        for r in range(b):
            k = int(rng.integers(0, N_CAND + 1))
            pos[r, :k] = np.sort(rng.integers(0, 40_000, k))
        fields = np.stack([pos, rng.integers(1, 3000, (b, N_CAND)),
                           rng.random((b, N_CAND)) < 0.25, rng.random((b, N_CAND)) < 0.6],
                          axis=1).astype(np.int32)
        cur0 = rng.integers(0, 30_000, b).astype(np.int32)
        limit = rng.choice([20_000, 41_000, 2**30], b).astype(np.int32)
        tables.append((torch.from_numpy(fields).to(dev), torch.from_numpy(cur0).to(dev),
                       torch.from_numpy(limit).to(dev), cap))
    phase_a = sd.spec_phase_a(cfg, x, LOCAL_ADDR, N_CAND, vlens)
    phase_a4 = sd.spec_phase_a(cfg4, x4, LOCAL_ADDR, N_CAND, vlens4)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    no_limit = torch.full((b,), 2**30, dtype=torch.int32, device=dev)
    tables += [(phase_a.fields, zeros, no_limit, MAX_FRAMES),
               (phase_a4.fields, zeros, no_limit, MAX_FRAMES)]
    for fields, cur0, limit, cap in tables:
        got = sd.spec_walk(fields, cur0, limit, cap)
        torch.cuda.synchronize()
        want = sd.spec_walk_plain(fields, cur0, limit, cap)
        for field, g, w in zip(got._fields, got, want):
            require(torch.equal(g, w), f"spec_walk {field} differs (max_frames {cap})")
            walk_err = max(walk_err, (g.long() - w.long()).abs().max().item())
    errs["spec_walk"] = walk_err
    log(f"phase 1: spec_walk == plain on {len(tables)} tables "
        "(random ones with caps 1..256, the flagship's and fourb5b_b32's)")
    for k_name, v in check_walk_attempt_edges(torch, sd, dev).items():
        errs[k_name] = max(errs.get(k_name, 0), v)
    for k_name, v in check_ask_walk_4b5b_edges(torch, sd, ask_spec, dev).items():
        errs[k_name] = max(errs.get(k_name, 0), v)
    ask_errs, ask_in = check_ask_kernels(torch, ask, ask_spec, sdot, acfg, xa, rng)
    errs.update(ask_errs)
    check_fire_chain_edges(torch, ask, ask_spec, dev)
    chirp = ask._chirp_np(acfg)        # dsp/osc.py's chirp
    errs["xcorr_rowstats"] = max(check_rowstats(torch, xn, xcorr_hits, xe, pre, "equalized_b32"),
                                 check_rowstats(torch, xn, xcorr_hits, x4, pre4, "fourb5b_b32"),
                                 check_rowstats(torch, xn, xcorr_hits, xa, chirp, "ask_b16"))
    errs["normalized_xcorr"] = max(
        check_dense(torch, xn, xcorr_hits, xa, chirp, xe, pre),
        check_ofdm_corr(torch, xn, ofdm, [(x_o, OFDM_FRAMES), (x_o1, OFDM_FRAMES),
                                          (x_a, ADAPTIVE_FRAMES), (x_al, ADAPTIVE_FRAMES)],
                        "ofdm_v2_b32, v1, ofdm_adaptive_b8 and ofdm_adaptive_loaded_b8 captures"))
    for k_name, v in check_robustness_kernels(torch, sd, xn, channel, timing, equalizer, ber,
                                              xcorr_hits, xcorr_hits_plain, cfg, robust_in,
                                              dev).items():
        errs[k_name] = max(errs.get(k_name, 0), v)
    adaptive_rows = []
    for tag, xx, loaded in (("ofdm_adaptive_b8", x_a, False),
                            ("ofdm_adaptive_loaded_b8", x_al, True)):
        hdr_a, pay_a = adaptive_blocks(torch, ofdm, adaptive_phy(ofdm_adaptive, loaded, dev), xx)
        adaptive_rows += [(f"{tag} headers", hdr_a, 56),
                          (f"{tag} payloads", pay_a, 8 * ADAPTIVE_PAYLOAD)]
    errs["viterbi"] = check_viterbi(torch, convcode, coded_phy, x_c, dev, adaptive_rows)


    # --- phase 2: the main paths -----------------------------------------------
    xh.xcorr_hits_batched.launches = 0     # no path runs it: it must stay 0
    launches = run_main_path(torch, decode_capture_fast, decode_capture, sd, cfg, x, frames,
                             (xcorr_hits, sd.attempt_manchester, sd.spec_walk), "flagship")
    launches4 = run_main_path(torch, decode_capture_fast, decode_capture, sd, cfg4, x4,
                              frames4, (xcorr_hits, sd.attempt_4b5b, sd.spec_walk), "fourb5b_b32")
    fold_launches = {}
    for tag, c, xx, fr, attempt_fold in (
            ("manchester_b32_fold", cfg, x, frames, sd.attempt_manchester_fold),
            ("fourb5b_b32_fold", cfg4, x4, frames4, sd.attempt_4b5b_fold)):
        legacy = sd.decode_capture_spec(c, xx, LOCAL_ADDR, max_frames=MAX_FRAMES, with_cursor=True)
        kernels = (xh.xcorr_hits_refine, xcorr_hits, attempt_fold, sd.spec_walk)
        old_fold = sd.SYNC_FOLD
        sd.SYNC_FOLD = True
        try:
            got = run_main_path(torch, decode_capture_fast, decode_capture, sd, c, xx, fr,
                                kernels, tag, expect={k.__name__: int(k is not xcorr_hits)
                                                      for k in kernels})
            fold = sd.decode_capture_spec(c, xx, LOCAL_ADDR, max_frames=MAX_FRAMES,
                                          with_cursor=True)
        finally:
            sd.SYNC_FOLD = old_fold
        require(all(torch.equal(p, q) for p, q in zip([*fold[0], *fold[1:]],
                                                      [*legacy[0], *legacy[1:]])),
                f"{tag}: the fold decode differs from the legacy decode")
        log(f"phase 2 ({tag}): frames, ok and cursors equal the legacy decode's")
        for k_name, n in got.items():
            fold_launches[k_name] = fold_launches.get(k_name, 0) + n
    eq_info = {}

    def equalize_capture(xx):
        out, info = equalizer.equalize_capture(cfg, xx)
        eq_info.update(info)
        return out

    eq_kernels = (xn.xcorr_rowstats, xcorr_hits, sd.attempt_manchester, sd.spec_walk)
    launches_e = run_main_path(torch, decode_capture_fast, decode_capture, sd, cfg, xe, frames_e,
                               eq_kernels, "equalized_b32", front=equalize_capture)
    require(launches_e == dict.fromkeys(launches_e, 1),
            f"equalized_b32 launches {launches_e}, expected one of each kernel")
    require(bool(eq_info["applied"].all()), "an equalized_b32 row was not equalized")
    stock_e = decode_capture_fast(cfg, xe, LOCAL_ADDR, max_frames=MAX_FRAMES).count
    log(f"phase 2 (equalized_b32): every row applied (lam {eq_info['lam'].min().item():.3g}.."
        f"{eq_info['lam'].max().item():.3g}, quality {eq_info['quality'].min().item():.4f}.."
        f"{eq_info['quality'].max().item():.4f}); the stock decode of the same captures finds "
        f"{int(stock_e.min())}..{int(stock_e.max())} of {N_FRAMES} frames per row")
    for launch_counts in (launches4, fold_launches, launches_e):
        for k_name, n in launch_counts.items():
            launches[k_name] = launches.get(k_name, 0) + n
    launches["xcorr_hits_batched"] = xh.xcorr_hits_batched.launches
    xn.normalized_xcorr_dense.launches = 0
    torch.cuda.synchronize()
    corr_a = auto_xcorr(xa, chirp)
    torch.cuda.synchronize()
    launches["normalized_xcorr"] = xn.normalized_xcorr_dense.launches
    require(launches["normalized_xcorr"] == 1,
            f"auto_xcorr at L={len(chirp)} launched normalized_xcorr "
            f"{launches['normalized_xcorr']} times")
    require(corr_a.shape == (xa.shape[0], xa.shape[1] - len(chirp) + 1)
            and bool(torch.isfinite(corr_a).all()), "auto_xcorr at L=440 gave a bad result")
    log(f"phase 2 (auto_xcorr): L={len(chirp)} on {xa.shape[0]} x {xa.shape[1]} launched "
        f"normalized_xcorr once; peak corr per track {corr_a.amax(-1).min().item():.4f}.."
        f"{corr_a.amax(-1).max().item():.4f}")
    ask_kernels = (sdot.sliding_dot_scaled, ask_spec.dense_fire_candidates, ask.ask_chain,
                   ask_spec.ask_walk)
    launches.update(run_ask_main_path(torch, ask, ask_spec, acfg, xa, frames_a, ask_kernels))
    ofdm_launches = run_ofdm_paths(torch, xn, ofdm, ofdm_v2, frames_o, x_o, x_o1, dev)
    coded_launches = run_coded_paths(torch, coded, convcode, ofdm, xn, ber, xcorr_hits,
                                     (sd.attempt_manchester, sd.spec_walk), x_c, frames_c, x_c4,
                                     frames_c4, frames_o, dev)
    ofdm_launches["OfdmModem(fec='conv').decode"] = coded_launches.pop("normalized_xcorr_dense")
    launches["normalized_xcorr"] += sum(ofdm_launches.values())
    adaptive_runs, retrain_buckets = run_adaptive_paths(
        torch, ofdm_adaptive, fsk, psk, ofdm, xn, convcode, x_a, frames_ad, x_al, frames_al,
        sc_in, dev)
    adaptive_launches = {}
    for got in (coded_launches, *adaptive_runs.values()):
        for k_name, n in got.items():
            k_name = KERNEL_NAMES.get(k_name, k_name)
            launches[k_name] = launches.get(k_name, 0) + n
            if got is not coded_launches:
                adaptive_launches[k_name] = adaptive_launches.get(k_name, 0) + n
    blocked = {}
    for tag, c, xx, fr, st, n_blocks, fold in (
            ("blocked_600s", cfg, xb, frames_b, starts_b, BLOCKED_BLOCKS, False),
            ("blocked_600s_fold", cfg, xb, frames_b, starts_b, BLOCKED_BLOCKS, True),
            ("fourb5b_seam_60s", cfg4, xs, frames_s, starts_s, SEAM_BLOCKS, False),
            ("fourb5b_seam_60s_fold", cfg4, xs, frames_s, starts_s, SEAM_BLOCKS, True)):
        legacy, fold_fn, _, _ = shared_attempts(sd, c)
        counters = [("xcorr_hits", xcorr_hits, "launches", int(not fold)),
                    ("xcorr_hits_refine", xh.xcorr_hits_refine, "launches", int(fold)),
                    (f"{legacy.__name__}_shared", legacy, "shared_launches", int(not fold)),
                    (f"{fold_fn.__name__}_shared", fold_fn, "shared_launches", int(fold)),
                    (legacy.__name__, legacy, "launches", 0),
                    ("spec_walk", sd.spec_walk, "launches", None)]
        old_fold = sd.SYNC_FOLD
        sd.SYNC_FOLD = fold
        try:
            got, blocked[tag] = run_blocked_path(torch, sd, stream, c, xx, fr, st, n_blocks,
                                                 counters, tag, tag == "fourb5b_seam_60s")
        finally:
            sd.SYNC_FOLD = old_fold
        for k_name, n in got.items():
            launches[k_name] = launches.get(k_name, 0) + n
        if fold:
            require(all(torch.equal(p, q) for p, q in zip(blocked[tag], blocked[tag[:-5]])),
                    f"{tag}: the fold's frames differ from the legacy decode's")
            log(f"phase 2 ({tag}): every field equals the legacy decode's")

    prof_kernels = {"xcorr_hits": xcorr_hits, "xcorr_hits_refine": xh.xcorr_hits_refine,
                    "attempt_manchester": sd.attempt_manchester,
                    "attempt_manchester_fold": sd.attempt_manchester_fold,
                    "spec_walk": sd.spec_walk, "xcorr_hits_2s": exs.xcorr_hits_2s}
    prof = run_profiler_path(torch, pf, exs, cfg, x, frames, vlens, tool, prof_kernels)
    for k_name in ("xcorr_hits", "xcorr_hits_refine", "attempt_manchester",
                   "attempt_manchester_fold", "spec_walk"):
        launches[k_name] = launches.get(k_name, 0) + prof[k_name]
    launches["xcorr_hits_2s"] = prof["xcorr_hits_2s"]
    launches["attempt_sum"] = prof["attempt_manchester"] + prof["attempt_manchester_fold"]
    launches["seq_probe"] = probe_launches
    launches.update(run_experiments(torch, et, eo))
    robust = run_robustness_paths(torch, timing, equalizer, ber, decode_capture, cfg,
                                  (xcorr_hits, sd.attempt_manchester, sd.spec_walk,
                                   xn.xcorr_rowstats), robust_in)
    for got in robust.values():
        for k_name, n in got.items():
            launches[k_name] = launches.get(k_name, 0) + n
    stream_launches, _, rec_segments = run_stream_latency(
        torch, lstream.StreamingDecodePipeline, cfg, stream_in,
        (xcorr_hits, sd.attempt_manchester, sd.spec_walk), dev)
    live_kernels = (xcorr_hits, sd.attempt_manchester, sd.attempt_4b5b, sd.spec_walk,
                    xn.normalized_xcorr_dense, convcode.viterbi_decode)
    mac_launches, _, mac_in = run_mac_paths(torch, PhyDecoder, mac_link, PhyConfig, MacConfig,
                                            live_kernels, streams, dev)
    ping_launches, _, ping_in = run_ping_paths(
        torch, PhyDecoder, net_modules("trackmaker_tpu_torch"), live_kernels, streams, dev)
    for got in (stream_launches, *mac_launches.values(), *ping_launches.values()):
        for k_name, n in got.items():
            k_name = KERNEL_NAMES.get(k_name, k_name)
            launches[k_name] = launches.get(k_name, 0) + n
    ofdm_stream_launches = sum(got["normalized_xcorr_dense"] for got in
                               (*mac_launches.values(), *ping_launches.values()))
    cli_runs, cli_batches = run_cli_paths(
        torch, cli, io_pkg, decoder_mod, cfg, cfg4, x, frames, x4, frames4, xe, frames_e,
        {"manchester": (xcorr_hits, sd.attempt_manchester, sd.spec_walk),
         "4b5b": (xcorr_hits, sd.attempt_4b5b, sd.spec_walk)},
        (xcorr_hits, sd.attempt_manchester, sd.attempt_4b5b, sd.spec_walk, xn.xcorr_rowstats,
         xn.normalized_xcorr_dense, sdot.sliding_dot_scaled, ask_spec.dense_fire_candidates,
         ask.ask_chain, ask_spec.ask_walk, convcode.viterbi_decode), card)
    cli_launches = {}
    for got in cli_runs.values():
        for k_name, n in got.items():
            k_name = KERNEL_NAMES.get(k_name, k_name)
            launches[k_name] = launches.get(k_name, 0) + n
            cli_launches[k_name] = cli_launches.get(k_name, 0) + n
    t_mesh = time.perf_counter()
    mesh_launches, mesh_in = run_mesh_paths(
        torch, sd, stream, mesh_mod, ofdm_stream, decoder_mod, cfg, xb, frames_b, starts_b, x,
        frames, (xcorr_hits, sd.attempt_manchester, sd.attempt_4b5b, sd.spec_walk,
                 xn.normalized_xcorr_dense), dev)
    for k_name, n in mesh_launches.items():
        k_name = KERNEL_NAMES.get(k_name, k_name)
        launches[k_name] = launches.get(k_name, 0) + n
    err_x, err_n = check_mesh_inputs(torch, sd, stream, mesh_mod, xn, ofdm, ofdm_stream,
                                     xcorr_hits, xcorr_hits_plain, cfg, xb, mesh_in, dev)
    errs["xcorr_hits"] = max(errs["xcorr_hits"], err_x)
    errs["normalized_xcorr"] = max(errs["normalized_xcorr"], err_n)
    log(f"phase 2 (mesh): the mesh paths and their phase 1 checks took "
        f"{time.perf_counter() - t_mesh:.1f} s")
    # phase 1 on what these paths decoded, recorded as they ran: the
    # latency segments and every MAC and network run's buffers
    seg_in = [(torch.from_numpy(lstream.padded_segment(seg)[:-1]).to(dev), len(seg),
               LOCAL_ADDR, max_frames) for seg, max_frames in rec_segments]
    err = check_recorded(torch, sd, xcorr_hits, xcorr_hits_plain, cfg, seg_in,
                         "stream_latency segments")
    ofdm_buckets, coded_buckets = [], []
    for runs, run_in in ((MAC_RUNS, mac_in), (PING_RUNS, ping_in)):
        for name, opts in runs.items():
            opts = opts[2] if runs is MAC_RUNS else opts
            if "phy" in opts:
                (coded_buckets if opts["phy"].startswith("coded") else ofdm_buckets).extend(
                    run_in[name])
                continue
            c = cfg4 if opts.get("line_coding") == "4b5b" else cfg
            err = max(err, check_recorded(torch, sd, xcorr_hits, xcorr_hits_plain, c,
                                          run_in[name], f"{name} decode buffers"))
    for tag, c, y, vl, max_frames in cli_batches:
        err = max(err, check_path_batch(
            torch, sd, xcorr_hits, xcorr_hits_plain, c, y, max_frames, tag,
            vlens=torch.tensor(vl, dtype=torch.int32, device=dev)))
    errs["xcorr_hits"] = max(errs["xcorr_hits"], err)
    adaptive_buckets = mac_in["csma_transfer, ofdm_adaptive"]
    ofdm_buckets += retrain_buckets
    errs["normalized_xcorr"] = max(errs["normalized_xcorr"], check_ofdm_corr(
        torch, xn, ofdm, bucket_batches(torch, ofdm_buckets),
        f"{len(ofdm_buckets)} buckets the OFDM, adaptive OFDM, PSK and FSK runs and the retrain "
        "decoded"))
    errs["xcorr_hits"] = max(errs["xcorr_hits"], check_coded_corr(
        torch, xcorr_hits_plain, coded_phy.pre, coded_buckets,
        "buckets the coded MAC run correlated"))

    # --- phase 3: the fallbacks ----------------------------------------------
    enc = PhyEncoder(cfg, device=dev)
    tail = enc.encode_frames([Frame.new_data(i, 1, 2, bytes([i]) * 20) for i in range(3)],
                             gap_samples=300)
    crowded = torch.cat([torch.from_numpy(pre).to(dev).repeat(150),
                         torch.zeros(500, device=dev), tail])
    clean = torch.cat([tail, torch.zeros(crowded.shape[0] - tail.shape[0], device=dev)])
    check_fallback(torch, decode_capture_fast, decode_captures, sd, cfg,
                   torch.stack([crowded, clean]), [3, 3], "flagship",
                   "150 back-to-back preambles")
    enc4 = PhyEncoder(cfg4, device=dev)
    tail4 = enc4.encode_frames([Frame.new_data(i, 1, 2, bytes([i]) * 20) for i in range(3)],
                               gap_samples=300)
    zeroed = tail4.clone()
    level0 = cfg4.preamble_len + 20 * 15 + 3   # a level inside the first frame
    zeroed[level0:level0 + 3] = 0.0
    check_fallback(torch, decode_capture_fast, decode_captures, sd, cfg4,
                   torch.stack([zeroed, tail4]), [2, 3], "4b5b",
                   "a zeroed level inside an attempted frame")
    check_ask_fallback(torch, ask, ask_spec, acfg, dev)
    check_equalizer_noise(torch, equalizer, cfg, dev, args.seed + 23)
    check_blocked_fallback(torch, stream, decode_capture, cfg4, xs, starts_s)
    check_stream_fallbacks(torch, PhyDecoder, lstream, cfg, crowded, dev)

    # --- phase 4: timings ------------------------------------------------------
    ms = {
        "xcorr_hits": time_ms(torch, lambda: xcorr_hits(x, pre, cfg.correlation_threshold)),
        "attempt_manchester": time_ms(torch, lambda: sd.attempt_manchester(
            x, cand, n_valid, vlens, sync, sync_e)),
        "attempt_4b5b": time_ms(torch, lambda: sd.attempt_4b5b(
            x4, cand4, n_valid4, vlens4, sync4, sync_e4)),
        "spec_walk": time_ms(torch, lambda: sd.spec_walk(
            phase_a.fields, zeros, no_limit, MAX_FRAMES)),
    }
    plain_ms = {
        "xcorr_hits": time_ms(torch, lambda: xcorr_hits_plain(
            x, pre, cfg.correlation_threshold)),
        "attempt_manchester": time_ms(torch, lambda: sd.attempt_manchester_plain(
            x, cand, n_valid, vlens, sync, sync_e)),
        "attempt_4b5b": time_ms(torch, lambda: sd.attempt_4b5b_plain(
            x4, cand4, n_valid4, vlens4, sync4, sync_e4)),
        "spec_walk": time_ms(torch, lambda: sd.spec_walk_plain(
            phase_a.fields, zeros, no_limit, MAX_FRAMES)),
    }
    xcorr4_ms = time_ms(torch, lambda: xcorr_hits(x4, pre4, cfg4.correlation_threshold))
    thr = cfg.correlation_threshold
    fold_calls = {
        "xcorr_hits_refine": (xh.xcorr_hits_refine, xh.xcorr_hits_refine_plain,
                              (x, vlens, pre, sync, thr), fold_in["kw"]),
        "xcorr_hits_batched": (xh.xcorr_hits_batched, xh.xcorr_hits_batched_plain,
                               (x, pre, thr), {}),
        "attempt_manchester_fold": (sd.attempt_manchester_fold, sd.attempt_manchester_fold_plain,
                                    (x, fold_in["fs"], n_valid), {}),
        "attempt_4b5b_fold": (sd.attempt_4b5b_fold, sd.attempt_4b5b_fold_plain,
                              (x4, fold_in4["fs"], n_valid4), {}),
    }
    for k_name, (kernel, plain, call_args, kw) in fold_calls.items():
        ms[k_name] = time_ms(torch, lambda: kernel(*call_args, **kw))
        plain_ms[k_name] = time_ms(torch, lambda: plain(*call_args, **kw))
    refine4_ms = time_ms(torch, lambda: xh.xcorr_hits_refine(
        x4, vlens4, pre4, sync4, cfg4.correlation_threshold, **fold_in4["kw"]))
    sync_scale = 1.0 / acfg.sync_divisor
    demod_in, k30 = ask_in["demod_in"], ask_in["k30"]
    ask_calls = {
        "sliding_dot": (sdot.sliding_dot_scaled, sdot.sliding_dot_scaled_plain,
                        (xa, ask_in["pre"], sync_scale)),
        "ask_fire": (ask_spec.dense_fire_candidates, ask_spec.dense_fire_candidates_plain,
                     (acfg, ask_in["sync"], ask_in["upd_ok"])),
        "ask_chain": (ask.ask_chain, ask.ask_chain_plain,
                      (ask_in["vals"], ask_in["base"], acfg.peak_guard)),
        "ask_walk": (ask_spec.ask_walk, ask_spec.ask_walk_plain,
                     (ask_in["fields"], ASK_MAX_FRAMES)),
    }
    for k_name, (kernel, plain, ask_args) in ask_calls.items():
        ms[k_name] = time_ms(torch, lambda: kernel(*ask_args))
        plain_ms[k_name] = time_ms(torch, lambda: plain(*ask_args))
    ms["xcorr_rowstats"] = time_ms(torch, lambda: xn.xcorr_rowstats(xe, pre))
    plain_ms["xcorr_rowstats"] = time_ms(torch, lambda: xn.xcorr_rowstats_plain(xe, pre))
    rowstats4_ms = time_ms(torch, lambda: xn.xcorr_rowstats(x4, pre4))
    ms["normalized_xcorr"] = time_ms(torch, lambda: xn.normalized_xcorr_dense(xa, chirp))
    plain_ms["normalized_xcorr"] = time_ms(torch, lambda: xn.normalized_xcorr_dense_plain(
        xa, chirp))
    sd30_ms = time_ms(torch, lambda: sdot.sliding_dot_scaled(demod_in, k30, 1.0))
    sd30_plain_ms = time_ms(torch, lambda: sdot.sliding_dot_scaled_plain(demod_in, k30, 1.0))
    # the library yardstick of the sliding dot: one cuDNN convolution (TF32
    # off since phase 0), the scale folded into its weights
    conv_w = {n: torch.from_numpy(p * np.float32(sc)).to(dev).view(1, 1, -1)
              for n, p, sc in ((440, ask_in["pre"], sync_scale), (30, k30, 1.0))}

    def conv_dot(xx, n):
        return torch.nn.functional.conv1d(xx[:, None], conv_w[n], padding=n - 1)[:, 0, :xx.shape[1]]

    conv_err = (conv_dot(xa, 440) - sdot.sliding_dot_scaled(xa, ask_in["pre"], sync_scale)
                ).abs().max().item()
    library_ms = {"sliding_dot": time_ms(torch, lambda: conv_dot(xa, 440))}
    # the normalized correlation's nearest PyTorch calls: the dot and the
    # window energy, each one valid-mode cuDNN convolution (TF32 off)
    chirp_w = torch.from_numpy(chirp).to(dev).view(1, 1, -1)
    ones_w = torch.ones_like(chirp_w)

    def conv_dot_energy():
        xx = xa[:, None]
        return (torch.nn.functional.conv1d(xx, chirp_w),
                torch.nn.functional.conv1d(xx * xx, ones_w))

    library_ms["normalized_xcorr"] = time_ms(torch, conv_dot_energy)
    # the same at the OFDM sync's shape, ofdm_v2_b32, with the chirp's f32
    # norm as find_preambles passes it
    ochirp, ope = ofdm_chirp()
    n_lags_o = x_o.shape[1] - len(ochirp) + 1
    ofdm_xc = {
        "ms": time_ms(torch, lambda: xn.normalized_xcorr_dense(x_o, ochirp, ope)),
        "plain_ms": time_ms(torch, lambda: xn.normalized_xcorr_dense_plain(x_o, ochirp, ope)),
        "library_ms": time_ms(torch, lambda: (
            torch.nn.functional.conv1d(x_o[:, None], chirp_w),
            torch.nn.functional.conv1d(x_o[:, None] * x_o[:, None], ones_w))),
        "bound": bound(x_o.numel() * 4 + x_o.shape[0] * n_lags_o * 4,
                       x_o.shape[0] * n_lags_o * 4 * len(ochirp)),
    }
    # and at ofdm_adaptive_b8's shape
    n_lags_ad = x_a.shape[1] - len(ochirp) + 1
    adaptive_xc = {
        "ms": time_ms(torch, lambda: xn.normalized_xcorr_dense(x_a, ochirp, ope)),
        "plain_ms": time_ms(torch, lambda: xn.normalized_xcorr_dense_plain(x_a, ochirp, ope)),
        "library_ms": time_ms(torch, lambda: (
            torch.nn.functional.conv1d(x_a[:, None], chirp_w),
            torch.nn.functional.conv1d(x_a[:, None] * x_a[:, None], ones_w))),
        "bound": bound(x_a.numel() * 4 + x_a.shape[0] * n_lags_ad * 4,
                       x_a.shape[0] * n_lags_ad * 4 * len(ochirp)),
    }
    conv30_ms = time_ms(torch, lambda: conv_dot(demod_in, 30))

    # least times, from the shapes and this run's candidates
    live = int(n_valid.clamp(max=N_CAND).sum())
    live4 = int(n_valid4.clamp(max=N_CAND).sum())
    n_lags = t - len(pre) + 1
    n_lags_e = xe.shape[1] - len(pre) + 1
    n_lags_a = xa.shape[1] - len(chirp) + 1
    small_in = 3 * b * 4 + b * N_CAND * 4            # cand, n_valid, vlen
    chain_cols = chain_columns(torch, ask_in["vals"], ask_in["base"], acfg.peak_guard)
    bounds = {
        # each lag: len(pre) multiply-adds for the dot and for the energy
        "xcorr_hits": bound(x.numel() * 4 + rows_k.numel() * 4,
                            b * n_lags * 4 * len(pre)),
        # each candidate: 13 x 48 refine taps (4 ops), 2104 bits of 6 ops
        "attempt_manchester": bound(
            x.numel() * 4 + small_in + b * N_CAND * (sd.FRAME_BYTES + 4),
            live * (13 * 48 * 4 + sd.FRAME_BYTES * 8 * 6)),
        # each candidate: 31 x 30 refine taps (4 ops), 3200 levels of 2 adds,
        # a product and a compare
        "attempt_4b5b": bound(
            x4.numel() * 4 + small_in + b * N_CAND * (sd.FRAME_BYTES + 12),
            live4 * (31 * 30 * 4 + sd.ZERO_SYMBOLS * 5 * 4)),
        # the fields in, keep/attempted, done and three ints per capture
        # out; a few integer ops per candidate
        "spec_walk": bound(phase_a.fields.numel() * 4 + 2 * b * 4 + 2 * b * N_CAND + b
                           + 3 * b * 4, b * N_CAND * 4),
        # each lag: 440 products and 440 sums, then the scale
        "sliding_dot": bound(2 * xa.numel() * 4, xa.numel() * (2 * 440 + 1)),
        # sync and upd in, hits out; a select per sample (the block scans
        # and the window's three maxima are a few more a sample, far below
        # the bytes term)
        "ask_fire": bound(xa.numel() * 6, xa.numel()),
        # each row up to its first fire (all of it when none): the value in,
        # a max, a compare, an index select and a max per column
        "ask_chain": bound(4 * chain_cols + ask_in["base"].numel() * 9, 4 * chain_cols),
        # the table in, a peak and a flag per slot out; about 12 integer
        # ops per slot
        "ask_walk": bound(ask_in["fields"].numel() * 4 + xa.shape[0] * (ASK_MAX_FRAMES * 5 + 1),
                          xa.shape[0] * ASK_MAX_FRAMES * 12),
        # xcorr_hits' work, and each refined hit (the first four of a row):
        # 13 positions x 48 taps, a product and a sum for the dot and for
        # the energy; vlens in
        "xcorr_hits_refine": bound(x.numel() * 4 + b * 4 + rows_k.numel() * 4,
                                   b * n_lags * 4 * len(pre)
                                   + fold_in["hits"] * fold_in["kw"]["n_pos"] * len(sync) * 4),
        "xcorr_hits_batched": bound(x.numel() * 4 + rows_k.numel() * 4,
                                    b * n_lags * 4 * len(pre)),
        # the legacy attempts' work without the refine: fs in for the
        # candidate table
        "attempt_manchester_fold": bound(
            x.numel() * 4 + b * N_CAND * 4 + b * 4 + b * N_CAND * (sd.FRAME_BYTES + 4),
            live * sd.FRAME_BYTES * 8 * 6),
        "attempt_4b5b_fold": bound(
            x4.numel() * 4 + b * N_CAND * 4 + b * 4 + b * N_CAND * (sd.FRAME_BYTES + 12),
            live4 * sd.ZERO_SYMBOLS * 5 * 4),
        # each lag: len(pre) multiply-adds for the dot and for the energy;
        # a max and a position per 128 lags out
        "xcorr_rowstats": bound(xe.numel() * 4 + b * -(-n_lags_e // 128) * 8,
                                b * n_lags_e * 4 * len(pre)),
        # each lag: 440 multiply-adds for the dot and for the energy; the
        # captures in, the dense correlation out
        "normalized_xcorr": bound(xa.numel() * 4 + xa.shape[0] * n_lags_a * 4,
                                  xa.shape[0] * n_lags_a * 4 * len(chirp)),
    }
    sd30_bound = bound(2 * demod_in.numel() * 4, demod_in.numel() * (2 * 30 + 1))
    for k_name in ms:
        log(f"phase 4: {k_name}: kernel {ms[k_name]:.4f} ms, plain {plain_ms[k_name]:.4f} ms, "
            f"bound {bounds[k_name][0]:.4f} ms ({bounds[k_name][1]}) [{card}]")
    log(f"phase 4: xcorr_hits at the fourb5b_b32 shape (L=60): kernel {xcorr4_ms:.4f} ms "
        f"[{card}]")
    log(f"phase 4: xcorr_hits_refine at the fourb5b_b32 shape (L=60, W=30, 31 positions, "
        f"{fold_in4['hits']} refined hits): kernel {refine4_ms:.4f} ms [{card}]")
    log(f"phase 4: normalized_xcorr at L=440 vs conv1d dot + conv1d energy: "
        f"{library_ms['normalized_xcorr']:.4f} ms [{card}]")
    log(f"phase 4: normalized_xcorr at the ofdm_v2_b32 shape ({x_o.shape[0]} x {x_o.shape[1]}, "
        f"L=440): kernel {ofdm_xc['ms']:.4f} ms, plain {ofdm_xc['plain_ms']:.4f} ms, conv1d dot + "
        f"conv1d energy {ofdm_xc['library_ms']:.4f} ms, bound {ofdm_xc['bound'][0]:.4f} ms "
        f"({ofdm_xc['bound'][1]}) [{card}]")
    log(f"phase 4: normalized_xcorr at the ofdm_adaptive_b8 shape ({x_a.shape[0]} x "
        f"{x_a.shape[1]}, L=440): kernel {adaptive_xc['ms']:.4f} ms, plain "
        f"{adaptive_xc['plain_ms']:.4f} ms, conv1d dot + conv1d energy "
        f"{adaptive_xc['library_ms']:.4f} ms, bound {adaptive_xc['bound'][0]:.4f} ms "
        f"({adaptive_xc['bound'][1]}) [{card}]")
    log(f"phase 4: sliding_dot at L=440 vs conv1d: {library_ms['sliding_dot']:.4f} ms "
        f"(max |conv1d - kernel| {conv_err:.3g}); at L=30 ({demod_in.shape[0]} x "
        f"{demod_in.shape[1]}): kernel {sd30_ms:.4f} ms, plain {sd30_plain_ms:.4f} ms, conv1d "
        f"{conv30_ms:.4f} ms, bound {sd30_bound[0]:.4f} ms ({sd30_bound[1]}) [{card}]")
    steps = {
        "compact_hit_rows": time_ms(torch, lambda: sd.compact_hit_rows(rows_k, N_CAND)),
        "spec_phase_a": time_ms(torch, lambda: sd.spec_phase_a(
            cfg, x, LOCAL_ADDR, N_CAND, vlens)),
        "spec_phase_a 4b5b": time_ms(torch, lambda: sd.spec_phase_a(
            cfg4, x4, LOCAL_ADDR, N_CAND, vlens4)),
        "spec_compact": time_ms(torch, lambda: sd.spec_compact(
            phase_a, sd.spec_walk(phase_a.fields, zeros, no_limit, MAX_FRAMES).keep,
            MAX_FRAMES)),
    }
    for step, v in steps.items():
        log(f"phase 4: step {step}: {v:.4f} ms [{card}]")

    def decode_ms(c, xx, fold: bool) -> float:
        old_fold = sd.SYNC_FOLD
        sd.SYNC_FOLD = fold
        try:
            return time_ms(torch, lambda: sd.decode_capture_spec(
                c, xx, LOCAL_ADDR, max_frames=MAX_FRAMES))
        finally:
            sd.SYNC_FOLD = old_fold

    for tag, c, xx in (("flagship", cfg, x), ("fourb5b_b32", cfg4, x4)):
        e2e = decode_ms(c, xx, False)
        rt = xx.numel() / c.sample_rate / (e2e / 1e3)
        log(f"phase 4: decode_capture_spec {tag} {xx.shape[0]} x {xx.shape[1]}: {e2e:.4f} ms, "
            f"{rt:.1f}x real time [{card}]")
        # the fold against legacy: four turns each, in the order L F F L L F F L
        turns = [(fold, decode_ms(c, xx, fold)) for fold in (False, True, True, False) * 2]
        log(f"phase 4: decode_capture_spec {tag}, legacy and fold in turns (L F F L L F F L): "
            + ", ".join(f"{v:.4f}" for _, v in turns) + " ms; medians legacy "
            f"{statistics.median(v for f, v in turns if not f):.4f}, fold "
            f"{statistics.median(v for f, v in turns if f):.4f} ms [{card}]")
        peak = peak_memory(torch, lambda: sd.decode_capture_spec(c, xx, LOCAL_ADDR,
                                                                 max_frames=MAX_FRAMES))
        log(f"phase 4: decode_capture_spec {tag} peak device memory {peak} [{card}]")
        scan = time_ms(torch, lambda: decode_capture(c, xx[0], LOCAL_ADDR, MAX_FRAMES), runs=5)
        log(f"phase 4: exact scan {tag}, one row of {N_FRAMES} frames: {scan:.4f} ms [{card}]")
    power_a, sync_a, upd_a = ask.dense_arrays(acfg, xa)
    hits_a = ask_spec.dense_fire_candidates(acfg, sync_a, upd_a)
    cand_a, _, _ = ask_spec.extract_candidates(hits_a, 96)
    cand_full_a = torch.cat([torch.full((xa.shape[0], 1), -(acfg.frame_samples + 1),
                                        dtype=torch.int32, device=dev), cand_a], dim=1)
    ask_steps = {
        "dense_arrays": lambda: ask.dense_arrays(acfg, xa),
        "dense_fire_candidates": lambda: ask_spec.dense_fire_candidates(acfg, sync_a, upd_a),
        "extract_candidates": lambda: ask_spec.extract_candidates(hits_a, 96),
        "phase_b": lambda: ask_spec.phase_b(acfg, xa, power_a, sync_a, upd_a, cand_full_a),
        "ask_walk": lambda: ask_spec.ask_walk(ask_in["fields"], ASK_MAX_FRAMES),
        "demod_dense": lambda: ask.demod_dense(acfg, xa),
    }
    for step, fn in ask_steps.items():
        log(f"phase 4: ask_b16 step {step}: {time_ms(torch, fn):.4f} ms [{card}]")
    e2e = time_ms(torch, lambda: ask_spec.demodulate_spec(acfg, xa, max_frames=ASK_MAX_FRAMES))
    rt = xa.numel() / acfg.sample_rate / (e2e / 1e3)
    log(f"phase 4: demodulate_spec ask_b16 {xa.shape[0]} x {xa.shape[1]}: {e2e:.4f} ms, "
        f"{rt:.1f}x real time [{card}]")
    peak = peak_memory(torch, lambda: ask_spec.demodulate_spec(acfg, xa,
                                                               max_frames=ASK_MAX_FRAMES))
    log(f"phase 4: demodulate_spec ask_b16 peak device memory {peak} [{card}]")
    scan = time_ms(torch, lambda: ask.demodulate(acfg, xa[0], max_frames=ASK_MAX_FRAMES), runs=5)
    log(f"phase 4: exact scan ask_b16, one row of {ASK_FRAMES} frames: {scan:.4f} ms [{card}]")

    _, info_e = equalizer.equalize_capture(cfg, xe)
    anchors_e = info_e["anchor"][:, None].expand(-1, 4).contiguous()   # the fit's shape
    g_t = equalizer._mmse_taps(info_e["h"], info_e["lam"])
    eq_steps = {
        "auto_xcorr_row_stats": lambda: xn.xcorr_rowstats(xe, pre),
        "estimate_channel (4 anchors)": lambda: equalizer.estimate_channel(cfg, xe, anchors_e),
        "_mmse_taps": lambda: equalizer._mmse_taps(info_e["h"], info_e["lam"]),
        "_apply_fir": lambda: equalizer._apply_fir(xe, g_t),
    }
    for step, fn in eq_steps.items():
        log(f"phase 4: equalized_b32 step {step}: {time_ms(torch, fn):.4f} ms [{card}]")
    eq_ms = time_ms(torch, lambda: equalizer.equalize_capture(cfg, xe))
    rt = xe.numel() / cfg.sample_rate / (eq_ms / 1e3)
    log(f"phase 4: equalize_capture equalized_b32 {b} x {xe.shape[1]}: {eq_ms:.4f} ms, "
        f"{rt:.1f}x real time [{card}]")

    def eq_decode():
        return sd.decode_capture_spec(cfg, equalizer.equalize_capture(cfg, xe)[0], LOCAL_ADDR,
                                      max_frames=MAX_FRAMES)

    e2e = time_ms(torch, eq_decode)
    rt = xe.numel() / cfg.sample_rate / (e2e / 1e3)
    log(f"phase 4: equalize_capture + decode_capture_spec equalized_b32 {b} x {xe.shape[1]}: "
        f"{e2e:.4f} ms, {rt:.1f}x real time [{card}]")
    for what, fn in (("equalize_capture", lambda: equalizer.equalize_capture(cfg, xe)),
                     ("equalize_capture + decode_capture_spec", eq_decode)):
        peak = peak_memory(torch, fn)
        share = busy_share(torch, fn)
        busy = "not measured (no device events traced)" if share is None else f"{share:.3f}"
        log(f"phase 4: {what} equalized_b32 peak device memory {peak}, device busy "
            f"share over 5 calls (torch.profiler) {busy} [{card}]")

    # blocked_600s: end to end, its steps, memory, busy share, the shared
    # attempts at their captures' shapes, one exact blocked decode
    def blocked_call():
        return stream.decode_blocked_single_chip(cfg, xb, LOCAL_ADDR, BLOCKED_BLOCKS,
                                                 BLOCKED_MFPB, N_CAND)

    e2e = time_ms(torch, blocked_call)
    log(f"phase 4: decode_blocked_single_chip blocked_600s ({xb.shape[0]} samples, "
        f"{BLOCKED_BLOCKS} blocks): {e2e:.4f} ms, {BLOCKED_SECONDS / (e2e / 1e3):.1f}x real time "
        f"[{card}]")
    info_b = shared_in["manchester"]
    xbf, block_b, vlens_b = info_b["xf"][0], info_b["block"], info_b["vlens"]
    a_b = sd.spec_phase_a(cfg, xbf, LOCAL_ADDR, N_CAND, vlens_b,
                          flat_blocks=(BLOCKED_BLOCKS, block_b))
    starts_t = torch.arange(BLOCKED_BLOCKS, dtype=torch.int32, device=dev) * block_b
    walk_b, turns_b = stream.seam_fixpoint(sd.spec_walk, a_b.fields, starts_t, starts_t + block_b,
                                           BLOCKED_MFPB)
    blocked_steps = {
        "spec_phase_a (flat)": lambda: sd.spec_phase_a(cfg, xbf, LOCAL_ADDR, N_CAND, vlens_b,
                                                       flat_blocks=(BLOCKED_BLOCKS, block_b)),
        f"seam_fixpoint ({turns_b} walk turn(s))": lambda: stream.seam_fixpoint(
            sd.spec_walk, a_b.fields, starts_t, starts_t + block_b, BLOCKED_MFPB),
        "spec_compact": lambda: sd.spec_compact(a_b, walk_b.keep, BLOCKED_MFPB),
    }
    for step, fn in blocked_steps.items():
        log(f"phase 4: blocked_600s step {step}: {time_ms(torch, fn):.4f} ms [{card}]")
    peak = peak_memory(torch, blocked_call)
    share = busy_share(torch, blocked_call)
    busy = "not measured (no device events traced)" if share is None else f"{share:.3f}"
    log(f"phase 4: decode_blocked_single_chip blocked_600s peak device memory {peak} (the "
        f"capture itself {xb.numel() * 4 / 2**20:.1f} MiB), device busy share over 5 calls "
        f"(torch.profiler) {busy} [{card}]")
    for c in (cfg, cfg4):
        info = shared_in[c.line_coding]
        for k_name, (kernel, plain, call_args) in info["calls"].items():
            ms[k_name] = time_ms(torch, lambda: kernel(*call_args))
            plain_ms[k_name] = time_ms(torch, lambda: plain(*call_args))
            bounds[k_name] = shared_bound(sd, c, k_name, info)
            log(f"phase 4: {k_name}: kernel {ms[k_name]:.4f} ms, plain {plain_ms[k_name]:.4f} ms, "
                f"bound {bounds[k_name][0]:.6f} ms ({bounds[k_name][1]}) at {info['live']} live "
                f"of {info['vlens'].numel() * N_CAND} slots [{card}]")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact_b = stream.decode_blocked_exact(cfg, xb, LOCAL_ADDR, BLOCKED_BLOCKS, BLOCKED_MFPB)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    require(frame_set(exact_b) == frame_set(blocked["blocked_600s"]),
            "blocked_600s: the exact blocked route differs from the speculative one")
    log(f"phase 4: decode_blocked_exact blocked_600s, one call: {exact_s * 1e3:.1f} ms "
        f"({BLOCKED_SECONDS / exact_s:.1f}x real time), frames equal the speculative route's "
        f"[{card}]")

    # the tools: the launch floor, the two-stream experiment beside kernel
    # #1 at the tool's shapes, the profiler's stage table
    log(f"phase 4: launch floor noop_kernel_us {snap['noop_kernel_us']:.4f} us (health: "
        f"{hp.LAUNCHES} seq_probe launches back to back, median of {hp.REPEATS}) [{card}]")
    xt, pat_t = tool
    n_lags_t = xt.shape[1] - len(pat_t) + 1
    n_rows_t = -(-xt.shape[1] // 128)
    n_tiles_t = -(-n_rows_t // 8)
    # each lag: L multiply-adds for the dot and for the energy; the captures
    # and the halo of the second stream in, the rows out
    bounds["xcorr_hits_2s"] = bound(xt.numel() * 4 + xt.shape[0] * n_tiles_t * 128 * 4
                                    + xt.shape[0] * n_rows_t * 16 * 4,
                                    xt.shape[0] * n_lags_t * 4 * len(pat_t))
    for form, (mn, med) in exs.experiment(xt, pat_t, exs.THR, iters=50).items():
        log(f"phase 4: exp_xcorr_streams {form}: min {mn:.4f} ms, median {med:.4f} ms a call "
            f"(50 back to back, 3 repeats) [{card}]")
    log(f"phase 4: exp_xcorr_streams bound (current, 2stream, 2stream_noep): "
        f"{bounds['xcorr_hits_2s'][0]:.4f} ms ({bounds['xcorr_hits_2s'][1]}) [{card}]")
    streams_t = exs.two_streams(xt)
    ms["xcorr_hits_2s"] = time_ms(torch, lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR,
                                                                   streams=streams_t))
    plain_ms["xcorr_hits_2s"] = time_ms(torch, lambda: exs.xcorr_hits_2s_plain(xt, pat_t, exs.THR))
    noep_ms = time_ms(torch, lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR, False, streams_t))
    xcorr_t_ms = time_ms(torch, lambda: xcorr_hits(xt, pat_t, exs.THR))
    log(f"phase 4: at the tool's shapes ({xt.shape[0]} x {xt.shape[1]}, L={len(pat_t)}), median "
        f"of {RUNS}: xcorr_hits_2s {ms['xcorr_hits_2s']:.4f} ms, noep {noep_ms:.4f} ms, kernel #1 "
        f"{xcorr_t_ms:.4f} ms, plain {plain_ms['xcorr_hits_2s']:.4f} ms; bound "
        f"{bounds['xcorr_hits_2s'][0]:.4f} ms ({bounds['xcorr_hits_2s'][1]}) [{card}]")
    # the hit kernel's own device time (torch.profiler) beside the CUDA-event
    # median of its wrapper call; at the tool's shapes beside the two-stream
    # kernel, which runs the same register tile on its two streams: their
    # ratio in one run compares the two ways of delivering the operand
    thr4 = cfg4.correlation_threshold
    dev_calls = {
        "xcorr_hits flagship (L=96)": (lambda: xcorr_hits(x, pre, thr), "xcorr_hits_kernel",
                                       ms["xcorr_hits"]),
        "xcorr_hits fourb5b_b32 (L=60)": (lambda: xcorr_hits(x4, pre4, thr4),
                                          "xcorr_hits_kernel", xcorr4_ms),
        "xcorr_hits_refine flagship": (lambda: xh.xcorr_hits_refine(
            x, vlens, pre, sync, thr, **fold_in["kw"]), "xcorr_hits_kernel",
            ms["xcorr_hits_refine"]),
        "xcorr_hits_refine fourb5b_b32": (lambda: xh.xcorr_hits_refine(
            x4, vlens4, pre4, sync4, thr4, **fold_in4["kw"]), "xcorr_hits_kernel", refine4_ms),
        "xcorr_hits_batched flagship": (lambda: xh.xcorr_hits_batched(x, pre, thr),
                                        "xcorr_hits_kernel", ms["xcorr_hits_batched"]),
        "xcorr_hits tool input": (lambda: xcorr_hits(xt, pat_t, exs.THR), "xcorr_hits_kernel",
                                  xcorr_t_ms),
        "xcorr_hits_2s tool input": (lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR,
                                                               streams=streams_t),
                                     "xcorr_hits_2s_kernel", ms["xcorr_hits_2s"]),
        "xcorr_hits_2s noep tool input": (lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR, False,
                                                                    streams_t),
                                          "xcorr_hits_2s_kernel", noep_ms),
    }
    dev_ms = {}
    for what, (fn, kernel, event_ms) in dev_calls.items():
        got = device_ms(torch, fn, kernel)
        dev_ms[what] = None if got is None else got[0]
        traced = ("not measured (no session traced every launch)" if got is None
                  else f"{got[0]:.4f} ms (all {RUNS} launches traced, session {got[1]})")
        log(f"phase 4: device time {what}: {traced}; CUDA events around the wrapper "
            f"{event_ms:.4f} ms [{card}]")
    one, two = dev_ms["xcorr_hits tool input"], dev_ms["xcorr_hits_2s tool input"]
    log(f"phase 4: kernel #1 / xcorr_hits_2s at the tool's shapes, same run: device "
        f"{'not measured' if one is None or two is None else f'{one / two:.4f}'}, CUDA events "
        f"{xcorr_t_ms / ms['xcorr_hits_2s']:.4f} [{card}]")
    # every other path kernel's own device time beside its wrapper's
    # CUDA-event time, its bound and its launches on the main paths; the
    # ASK decode launches the sliding dot once at L=440 and once at L=30
    n_lags_4 = x4.shape[1] - len(pre4) + 1
    rowstats4_bound = bound(x4.numel() * 4 + b * -(-n_lags_4 // 128) * 8,
                            b * n_lags_4 * 4 * len(pre4))
    path_calls = {
        "sliding_dot ask_b16 (L=440)": (ask_calls["sliding_dot"], "sliding_dot_kernel",
                                        ms["sliding_dot"], bounds["sliding_dot"],
                                        launches["sliding_dot"] // 2),
        "sliding_dot dense dots (L=30)": (
            (sdot.sliding_dot_scaled, None, (demod_in, k30, 1.0)), "sliding_dot_kernel",
            sd30_ms, sd30_bound, launches["sliding_dot"] // 2),
        "normalized_xcorr ask_b16 (L=440)": (
            (xn.normalized_xcorr_dense, None, (xa, chirp)), "normalized_xcorr_kernel",
            ms["normalized_xcorr"], bounds["normalized_xcorr"],
            launches["normalized_xcorr"] - sum(ofdm_launches.values()) - ofdm_stream_launches
            - adaptive_launches["normalized_xcorr"] - cli_launches.get("normalized_xcorr", 0)),
        "normalized_xcorr ofdm_adaptive_b8 (L=440)": (
            (xn.normalized_xcorr_dense, None, (x_a, ochirp, ope)), "normalized_xcorr_kernel",
            adaptive_xc["ms"], adaptive_xc["bound"], adaptive_launches["normalized_xcorr"]),
        "normalized_xcorr ofdm_v2_b32 (L=440)": (
            (xn.normalized_xcorr_dense, None, (x_o, ochirp, ope)), "normalized_xcorr_kernel",
            ofdm_xc["ms"], ofdm_xc["bound"], sum(ofdm_launches.values()) + ofdm_stream_launches),
        "xcorr_rowstats equalized_b32 (L=96)": (
            (xn.xcorr_rowstats, None, (xe, pre)), "xcorr_rowstats_kernel",
            ms["xcorr_rowstats"], bounds["xcorr_rowstats"], launches["xcorr_rowstats"]),
        "xcorr_rowstats fourb5b_b32 (L=60)": (
            (xn.xcorr_rowstats, None, (x4, pre4)), "xcorr_rowstats_kernel", rowstats4_ms,
            rowstats4_bound, 0),
    }
    for k_name in ("attempt_manchester", "attempt_4b5b", "attempt_manchester_fold",
                   "attempt_4b5b_fold", "attempt_manchester_shared",
                   "attempt_manchester_fold_shared", "attempt_4b5b_shared",
                   "attempt_4b5b_fold_shared", "spec_walk", "ask_fire", "ask_chain", "ask_walk"):
        if k_name in ask_calls:
            call = ask_calls[k_name]
        elif k_name in fold_calls:
            kernel, _, call_args, kw = fold_calls[k_name]
            call = (lambda kernel=kernel, call_args=call_args, kw=kw: kernel(*call_args, **kw),
                    None, ())
        elif k_name.endswith("_shared"):
            call = shared_in["4b5b" if "4b5b" in k_name else "manchester"]["calls"][k_name]
        else:
            call = ({"attempt_manchester": lambda: sd.attempt_manchester(
                         x, cand, n_valid, vlens, sync, sync_e),
                     "attempt_4b5b": lambda: sd.attempt_4b5b(
                         x4, cand4, n_valid4, vlens4, sync4, sync_e4),
                     "spec_walk": lambda: sd.spec_walk(
                         phase_a.fields, zeros, no_limit, MAX_FRAMES)}[k_name], None, ())
        kernel_fn = KERNEL_NAMES.get(k_name, k_name).replace("_fold", "").replace("_shared", "")
        path_calls[k_name] = (call, f"{kernel_fn}_kernel", ms[k_name], bounds[k_name],
                              launches[k_name])
    loss = {}
    for what, ((kernel, _, call_args), k_fn, event_ms, bnd, n) in path_calls.items():
        got = device_ms(torch, lambda: kernel(*call_args), k_fn)
        if got is None:
            log(f"phase 4: device time {what}: not measured (no session traced every launch); "
                f"CUDA events around the wrapper {event_ms:.4f} ms, bound {bnd[0]:.6f} ms "
                f"({bnd[1]}) [{card}]")
            continue
        loss[what] = n * (got[0] - bnd[0])
        log(f"phase 4: device time {what}: {got[0]:.4f} ms (all {RUNS} launches traced, session "
            f"{got[1]}); CUDA events around the wrapper {event_ms:.4f} ms; bound {bnd[0]:.6f} ms "
            f"({bnd[1]}); {n} launches on the paths, launches x (device - bound) "
            f"{loss[what]:.4f} ms [{card}]")
    # the attempts' contract: every live slot reads its own window (legacy
    # 60 + 12,624 samples, fold 12,624; 4B5B legacy 60 + 9,600, fold
    # 9,600), once each, beside the bound, which counts the capture once
    for k_name, n_live in (("attempt_manchester", live), ("attempt_manchester_fold", live),
                           ("attempt_manchester_shared", shared_in["manchester"]["live"]),
                           ("attempt_manchester_fold_shared", shared_in["manchester"]["live"]),
                           ("attempt_4b5b", live4), ("attempt_4b5b_fold", live4),
                           ("attempt_4b5b_shared", shared_in["4b5b"]["live"]),
                           ("attempt_4b5b_fold_shared", shared_in["4b5b"]["live"])):
        body = (sd.ZERO_SYMBOLS * sd.SYMBOL_SAMPLES if "4b5b" in k_name
                else sd.FRAME_BYTES * 8 * sd.BIT_SAMPLES)
        window = body + (0 if "_fold" in k_name else 60)
        log(f"phase 4: {k_name}: contract floor {n_live * window * 4 / HBM_BYTES_PER_S * 1e3:.6f}"
            f" ms ({n_live} live slots x {window} samples, each window read once) beside its "
            f"bound {bounds[k_name][0]:.6f} ms [{card}]")
    log("phase 4: path kernels by launches x (device - bound): "
        + ", ".join(f"{w} {v:.4f}" for w, v in sorted(loss.items(), key=lambda kv: -kv[1]))
        + f" ms [{card}]")
    # the raw sliding dot rounds each product and each sum on its own: two
    # f32 instructions a tap at half the card's 67 TFLOP/s (FMA counted as 2)
    unfused_ms = xa.numel() * len(ask_in["pre"]) * 2 / (F32_OPS_PER_S / 2) * 1e3
    log(f"phase 4: sliding_dot ask_b16 (L=440) unfused floor {unfused_ms:.4f} ms beside its "
        f"bound {bounds['sliding_dot'][0]:.4f} ms [{card}]")
    # the exact scan's record chain, one row a launch: its first row on the
    # first track (phy/ask.py's CHAIN_WINDOW, 4,096 columns) and that row's
    # first 512 columns
    scan_row, scan_base = efc.exact_scan_row(acfg, xa[0])
    for width, v in ((scan_row.shape[1], scan_row), (512, scan_row[:, :512].contiguous())):
        def chain_row(v=v):
            return ask.ask_chain(v, scan_base, acfg.peak_guard)

        got = device_ms(torch, chain_row, "ask_chain_kernel")
        traced = ("not measured (no session traced every launch)" if got is None
                  else f"{got[0]:.4f} ms (all {RUNS} launches traced, session {got[1]})")
        row_plain = time_ms(torch, lambda v=v: ask.ask_chain_plain(v, scan_base, acfg.peak_guard))
        log(f"phase 4: device time ask_chain exact scan row ({width} columns): {traced}; CUDA "
            f"events around the wrapper {time_ms(torch, chain_row):.4f} ms, plain "
            f"{row_plain:.4f} ms; fires {bool(chain_row()[0][0])} [{card}]")
    # yardsticks, each one PyTorch call that computes only part of its
    # kernel's function: torch.cummax of the chain rows (the running maximum
    # alone) and max_pool1d (kernel w, stride 1) of the masked rows (the
    # window maxima alone)
    w_fire = acfg.peak_guard + 1
    masked_a = torch.where(ask_in["upd_ok"], ask_in["sync"], -np.inf)[:, None]
    cummax_ms = time_ms(torch, lambda: ask_in["vals"].cummax(-1))
    pool_ms = time_ms(torch, lambda: torch.nn.functional.max_pool1d(masked_a, w_fire, 1))
    log(f"phase 4: yardsticks, each only part of its kernel's function: ask_chain "
        f"torch.cummax of the {ask_in['vals'].shape[0]} x {ask_in['vals'].shape[1]} rows "
        f"{cummax_ms:.4f} ms; ask_fire max_pool1d (kernel {w_fire}, stride 1) of the masked "
        f"{masked_a.shape[0]} x {masked_a.shape[2]} rows {pool_ms:.4f} ms [{card}]")
    del masked_a
    xk = torch.ones((8, 128), dtype=torch.float32, device=dev)
    ms["seq_probe"] = time_ms(torch, lambda: hp.seq_probe(xk))
    plain_ms["seq_probe"] = time_ms(torch, lambda: hp.seq_probe_plain(xk))
    bounds["seq_probe"] = probe_bound()
    ms["attempt_sum"] = time_ms(torch, lambda: sd.attempt_manchester(
        x, cand, n_valid, vlens, sync, sync_e))
    plain_ms["attempt_sum"] = time_ms(torch, lambda: sd.attempt_manchester_plain(
        x, cand, n_valid, vlens, sync, sync_e))
    bounds["attempt_sum"] = bounds["attempt_manchester"]
    for k_name in ("seq_probe", "xcorr_hits_2s", "attempt_sum"):
        log(f"phase 4: {k_name}: kernel {ms[k_name]:.4f} ms, plain {plain_ms[k_name]:.4f} ms, "
            f"bound {bounds[k_name][0]:.6f} ms ({bounds[k_name][1]}) [{card}]")
    # the tools' kernels whose time is a launch, each beside an empty kernel
    # at its grid: the window probe (#12), the offset add's forms (#14), and
    # the grids of the attempt tiles (#13) and the two streams (#15)
    xo, to = exp_in["offset"]
    n_tiles_13 = -(-et.NV // et.GROUP)
    # (what, call, kernel, its grid, the first design's grid or None)
    launch_calls = (
        ("seq_probe (#12)", lambda: hp.seq_probe(xk), "seq_probe_kernel", epo.PROBE_GRID,
         epo.PROBE_FIRST_GRID),
        *((f"offset_add {form} (#14)", lambda form=form: eo.offset_add(form, xo, to),
           f"offset_add_{form.lower()}_kernel", epo.OFFSET_GRIDS[form],
           epo.OFFSET_FIRST_GRIDS[form]) for form in eo.FORMS),
        ("attempt_tiles noop (#13)", lambda: et.attempt_tiles("noop", *exp_in["tiles"]),
         "attempt_tiles_kernel", (exp_in["tiles"][0].shape[0] * n_tiles_13, 128), None),
        ("xcorr_hits_2s (#15)", lambda: exs.xcorr_hits_2s(xt, pat_t, exs.THR, streams=streams_t),
         "xcorr_hits_2s_kernel", (xt.shape[0] * n_tiles_t, 128), None))

    def empty_ms(grid):
        none = device_ms(torch, lambda g=grid[0], n=grid[1]: empty(g, n), "empty_kernel")
        return "not measured" if none is None else f"{none[0]:.4f} ms"

    for what, fn, kernel, grid, first in launch_calls:
        got = device_ms(torch, fn, kernel)
        log(f"phase 4: device time {what}: "
            + ("not measured" if got is None else f"{got[0]:.4f} ms")
            + f"; an empty kernel at its grid ({grid[0]} x {grid[1]}): {empty_ms(grid)}"
            + ("" if first is None else f", at the first design's grid ({first[0]} x "
               f"{first[1]}): {empty_ms(first)}") + f" [{card}]")
    stage_fns = pf.stages(cfg, x, vlens)
    stage_fns["xcorr+extract+attempt (fold on)"] = lambda xx: pf.attempt_sum(cfg, xx, vlens, True)
    for stage, fn in stage_fns.items():
        mn, med = pf.time_stage(fn, x, pf.ITERS)
        log(f"phase 4: profiler manchester_b32 {stage:32s} min {mn:.4f} ms, median {med:.4f} ms "
            f"({pf.ITERS} calls back to back, 3 repeats) [{card}]")

    # the experiments: every attempt-tile variant checked in phase 1 and
    # every offset-add form against its plain version and its bound; beside
    # them, torch.bmm of the attempt tiles' body products and, for offset
    # add, torch.matmul and the sliced add (two calls)
    xt13, *tables13 = exp_in["tiles"]
    for variant in TILE_CHECKS:
        k_ms = time_ms(torch, lambda: et.attempt_tiles(variant, xt13, *tables13), runs=10)
        p_ms = time_ms(torch, lambda: et.attempt_tiles_plain(variant, xt13, *tables13), runs=3)
        got = device_ms(torch, lambda: et.attempt_tiles(variant, xt13, *tables13),
                        "attempt_tiles_kernel")
        bnd = tiles_bound(et, variant, exp_in["tiles"])
        at_f32 = (f", at the f32 rate {tiles_bound(et, variant, exp_in['tiles'], False)[0]:.4f} "
                  "ms" if variant.startswith("bf16b") else "")
        log(f"phase 4: attempt_tiles {variant}: kernel {k_ms:.4f} ms "
            f"({k_ms * 1e3 / (xt13.shape[0] * et.NV):.3f} us a candidate), device "
            + ("not measured" if got is None else f"{got[0]:.4f} ms")
            + f", plain {p_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}){at_f32} [{card}]")
        if variant == "base":
            ms["attempt_tiles"], plain_ms["attempt_tiles"], bounds["attempt_tiles"] = k_ms, p_ms, bnd
    spec13 = et.parse_variant("base")
    best13 = et.sync_plain(spec13, *exp_in["tiles"][:3])[3]
    c13 = torch.arange(et.NV, device=dev)
    rows13 = (9 * (c13 % 8) + c13 % 2)[:, None] + torch.arange(et.BROWS + 1, device=dev)
    lhs = xt13[:, rows13].reshape(-1, et.BROWS + 1, et.DROW)
    o2 = (53 * c13 + best13) % et.DROW
    rhs = tables13[2][(o2 % 8)[..., None], (o2 - o2 % 8)[..., None] + torch.arange(
        et.DROW, device=dev)].reshape(-1, et.DROW, 256)
    bmm_ms = time_ms(torch, lambda: torch.bmm(lhs, rhs), runs=10)
    log(f"phase 4: attempt_tiles yardstick: torch.bmm of the base body products "
        f"({lhs.shape[0]} x [{et.BROWS + 1}, {et.DROW}] @ [{et.DROW}, 256], TF32 off) "
        f"{bmm_ms:.4f} ms [{card}]")
    del lhs, rhs
    xo, to = exp_in["offset"]
    for form in eo.FORMS:
        k_ms = time_ms(torch, lambda: eo.offset_add(form, xo, to))
        p_ms = time_ms(torch, lambda: eo.offset_add_plain(form, xo, to))
        bnd = offset_bound(form)
        log(f"phase 4: offset_add {form}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{bnd[0]:.6f} ms ({bnd[1]}) [{card}]")
        if form == "A":
            ms["offset_add"], plain_ms["offset_add"], bounds["offset_add"] = k_ms, p_ms, bnd

    def matmul_add():
        o = xo @ to
        return o[0:32, :128] + o[1:33, 128:]

    library_ms["offset_add"] = time_ms(torch, matmul_add)
    log(f"phase 4: offset_add A yardstick: torch.matmul + the sliced add (two calls, TF32 off) "
        f"{library_ms['offset_add']:.4f} ms [{card}]")
    # the robustness paths end to end, one capture each, and the sweeps
    (xs_r, _), (xg_r, _), (xd_r, _), (xgg_r, _) = robust_in
    robust_calls = {
        "decode_with_clock_search": (lambda: timing.decode_with_clock_search(
            cfg, xs_r, LOCAL_ADDR, max_frames=MAX_FRAMES), xs_r.shape[0], RUNS),
        "decode_with_timing_gate (quiet-padded corpus)": (lambda: timing.decode_with_timing_gate(
            cfg, xg_r, LOCAL_ADDR, max_frames=MAX_FRAMES), xg_r.shape[0], 10),
        "decode_with_timing_gate (flagship gaps)": (lambda: timing.decode_with_timing_gate(
            cfg, xgg_r, LOCAL_ADDR, max_frames=MAX_FRAMES), xgg_r.shape[0], 10),
        "decode_capture_dd": (lambda: equalizer.decode_capture_dd(
            cfg, xd_r, LOCAL_ADDR, max_frames=DD_FRAMES + 8), xd_r.shape[0], 5),
        "ber_sweep": (lambda: ber.ber_sweep(cfg), None, 3),
        "clock_offset_sweep": (lambda: ber.clock_offset_sweep(cfg, ppms=SWEEP_PPMS), None, 3),
    }
    for what, (fn, n_samples, runs) in robust_calls.items():
        med = time_ms(torch, fn, runs=runs)
        rt = "" if n_samples is None else (
            f", {n_samples / cfg.sample_rate / (med / 1e3):.1f}x real time of its capture")
        log(f"phase 4: {what}: {med:.4f} ms (median of {runs}){rt} [{card}]")
    # their steps: the search's resample and batch decode; the gate's exact
    # decode and dense correlation (the rest is its retry batch and host
    # work); the decision-directed decode's bootstraps, one host refit on
    # its final frames and one refit decode
    grid_r = -torch.tensor(timing.PPM_GRID, device=dev)[:, None]
    y_r = channel.clock_offset(xs_r, grid_r)
    dd_res = equalizer.decode_capture_dd(cfg, xd_r, LOCAL_ADDR, max_frames=DD_FRAMES + 8)
    dd_valid = dd_res.valid.cpu().numpy()
    rx_r = xd_r.cpu().numpy()
    h_r, lam_r = equalizer.refit_channel(cfg, rx_r, dd_res.to_frames(),
                                         dd_res.start.cpu().numpy()[dd_valid])
    g_r = torch.from_numpy(equalizer._mmse_taps_np(h_r, lam_r)).to(dev)
    robust_steps = {
        "clock search: clock_offset of the grid": lambda: channel.clock_offset(xs_r, grid_r),
        "clock search: decode_capture_fast of the grid": lambda: decode_capture_fast(
            cfg, y_r, LOCAL_ADDR, max_frames=MAX_FRAMES),
        "timing gate: decode_capture_fast": lambda: decode_capture_fast(
            cfg, xg_r, LOCAL_ADDR, max_frames=MAX_FRAMES),
        "timing gate: auto_xcorr": lambda: auto_xcorr(xg_r, pre),
        "decode_dd: decode_capture_eq": lambda: equalizer.decode_capture_eq(
            cfg, xd_r, LOCAL_ADDR, max_frames=DD_FRAMES + 8),
        "decode_dd: stock exact scan": lambda: decode_capture(cfg, xd_r, LOCAL_ADDR,
                                                              DD_FRAMES + 8),
        f"decode_dd: refit_channel on {int(dd_valid.sum())} frames (host)": lambda: (
            equalizer.refit_channel(cfg, rx_r, dd_res.to_frames(),
                                    dd_res.start.cpu().numpy()[dd_valid])),
        "decode_dd: _apply_taps_decode": lambda: equalizer._apply_taps_decode(
            cfg, xd_r, g_r, LOCAL_ADDR, DD_FRAMES + 8),
    }
    for step, fn in robust_steps.items():
        log(f"phase 4: {step}: {time_ms(torch, fn, runs=5):.4f} ms (median of 5) [{card}]")
    time_stream_paths(torch, sd, PhyDecoder, lstream, cfg, cfg4, mac_in, rec_segments, card,
                      dev)
    time_ofdm_paths(torch, ofdm, ofdm_v2, x_o, ofdm_buckets, card, dev)
    vit = time_coded_paths(torch, coded, convcode, coded_phy, x_c, coded_buckets, card)
    time_adaptive_paths(torch, ofdm_adaptive, convcode, ofdm, x_a, adaptive_buckets, card)
    time_mesh_paths(torch, stream, mesh_mod, ofdm_stream, decoder_mod, cfg, xb, x, mesh_in, card)
    ms["viterbi"], plain_ms["viterbi"], bounds["viterbi"] = vit["ms"], vit["plain_ms"], vit["bound"]
    log(f"phase 4: viterbi: {launches['viterbi']} launches on the paths, launches x (device - "
        f"bound) at the payload shape {launches['viterbi'] * (vit['device'] - vit['bound'][0]):.4f}"
        f" ms [{card}]")
    # the multi-process dry run after the profiler's last session: its
    # processes share the card; its launches are the processes' own counts
    for k_name, n in run_multiprocess(torch, frames, args.seed).items():
        launches[k_name] = launches.get(k_name, 0) + n
    t_phase4 = time.perf_counter()
    # registers and spills last: cuobjdump runs as a child process, and the
    # profiler's sessions after one lose their last launches
    for src in ("sliding_dot", "xcorr_norm", "xcorr_hits", "spec_walk", "attempt_manchester",
                "attempt_4b5b", "ask_walk", "ask_fire", "ask_chain", "attempt_tiles",
                "xcorr_streams", "seq_probe", "offset_add", "viterbi"):
        for fn_name, res in kernel_resources(_build, src).items():
            require(res["LOCAL"] == 0, f"{fn_name} in {src}.cu spills ({res})")
            log(f"phase 4: {src}.cu {fn_name}: {res['REG']} registers, {res['LOCAL']} bytes of "
                f"local memory (spills), {res['SHARED']} bytes of static shared memory, "
                f"{res['STACK']} bytes of stack (cuobjdump -res-usage); in its SASS "
                + ", ".join(f"{res[op]} {op}" for op in SASS_OPS) + " (cuobjdump -sass)")

    replaces = {
        "seq_probe": "bench.py:200",
        "attempt_tiles": "tools/exp_attempt_tiles.py:35",
        "offset_add": "tools/exp_offset_add.py:24/30/41",
        "xcorr_hits_2s": "tools/exp_xcorr_streams.py:50",
        "attempt_sum": "tools/prof_fused.py:123",
        "xcorr_hits": "trackmaker_tpu/sync/pallas_xcorr.py:148",
        "attempt_manchester": "trackmaker_tpu/phy/pallas_decode.py:207",
        "attempt_4b5b": "trackmaker_tpu/phy/pallas_decode.py:409",
        "spec_walk": "trackmaker_tpu/phy/pallas_decode.py:609",
        "sliding_dot": "trackmaker_tpu/sync/pallas_xcorr.py:93",
        "ask_fire": "trackmaker_tpu/phy/ask_spec.py:64",
        "ask_chain": "trackmaker_tpu/phy/ask_spec.py:221",
        "ask_walk": "trackmaker_tpu/phy/ask_spec.py:455",
        "xcorr_rowstats": "trackmaker_tpu/sync/pallas_xcorr.py:640",
        "normalized_xcorr": "trackmaker_tpu/sync/pallas_xcorr.py:93",
        "xcorr_hits_refine": "trackmaker_tpu/sync/pallas_xcorr.py:298",
        "xcorr_hits_batched": "trackmaker_tpu/sync/pallas_xcorr.py:513",
        # the fold_sync branches of the attempt kernels
        "attempt_manchester_fold": "trackmaker_tpu/phy/pallas_decode.py:207",
        "attempt_4b5b_fold": "trackmaker_tpu/phy/pallas_decode.py:409",
        # the shared_x branches (bx = 0 if shared_x else b), legacy and fold
        "attempt_manchester_shared": "trackmaker_tpu/phy/pallas_decode.py:219",
        "attempt_manchester_fold_shared": "trackmaker_tpu/phy/pallas_decode.py:219",
        "attempt_4b5b_shared": "trackmaker_tpu/phy/pallas_decode.py:419",
        "attempt_4b5b_fold_shared": "trackmaker_tpu/phy/pallas_decode.py:419",
        # no Pallas counterpart: the JAX package's Viterbi is a lax.scan
        "viterbi": "trackmaker_tpu/core/convcode.py:164",
    }
    log(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s in all, cuobjdump's "
        f"{time.perf_counter() - t_phase4:.1f} s included")
    print(json.dumps({"kernels": [
        {"name": k_name, "route": "cuda",
         "source": f"trackmaker_tpu_torch/csrc/{SOURCES.get(k_name, k_name)}.cu",
         "replaces": replaces[k_name], "launches": launches[k_name],
         "max_abs_err": errs[k_name], "ms": ms[k_name], "plain_ms": plain_ms[k_name],
         "bound_ms": bounds[k_name][0], "bound_by": bounds[k_name][1],
         # the sliding dot has one PyTorch call computing the same function
         # (conv1d), the normalized correlation two (conv1d for the dot and
         # for the energy), offset add two (matmul and the sliced add); none
         # computes any of the others
         "library_ms": library_ms.get(k_name)}
        for k_name in ms]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
