#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through their hand-written CUDA
kernels, which it first builds from ``sdrplusplusbrown_tpu_torch/csrc``:

  * broadcast FM — ``Radio.apply_shared`` on the WFM-8 configuration (one
    2.4 MS/s wideband, 8 stereo WFM VFOs, a 65 536-bin spectrum at 20 fps,
    240 000-sample steps): K1 front end, K2 WFM demod, K3 audio polyphase,
    K4 spectrum;
  * the wide-bank NFM scanner — ``Radio.apply_channelized`` on the
    scanner128 configuration (bench.py:build_scanner: 128 squelched NFM
    channels at linspace(−1.1, 1.1) MHz + 917 Hz on the same wideband),
    and one step of scanner256: K5 PFB, K6 post-channelizer, K7 demod +
    audio;
  * the app's per-radio step — ``IQFrontEnd.apply`` (2.4 MS/s, decimation
    1, 65 536-bin spectrum at 20 fps) then ``Radio.apply`` for a WFM and
    an NFM radio with the squelch on, as the app builds them, and for 8
    WFM radios batched: K8 FIR rows (every decimator, polyphase and FIR
    stage), K9 complex-tap FIR (the WFM pilot band-pass of one radio),
    K10 stereo section (batched WFM), K4f spectrum of the complex block;
  * channelizer64 — bench.py:build_channelizer64 (BASELINE config 4): a
    10 MS/s wideband through ``PolyphaseChannelizer(10 MS/s, 64)
    .apply_planes`` (K5's critically sampled form, K5c) and every
    channel's 1024-bin dB spectra through ``fft_power_db_planes`` (K4's
    one-pass route batched over rows, K4r), 2^21-sample steps;
  * the served app — ``SDRApp`` (and ``python -m
    sdrplusplusbrown_tpu_torch``) on a 2.4 MS/s WAV capture through a
    file source: ``IQFrontEnd`` with the DC blocker (fft 65 536 at 20
    fps), then ``Radio.apply`` for a WFM, an NFM and a squelched NFM
    radio on ~120 000-sample blocks, audio through the sink layer to a
    recorder, driven in manual pump mode in process and over HTTP, and
    with its pump thread in real time: K4f, K8, K9, K15 (the DC
    blocker's linear recurrence);
  * the noise path — BASELINE config 3 (tests/test_e2e_ssb_nr.py's HF
    voice capture at 96 kS/s through the served app, a USB radio at +10
    kHz with ``set_afnr logmmse`` then ``omlsa``), the IF NR
    (``IFNRLogMMSE``) on the served 2.4 MS/s capture with ``ifnr: true``,
    the noise blanker on a WFM radio and the FM IF filter on an NFM
    radio: K4f, K8 (the AF NR's moving average among its calls), K9,
    K12, K14 (LogMMSE's frame recursions, IF and AF), K15 (the DC
    blocker and the noise blanker's envelope);
  * RDS and the Radio's other forms — a WFM radio with the scan PLL
    (``Radio(pll_mode="scan")``: K13's PLL form), the served app on a
    2.4 MS/s capture of a stereo station carrying RDS with two WFM radios
    decoding it (``rds: true`` in the config, ``set_rds 1`` over HTTP):
    the RDS tap (K8), ``RDSDemod`` (K12's complex form, K13's Costas and
    M&M forms, K9) and the host ``RDSDecoder``, with K4f, K8, K9 and
    K15;
  * the served app over the network — ``python -m
    sdrplusplusbrown_tpu_torch --server --rigctl`` streaming the served
    capture, and the app on an ``sdrpp_server`` source (the IQ stream
    server's client) fed by an in-process ``StreamServer`` in its raw
    float32, int8 and EFFT modes: K4f, K8, K9, K15; beside it the device
    EFFT (``ops/efft_device.py``) and the device feed (``io/feed.py``),
    which are PyTorch ops;
  * the multi-mode bank — ``RadioBank.apply(..., mono_out=True)`` on
    multimode8 (bench.py:build_multimode8, BASELINE config 2: 4 NFM, 2 AM
    and 2 USB VFOs on one 2.4 MS/s wideband, 240 000-sample steps) and on
    the same VFOs at 10 MS/s (1 040 000-sample steps): K1 (or K11 then
    K8 where K1 cannot take the chain: every group at 10 MS/s), K7 for
    NFM, K8 and the AGC kernel K12 for AM and USB;
  * the sources, sinks and transmitter — the transmit path
    (``models/trx.py``: ``TxChain``, its AGC on K12 and ``SSBMod``'s 651
    complex taps on K9; ``ServerTxPath``, the stream server's 6 k → 48 k
    resampler on K8), the served app on an rtl_tcp source (phase 19's
    capture, uint8 at 2.4 MS/s) and on a Hermes Lite 2 (384 kS/s, its RX
    frames and, keyed by rigctl, the TX audio of a stream client), each
    fed by a fake peer in a process of its own, and the network and MPEG
    sinks: K4f, K8, K9, K12, K15.
  * the wideband decoders — the app's ``weather_sat_decoder`` (NOAA
    HRPT: K12c, K13's PLL form, K8, K13m's real form), ``falcon9_decoder``
    (K8, K13m), ``atv_decoder`` (K12c), ``dab_decoder`` and
    ``vor_receiver`` (K8), each through its RxVFO on K8 and served from a
    capture at its users' source rate, the spectrum on K4f;
  * the voice and trunking decoders — the app's ``ch_extravhf_decoder``
    (DMR, P25, D-STAR and the CTCSS/DCS carriers: its RxVFO on K8,
    ``FourFSKDemod`` on K8 and K13m's real form, the D-STAR header's
    Viterbi on K16) and ``ch_tetra_demodulator`` (a TETRA downlink:
    ``Pi4DQPSKDemod`` on K12c, K8 and K13m's complex form, one RxVFO
    granule a call) served from one 2.4 MS/s capture, the spectrum on
    K4f; POCSAG through ``GFSKDemod`` (K8, K13m).

Phases, each fatal on failure:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build and its time;
  3. K1-K4 each against its plain PyTorch version on the same inputs, at
     the WFM path's shapes on a stereo FM signal, float32 handoff; both
     timed with CUDA events, K3 and K4 beside one library call (conv1d,
     TF32 off; torch.fft.fft) with its device time; K4's route and
     launches a call held to ``fft_kernel.plan``; K1's device time split
     into its mix stage and its chained stages, K2's launches a call;
     K1's and K2's new carried state exactly the plain version's rule on
     the kernels' own stage inputs (``tails_exact``);
  4. three WFM steps with a retune before the third, in the production
     bf16 handoff, the launch counts zeroed just before: every kernel
     launched, each wrapper's count held to its calls' planned CUDA
     launches (``hold_launches``: K1 one for stage 0 and one a chained
     stage, K2 three, K4 its FFT route's), finite outputs, the audio oracles (tone SNR, stereo
     separation), spectrum peaks on the carriers, and bf16 audio within
     45 dB of the float32 run;
  5. the WFM-8 step on bench-style noise input: its rate, its wall time
     and a profiler window (see ``step_rate``), its kernel launches a
     step beside the 87 before K1 and K2 ran on the FIR tile;
  6. K5-K7 each against its plain version at the scanner128 shapes on an
     NFM signal (a 1 kHz tone on every 8th channel), float32 handoff,
     timed with CUDA events; K7's every output (bit-identical or 80 dB);
     K6's and K7's device time by launch (profiler) and CUDA launches a
     call (their wrappers count each; held to
     ``chan_frontend.chan_post_plan`` and ``demod_kernel.fm_plan`` and to
     the profiler's count), their new tails as in 3; one conv1d (TF32
     off) of K6's 304-tap stage alone beside K6's bandwidth launch, as a
     yardstick; K5's and K6's device µs a call beside the bound and the
     earlier design's recorded time;
  7. three scanner128 steps with a retune before the third, bf16 handoff,
     the counts zeroed just before: K5, K6 and K7 one call each per step
     (one CUDA launch a call for K5, two for K6 and K7, each held to its
     plan), exactly the tone channels open, their tone SNR;
  8. one scanner256 step: K5-K7 one call each, each against its plain
     version; K6's and K7's launches and tails as in 6;
  9. the scanner128 step (bf16, raw audio) on the same noise, as in 5,
     its launches a step beside the 55 before K6 ran on the FIR tile;
 10. K8, K9, K10 and K4f each against its plain version at the app
     step's shapes (K8 on every distinct geometry the three runs of 11
     give it, each timed, with its launches a step on each path; K9
     on the pilot band-pass; K10 at C = 8; K4f at 65 536 and 262 144
     points), float32, timed with CUDA events beside one PyTorch library
     call computing the same function (conv1d, TF32 off; torch.fft.fft);
     each K4f call's route, launches and per-kernel device time, the
     launches held to ``fft_kernel.plan``; K9's device µs a call beside
     its bound and the earlier design's recorded time;
 11. the app step, three steps with a retune before the third, the
     launch counts zeroed just before: WFM at batch () (K4f, K8, K9
     launched, K10 not; tone SNR, stereo separation, spectrum peaks on
     the carriers), NFM at batch () (tone SNR; a second radio off the
     signal, squelch at −30 dB, gives exact zeros), WFM at batch (8,)
     (K10 launched, K9 not; per-radio oracles); each wrapper's count
     held to its calls' planned CUDA launches (K4f its FFT route's);
 12. the app step's rate, wall time and profiler window (``step_rate``),
     WFM at batch () and at (8,), on noise, and what ``Radio.apply``'s
     discriminator costs on the card (``quad_cost``);
 13. the bank's kernels against their plain versions at its shapes,
     every tensor each returns (IF or audio, new tails, state): K1 on
     each 2.4 MS/s group's call (its new tails also held as in 3) and K7
     on each bank's NFM call (its tails, launches and device time by
     launch as in 6), in the float32 and again in the bf16 handoff (100
     dB, 45 dB for a bf16 output); K11 on every 10 MS/s group call, K12
     on each AM and USB shape of both rates (each with its device µs a
     launch beside its chain floor: T steps of CHAIN_CYCLES dependent
     cycles at the SM clock), timed with CUDA events (K11 beside one
     conv1d, TF32 off; K11's device µs a call beside its bound and the
     earlier design's recorded time); every distinct K8
     geometry of the two bank paths, each timed, with its launches a
     step on each bank;
 14. five steps of each bank, the launch counts zeroed just before each:
     at 2.4 MS/s K1, K7, K8 and K12 launched and K11 not, at 10 MS/s K11,
     K7, K8 and K12 and K1 not, each wrapper's count held to its calls'
     planned CUDA launches (K1 one for stage 0 and one a chained stage,
     K7 two); on step 5 (the AGC's 4 800-sample start
     ramp long over) the 1 kHz tone SNR of every VFO against the same
     five steps of the port's plain path on the host CPU, less 3 dB;
 15. each bank's step on bench-style noise, as in 5 (``step_rate``);
 16. K5c and K4r against their plain versions at channelizer64's shapes
     (M = 64, tpp = 19, T = 2^21, W = 32 768; 64 channels × 32 frames of
     1 024), in the float32 and the bf16 handoff (100 dB, 45 dB for bf16
     bins; the spectra's dB bars), the bf16 one timed with CUDA events
     beside one torch.fft.fft call (K4r; its route and launches a call,
     one, held to ``fft_kernel.plan``), K5c's device µs a call beside
     its bound and the earlier design's recorded time, and what K5c's
     fold and tensor-core DFT cost as written (``k5_as_written``);
 17. three channelizer64 steps on tones at every 8th channel's centre +
     20 kHz over noise, bf16 handoff, the counts zeroed just before: K5c
     and K4r one launch a step, K5, K4, K4f, K1 and K11 none; each tone peaks
     at its bin in its own channel, the others stay at the noise floor,
     the state is the block's last samples;
 18. the channelizer64 step on bench.py's noise (seed 1), as in 5.

 19. the served app in process: a 2.4 MS/s capture (the APP_WFM stations,
     the APP_NFM carriers, a DC offset of 0.1) written under a temp dir,
     ``SDRApp(root, run_pump=False, device=cuda)`` in manual pump mode
     with the DC blocker, fft 65 536, a WFM, an NFM and a squelched
     (−30 dB) NFM radio off the signal, a recorder on the WFM stream;
     the launch counts zeroed, six blocks, a retune (``set_vfo_offset``)
     and a ``set_demod`` round trip (NFM → USB → NFM) between blocks 3
     and 4: K4f, K8, K9 and K15 launched and held to their calls'
     planned launches, every other kernel not; the WFM tone SNR and
     separation and the NFM tone SNR (phase 11's bounds) on blocks 3 and 6, the
     squelched radio exactly zero, ``get_snr`` finite and over 20 dB on
     the carriers, spectrum peaks on them; the baseband's DC bin at least
     30 dB under the same run's without the blocker; the recording read
     back equals the audio events as 16-bit PCM;
 20. ``python -m sdrplusplusbrown_tpu_torch --root --http --autostart``
     (the default device, cuda) as a subprocess on the same capture,
     manual pump: /status, /pump/step, /sdr/status progress, set_demod,
     get_demod, set_vfo_bandwidth, get_snr, get_spectrum, /sink/select
     with a recorder, /exit; exit code 0 and the log's start line names
     the CUDA device;
 21. the same app with its pump thread on the looping capture for 10 s:
     blocks processed, /status's rtFactor and secondsBehind, each
     block's wall time through a sync (percentiles), then a profiler
     window of 20 blocks (device µs and launches a block, idle share,
     host↔device copies a block), and the DC blocker alone on one
     block's baseband (device µs and launches: K15's dc form, one);
     fails unless rtFactor < 1, the p99 block is within the block's
     duration and the blocker is one launch.
 22. BASELINE config 3 in process: the HF voice capture (USB voice at +10
     kHz, 6 dB SNR, 96 kS/s) through ``SDRApp`` on the card, manual pump,
     a USB radio and a recorder; recordings with the AF NR off (5 s of
     audio), then ``set_afnr logmmse`` and ``set_afnr omlsa`` (4 s
     each), each held to tests/test_e2e_ssb_nr.py's bars (S/N up by more
     than 5 dB, the speech band down by no more than 6 dB), the launch
     counts zeroed before each NR recording (K4f, K8, K12 and, with
     logmmse, K14 launched and held to their calls' plans, every other
     kernel not; K14 against its plain version there); K8 against its
     plain version at the AF NR's moving-average shapes, timed; each
     mode alone on one block of audio (device µs, launches); ``get_afnr``
     reports the mode at the end and the log has no ``afnr error``; then
     ``IFNRLogMMSE`` on the card on tests/test_logmmse.py's wideband
     signal: carrier gain 12 ± 1.5 dB, SNR gain over 10 dB;
 23. the noise path at full width: the capture of phases 19-21 with
     ``ifnr: true``, ``set_nb on`` on the WFM radio and ``set_fmif on``
     on the NFM radio, six blocks on the card and on the host CPU (float32
     handoff, the real-time guard held still): the baseband and each
     radio's audio agree to 80 dB in every block, the WFM and NFM tone
     SNRs reported, K4f, K8, K9, K14 and K15 launched and held to their
     plans (K14 once more for the IF NR's priming), K14 (the IF NR's
     last block; its device µs with the hand-over and with the rings
     copied first, whose window must show the two ring-sized copies) and
     K15 (the DC blocker's and the noise blanker's last calls, each one
     launch, each fused form also against the unfused route: K15's scan
     form, then the block's torch ops) against their plain versions, each
     timed beside its bound, these launches their report's; then
     the threaded pump for 10 s as in 21 (block wall percentiles once
     the IF NR is primed, the profiler window, the guard's clock held
     still while it is open and its trace is processed; the window's
     device-to-device copies, none a whole 76.8 MB ring), and the IF NR
     alone on one block (device µs, launches; a warmed-up profiler
     window of 10 such blocks, each on the state the previous returned,
     with no whole-ring copy); fails if the guard shed the IF NR, read at
     the end of the 10 s and after the profiler window, a window holds a
     ring's copy, or the p99 block exceeds its duration.
 24. RDS's loops and the Radio's forms: K13's PLL form on the scan-PLL
     radio's 6 250-sample MPX block (``Radio(pll_mode="scan")`` at 2.4
     MS/s, four 50 ms blocks, the counts zeroed before: K13p one launch
     a block, K2 and K10 none; tone SNR > 35 dB, separation > 25 dB),
     K12's complex form and K13's Costas and M&M forms on ``RDSDemod``
     at the served block's RDS shapes (a WFM radio with ``rds`` on the
     RDS station), each against its plain version (bit-identical; K12c
     within 100 dB with its state exact), timed with CUDA events (the
     kernel's median and range over LOOP_RUNS runs, the plain loop over
     2 calls) beside its chain floor (the steps at the fewest cycles a
     step that the chain, clocked on the kernel, took in any run, at the
     fastest SM clock: the card's maximum or the fastest measured);
     mono WFM, RAW and NFM with 50 µs de-emphasis through
     ``Radio.apply``, and ``AMDemod(carrier_agc=True)``, three blocks
     each on the card against the host CPU, >= 80 dB;
 25. the served app with RDS: a 3.6 s capture at 2.4 MS/s of a stereo
     station carrying RDS (PI 0xABCD, PS "TESTFM  ", RT "HELLO RADIO
     TEXT"), two WFM radios on it, W with ``rds: true`` in config.json,
     V switched on by ``set_rds 1`` over HTTP before block 3, manual
     pump (blocks of the RDS granularity), ``get_rds`` over HTTP after
     each block: each radio synced with PI, PS and RT exact within 3 s
     of signal from its switch-on; the counts zeroed before: K4f, K8,
     K9, K12c, K13c, K13m and K15 launched and held to their calls'
     planned launches, every other kernel not; K12c, K13c and K13m
     against their plain versions at the served shapes, K15 at the
     block's 480 000-sample DC blocker too (timed, and against the
     unfused route); both radios'
     tone SNR and separation (phase 19's bars); then the threaded pump with RDS on
     both for 10 s as in 21 (``pump_in_real_time``: rtFactor, the block
     wall percentiles, the profiler window's device µs, launches and
     device-to-host copies a block); fails unless the p99 block wall
     time is under 50 ms.
 26. the network path, timed with CUDA events and the wall clock (no
     profiler window): (a) ``python -m sdrplusplusbrown_tpu_torch
     --server --port --rigctl --http`` on phase 19's capture: /status, a
     client's handshake and three int8 blocks, rigctl F, f, M and m,
     /exit and exit code 0; (b) the app of phase 19 (its WFM, NFM and
     squelched NFM radios) on an ``sdrpp_server`` source, a fresh
     in-process server a mode: ``none``, manual pump, six blocks, every
     radio's audio bit-identical to the same app fed from the file, the
     counts zeroed before (K4f, K8, K9 and K15 launched and held to
     their plans, every other kernel not); ``int8``, six blocks, phase 19's
     oracles and the server's host compression time; ``int8`` with the
     pump thread for 5 s, fed by a server that is a process of its own
     (``python -m sdrplusplusbrown_tpu_torch --server --device cpu``, as
     a client meets it in use: secondsBehind 0, each block's time from
     its last samples' arrival to its end through a sync, p99 under the
     block's 50 ms, the received MS/s); ``efft`` on 40 frames of 65 536,
     not paced (the server's host EFFT rate, the zeroed share, the WFM
     tone SNR over NET_EFFT_WFM_BAR); (c) ``EFFTCompressorDevice`` at 2.4
     MS/s (32 frames of 65 536) on the card against the host CPU (masks
     equal, emits >= 60 dB), its CUDA-event ms and kernel launches a
     call (a CUDA graph captured around it), and ``DeviceFeed`` in its
     three modes on the card against the host CPU with
     tests/test_efft_device.py's bars.
 27. every demod through the channelized bank (``drive_modes``).
 28. the sources, sinks and transmitter (``drive_trx``): (a) the TX path
     with the counts zeroed (``TxChain`` USB and FM on 1 s of audio,
     ``ServerTxPath`` on ten 200 ms wire blocks: K8 ten launches, K9 one,
     K12 two, every other kernel none; the USB output single-sideband,
     the FM output on the unit circle, the packets against the host
     CPU's), then K8 at the resampler's wire block, K9 at SSBMod's 48 000
     samples and K12 at TxChain's 48 000-sample AGC against their plain
     versions, timed beside their bounds and conv1d; (b) phase 19's app
     on a fake rtl_tcp server process (the capture quantized to uint8,
     paced at 2.4 MS/s), manual pump: every radio's audio and spectrum
     line bit-identical to the app on a file of the quantized samples,
     the commands logged (sample rate, frequency, gain mode, gain
     index); then 5 s of the threaded pump (block p50 / p99,
     secondsBehind < 1 s); (c) the app on a fake Hermes Lite 2 process
     at 384 kS/s (an NFM tone in its RX frames > 40 dB) with the stream
     server and rigctl: ``T 1``, 2 s of a 1 kHz TX tone from a stream
     client at 6 kHz, the fake's 48 kHz MOX frames > 40 dB and within
     0.5 dB of the host CPU's TX path, ``t`` answering 1; (d) the network
     sink (UDP int16) and the MPEG sink (TCP) to local listeners, each
     tone within 1 dB of the recording's (the MPEG stream byte for byte
     the host's Layer I encoding); (e) no thread or socket left.
 29. the digital decoders (``drive_decoders``): (a) K16 (the Viterbi) at
     M17's LSF and stream lengths, KG-SSTV's frame, nine RyFi frames, a
     D-STAR header (K = 3) and a K = 9 frame (both of K16's forms: one
     warp a frame to 64 states, a block a frame above), on hard and on
     soft input, and K13f at 20 000 samples, each against its plain
     version (bit-identical), timed beside its chain floor as in 24 (K16's
     trellis and traceback clocked apart); the digital
     demods' blocks (``FDClockRecovery``, ``FourFSKDemod``,
     ``Pi4DQPSKDemod``) on the card with the counts zeroed; (b) the
     served app in manual pump on a 0.8 s capture at 2.4 MS/s carrying an
     M17 station, a KG-SSTV burst, a RyFi link at 240 kBd (``channel_sr``
     720 kS/s), a Meteor QPSK carrier and a "broken" one at 72 k sym/s,
     an ``m17_decoder``, ``kg_sstv_decoder``, ``ryfi_decoder`` and two
     ``meteor_demodulator`` modules (one with ``broken: true``)
     recording: the LSF's callsigns and all 14 stream payloads exact,
     the KG-SSTV frames and RyFi packets exact with no bad frame, the
     QPSK decisions after lock equal to the sent symbols up to rotation,
     the broken carrier within a median 25° of its phases; the counts
     zeroed before: K4f, K8, K12c, K13c, K13b, K13m and K16 launched and
     held to their plans, every other kernel not; K13b timed on the
     served block; the served calls that span K13m's 4 096-sample tiles
     (a Meteor module's K12c, K13c and K13m at 15 000 samples, RyFi's
     K13m at 72 000) and the last K16 call bit-identical to their plain
     versions (K12c: 100 dB, its state exact); each module's launches,
     and device µs a 0.1 s block; the Meteor recordings against the same
     modules on the host CPU (every value within one step, 60 dB); (c)
     RyFi at its default 720 kBd on 1.5 MS/s over 2 s of signal: every
     packet exact, the wall seconds a second of signal split into the
     card's (device µs by kernel) and the host's (deframer, RS).
 30. the wideband decoders (``drive_wideband``): (b) the JAX package's
     slow tests' RF loopbacks through each module on an app on the card
     at its channel rate, the counts zeroed before each: HRPT's two frames
     at 3 MS/s (every pixel and the TIP words exact; K8, K12c, K13p,
     K13m), Falcon 9's frame at 6 MS/s (the packet exact; K8, K13m), VOR
     at 25 kHz at three azimuths (the last two 1 s windows within 2 deg,
     quality > 90 %) and on noise (quality < 50 %; K8), ATV's 2 352 lines
     at 14.77 MS/s (lock > 750, a frame, mid-row correlation > 0.9;
     K12c) and DAB's 30 frames at 2.048 MS/s (25 frames seen, the CFO
     within 60 Hz, dibits > 85 %; host only), the loop kernels' calls
     captured; (a) K13p and K12c at HRPT's 1 x 300 000, K12c at ATV's
     1 x 590 625 and K13m at HRPT's 300 000 and Falcon 9's 600 000
     samples, each on its last loopback call: clocked at the full shape
     (ms, device µs, cycles a step beside the chain floor), then against
     its plain version on a prefix of that call in two blocks, the second
     from the state the kernel returned (every output and state bit for
     bit; K12c's output 100 dB; K13m's plain version on a host CPU copy);
     (c) each module served by the app in manual pump on a capture at its
     users' rate (HRPT on 6 MS/s, Falcon 9 on 10 MS/s, ATV on 20 MS/s,
     DAB on 2.4 MS/s, VOR on 250 kS/s; fft 65 536 at 20 fps, 8 192 for
     VOR), each delivering (b)'s product (Falcon 9: 41 back-to-back
     frames, every packet); the counts zeroed before: the module's
     kernels and K4f launched and held to their plans, every other kernel
     not; each module's launches, device µs and loop kernels' share a
     0.1 s block, its handler's wall and its host stages' seconds a second
     of signal.
 31. the voice and trunking decoders (``drive_voice``): (b) one app on a
     1.5 s capture at 2.4 MS/s (``voice_capture``: a DMR base station, a
     P25 station, a D-STAR station, NFM carriers with CTCSS 100.0 Hz and
     DCS 023, a TETRA downlink), fft 65 536, 30 manual 50 ms blocks, five
     ``ch_extravhf_decoder`` modules and a ``ch_tetra_demodulator``, the
     counts zeroed before: K4f, K8, K12c, K13m and K16 launched and held
     to their plans, every other kernel not; every product held (the DMR
     embedded, short and full LC with the standard RS(12,9), the CSBK,
     the P25 NAC, LDU1 LC, NET_STS_BCST at a mid read and the signed
     IDEN_UP after a bad block, the D-STAR callsigns with crc_ok, the
     tone and the code, the TETRA cell and "HELLO TPU") and equal to the
     same app's on the host CPU (a subprocess, ``voice_cpu_main``, its
     TETRA module to the mid read); (c) each module's launches, device
     µs and loop share a 0.1 s block, its handler's wall and host stages'
     seconds a second of signal; (a) K13m at DMR's 0.1 s block, K12c and
     K13m at TETRA's 24-sample granule and at 0.1 s (150 granules side by
     side, ``joined_call``), each clocked and held bit for bit to its
     plain version on two blocks with the state carried, and K16 at K = 3
     on a D-STAR header with 6 errors; POCSAG's page through
     ``GFSKDemod`` on the card.

The main-path runs of phases 19 and 21-31 run inside ``no_plain_on_card``:
a plain version of K5, K6, K8, K9, K12, K13, K14, K15 or K16, or
LogMMSE's plain ``_push_history``, given a CUDA tensor fails the run.
Every ``launches`` count is of CUDA launches: each wrapper counts every
launch it makes (``kernels/_build.py``).  Beside each CUDA-event time
(which, for a kernel shorter than its wrapper's host work, is the
wrapper's time) every comparison prints the kernel's device time per
call from a torch.profiler window.  Each
kernel's bound is the larger of the bytes its function must move
over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the H100 SXM's
published HBM and non-tensor FP32 rates).  The next-to-last line is a
JSON report of the kernels (an app-step kernel's ``launches`` are those
of the path it was timed on, with every path's count beside them, the
served app's among them); the
last line, printed only when every phase
passed, is the device JSON.  Without a CUDA device, or without the
package beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

FS = 2_400_000.0
C = 8
FFT = 65_536
STEP = 240_000
OFFSETS = np.linspace(-1.0e6, 1.0e6, C)
RETUNE = OFFSETS + np.array([0, 40e3, -25e3, 0, 10e3, 0, -60e3, 0])
TONE_HZ = 1000.0

SCAN_C = 128
SCAN_WIDE_C = 256
SCAN_OFFSETS = np.linspace(-1.1e6, 1.1e6, SCAN_C) + 917.0
SCAN_TONES = list(range(0, SCAN_C, 8))
# the retune moves the channels half-way between tone channels by 3 kHz
SCAN_RETUNE = SCAN_OFFSETS + np.where(np.arange(SCAN_C) % 8 == 4, 3e3, 0.0)
SQUELCH_DB = -30.0

# the app step: two stereo stations and two NFM carriers (1 kHz tone);
# each radio moves from its first to its second carrier before step 3
APP_WFM = (-300e3, -650e3)
APP_NFM = (400e3, 700e3)
APP_NFM_OFF = (1.0e6, 1.05e6)      # the squelched radio, off the signal
APP_SKIP = 960                     # audio settling after a retune (20 ms)

# channelizer64 (bench.py:build_channelizer64, BASELINE config 4): a 10 MS/s
# wideband into 64 critically sampled channels, each channel's 1024-bin dB
# spectra, 2^21-sample steps
CHZ_FS = 10_000_000.0
CHZ_M = 64
CHZ_T = 1 << 21
CHZ_FFT = 1024

HBM_BPS = 3.35e12            # H100 SXM HBM3, bytes/s
FP32_FLOPS = 67e12           # H100 SXM non-tensor FP32, flop/s
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores, flop/s
# the earlier designs' recorded device µs a call at the path shapes, in a
# profiler window of the path's step (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md sections 5 and 6)
PARENT_US = {"K5": (24.0, "scanner128 step"),
             "K5c": (122.0, "channelizer64 step"),
             "K11": (45.2, "10 MS/s bank, a launch of the step"),
             "K6": (96.4, "scanner128 step"),
             "K9": (8.2, "app WFM () step")}
# K12's dependent chain a sample: a multiply and an add (4 cycles each)
# and two selects (csrc/agc.cu); its floor is T of these at the SM clock
CHAIN_CYCLES = 10
# K13's and K12c's chains are clocked on the kernel itself (the ``clk``
# argument, csrc/common.cuh:ChainClock) over LOOP_RUNS runs: the floor is
# the steps at the fewest cycles a step any run took, at the fastest SM
# clock (the card's maximum, or the fastest the runs measured, where the
# card ran above it), which no run of the kernel can beat
LOOP_RUNS = 7


def fail(msg: str):
    raise RuntimeError(msg)


def stereo_wideband(n: int, offsets) -> np.ndarray:
    """One stereo FM broadcast (1 kHz tone in L only, 19 kHz pilot) on
    every carrier offset, plus a little noise."""
    t = np.arange(n) / FS
    tone = np.sin(2 * np.pi * TONE_HZ * t)
    mpx = (0.45 * tone + 0.1 * np.sin(2 * np.pi * 19_000 * t)
           + 0.45 * tone * (-np.cos(2 * np.pi * 38_000 * t)))
    base = np.exp(1j * 2 * np.pi * np.cumsum(75_000 * mpx) / FS)
    x = np.zeros(n, np.complex128)
    for o in offsets:
        x += base * np.exp(2j * np.pi * o * t)
    rng = np.random.default_rng(7)
    x = x / len(offsets) + 1e-3 * (rng.standard_normal(n)
                                   + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def nfm_wideband(n: int, offsets, tone_channels) -> np.ndarray:
    """An NFM carrier (1 kHz tone, 2 kHz peak deviation) on each tone
    channel's offset, plus low noise."""
    t = np.arange(n) / FS
    phase = 2 * np.pi * 2000.0 * np.cumsum(np.sin(2 * np.pi * TONE_HZ * t)) / FS
    rng = np.random.default_rng(11)
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for k in tone_channels:
        x = x + 0.3 * np.exp(1j * (2 * np.pi * offsets[k] * t + phase))
    return x.astype(np.complex64)


def tone_snr_db(audio, hz: float = TONE_HZ) -> float:
    """SNR of the ``hz`` tone (1 kHz by default) in a 48 kHz audio row
    (sine fit)."""
    n = audio.shape[-1]
    tt = np.arange(n) / 48_000.0
    A = np.stack([np.cos(2 * np.pi * hz * tt),
                  np.sin(2 * np.pi * hz * tt), np.ones(n)], 1)
    coef, *_ = np.linalg.lstsq(A, audio, rcond=None)
    r = audio - A @ coef
    return float(10 * np.log10(np.mean((A[:, :2] @ coef[:2]) ** 2)
                               / np.mean(r ** 2)))


def tone_level_db(audio, hz: float = TONE_HZ) -> float:
    """The ``hz`` tone's amplitude in a 48 kHz audio row (sine fit), dB."""
    n = audio.shape[-1]
    tt = np.arange(n) / 48_000.0
    A = np.stack([np.cos(2 * np.pi * hz * tt),
                  np.sin(2 * np.pi * hz * tt), np.ones(n)], 1)
    coef, *_ = np.linalg.lstsq(A, audio, rcond=None)
    return float(20 * np.log10(max(np.hypot(coef[0], coef[1]), 1e-300)))


def snr_db(ref, got) -> float:
    ref = ref.double()
    err = got.double() - ref
    return float(10 * np.log10(float((ref ** 2).mean())
                               / max(float((err ** 2).mean()), 1e-300)))


def channelizer64(device, T: int = CHZ_T):
    """The channelizer64 step on the port, built as bench.py builds it:
    (PolyphaseChannelizer, step), step(state, (xr, xi)) → (spectra
    [M, T/(M·1024), 1024] float32 dB, state'): K5's critical form, then
    every channel's frames through the row-batched K4 (K4r) in place."""
    from sdrplusplusbrown_tpu_torch.ops.channelizer import PolyphaseChannelizer
    from sdrplusplusbrown_tpu_torch.ops.fft_kernel import fft_power_db_planes
    ch = PolyphaseChannelizer(CHZ_FS, CHZ_M, device=device)
    M, k = CHZ_M, T // CHZ_M

    def step(state, x):
        bins, state = ch.apply_planes(state, x)
        spec = fft_power_db_planes(bins[:M, :k].reshape(M, -1, CHZ_FFT),
                                   bins[M:, :k].reshape(M, -1, CHZ_FFT),
                                   CHZ_FFT)
        return spec, state
    return ch, step


def channelizer64_noise(T: int = CHZ_T) -> tuple:
    """bench.py's channelizer64 input: (re, im) float32 planes of
    N(0, 0.1²) noise from seed 1."""
    rng = np.random.default_rng(1)
    return tuple((rng.standard_normal(T) * 0.1).astype(np.float32)
                 for _ in range(2))


def nbytes(dtype) -> int:
    import torch
    return torch.empty((), dtype=dtype).element_size()


def work(tag: str, args) -> tuple:
    """(bytes, float32 operations) that kernel ``tag``'s function needs
    on these arguments: each input read once, each output written once,
    the valid outputs' direct-form multiply-adds (2 operations each; K3's
    and K8's over each phase row's nonzero band only) and the elementwise
    arithmetic.  Transcendentals (sin/cos, the minimax
    atan2's 20-odd operations aside) are not counted."""
    if tag == "K1":     # + each stage's carried tail read and written
        pipe, xr, xi, tail, omega, base, tails, odt = args[:8]
        T, Cn = xr.shape[0], omega.shape[0]
        m = pipe.lengths(T)
        b = 8 * T + 2 * Cn * m[-1] * nbytes(odt) + sum(
            2 * 8 * Cn * st["carry"] for st in pipe.stages)
        ops = 2 * 2 * Cn * m[0] * pipe.K0 + 6 * Cn * T
        for s, st in enumerate(pipe.stages):
            ops += 2 * 2 * Cn * m[s + 1] * st["kernel"].shape[1]
        return b, ops
    if tag == "K2":     # + the carried state read and written
        pipe, iq, m_if, quad, hb_tails, hist, odt = args
        Cn = iq.shape[0] // 2
        b = 2 * Cn * m_if * iq.element_size() + 2 * 4 * (
            2 * Cn + sum(t.numel() for t in hb_tails) + hist.numel())
        ops, m = 6 * Cn * m_if, m_if
        for h in pipe.hb_taps:
            m //= 2
            ops += 2 * Cn * m * len(h)
        b += 2 * Cn * m * nbytes(odt)
        return b, ops + Cn * m * (4 * pipe.K + 12)
    if tag == "K3":     # each phase row's nonzero band, as K8
        pipe, raw, m_in, ptail, dt = args
        m_aud = m_in // pipe.D * pipe.I
        return (raw.shape[0] * (m_in * raw.element_size() + 4 * m_aud),
                2 * raw.shape[0] * m_in // pipe.D
                * band_taps(pipe.taps(raw.device, dt)))
    if tag == "K4":
        xr, xi, keep, interval, N, floor_db, window = args
        n = xr.shape[0] // interval
        return (n * (8 * keep + 4 * N),
                n * (5 * N * int(np.log2(N)) + 2 * keep + 4 * N))
    if tag in ("K5", "K5c"):    # the rows the call computes: R of 2M
        pipe, xr, xi, xwr, xwi, width, tdt, odt = args[:8]
        rows = args[8] if len(args) > 8 else None
        Tb = xr.shape[0] // pipe.h
        R = 2 * pipe.M if rows is None else rows.shape[0]
        # above M = 64 the valid frames only, else every column; the
        # M-point DFT counted as an FFT, or R direct rows where fewer
        out = R * (Tb if pipe.M > 64 else width)
        dft = min(5 * pipe.M * np.log2(pipe.M), 4 * pipe.M * R)
        return (8 * xr.shape[0] + out * nbytes(odt),
                Tb * (2 * 2 * pipe.K0 + dft))
    if tag == "K6":
        pipe, bins, bin_idx, om, ph0, span, sbs, tails, Tb, odt, tdt = args
        Cn = om.shape[0]
        plan = pipe.plan(Tb)
        rows = min(Cn, pipe.M)
        m1, m_out = plan["m"][1], plan["m"][-1]
        return (2 * rows * Tb * bins.element_size()
                + 2 * Cn * plan["n_out"] * nbytes(odt),
                Cn * (6 * Tb + 2 * 2 * m1 * len(pipe.taps[0])
                      + 2 * 2 * m_out * len(pipe.taps[1]) + 4 * m_out))
    if tag == "K7":
        pipe, iq, m_if, gate, qprev, ftail, ptail, odt, tdt = args
        Cn = iq.shape[0] // 2
        plan = pipe.plan(m_if)
        return (2 * Cn * m_if * iq.element_size()
                + Cn * plan["n_aud"] * nbytes(odt),
                Cn * (30 * m_if + 2 * m_if * len(pipe.hf)
                      + 2 * plan["m_aud"] * pipe.kernel.shape[1]))
    if tag in ("K8", "K9"):     # y and the new tail out, block/tail/taps in
        x, tail, kern = args[:3]
        n_out = fir_out_len(tag, args)
        parts = 2 if x.is_complex() else 1
        b = (x.numel() + 2 * tail.numel()) * x.element_size() \
            + 4 * kern.numel() + n_out * x.numel() // x.shape[-1] \
            * x.element_size()
        rows = x.numel() // x.shape[-1]
        if tag == "K9":
            return b, 2 * 4 * kern.shape[1] * n_out * rows
        # phase row r's n_out / I outputs each take its nonzero band
        return b, 2 * parts * band_taps(kern) * n_out // args[3] * rows
    if tag == "K10":
        pipe, mpx, hist = args
        Cn, m = mpx.shape
        return (4 * (mpx.numel() + hist.numel() + 2 * Cn * m),
                Cn * m * (4 * pipe.K + 12))
    if tag == "K4f":
        x, keep, interval, N = args[:4]
        n = x.shape[0] // interval
        return (n * (8 * keep + 4 * N),
                n * (5 * N * int(np.log2(N)) + 2 * keep + 4 * N))
    if tag == "K4r":    # framed planes in, float32 dB out, no window
        xr, xi, N = args[:3]
        n = xr.numel() // N
        return (n * N * (2 * xr.element_size() + 4),
                n * (5 * N * int(np.log2(N)) + 4 * N))
    if tag == "K11":    # planes, tail, taps and params in; [2C, M] out
        xr, _, tail_r, _, h, D, omega = args[:7]
        T, K, Cn = xr.shape[0], h.shape[0], omega.shape[0]
        M = T // D
        b = 4 * (2 * T + 2 * (K - 1) + K + 4 * Cn) + 4 * 2 * Cn * M
        # 2K complex taps on real planes: 2·2·2K flops a channel and
        # output, the twiddle's complex rotate 6 more
        return b, Cn * M * (8 * K + 6)
    if tag == "K12":    # rows and state in and out
        x = args[1]
        R, T = x.shape
        # |x|, compare, 2 mul + add, divide, min; ramp 3; 2 mul
        return 8 * R * T + 16 * R, 12 * R * T
    if tag == "K12c":   # complex rows: |x| a hypot (3), the gain on 2 planes
        x = args[1]
        R, T = x.shape
        return 16 * R * T + 16 * R, 15 * R * T
    if tag in ("K13p", "K13c"):    # complex rows in and out, 2 state words
        x = args[1]
        R, T = x.shape
        # the loop update (2 mul, 4 add, 2 clamps, 2 wraps) and, for
        # Costas, the rotate (4 mul, 2 add) and its detector (1-5)
        return 16 * R * T + 16 * R, (12 if tag == "K13p" else 20) * R * T
    if tag == "K13b":   # K13c with the nearest-of-four-phases detector:
        x = args[1]     # the rotate (6), the update (10), and a phase's
        R, T = x.shape  # sub, add, fmod, fix-up, sub, |d|, compare (7 x 4)
        return 16 * R * T + 16 * R, 45 * R * T      # and the product with |v|
    if tag in ("K13m", "K13f"):   # x and its tail in, symbols and flags out
        mm, x = args[:2]
        R, T = x.shape
        n, w = mm.max_out(T), 2 if x.is_complex() else 1
        b = 4 * w * R * (T + 2 * (mm.K - 1)) + R * n * (4 * w + 1) \
            + 4 * mm.P * mm.K
        if tag == "K13f":   # three interpolations (out, lo, hi) and the slope
            return b, R * n * (6 * mm.K + 24)
        return b, R * n * (2 * w * mm.K + 20)
    if tag == "K16":    # soft in; bits and final metrics out
        soft, k = args[0], args[3]
        R, N, S = soft.shape[0], soft.shape[1] // 2, 1 << (k - 1)
        # a step: the rate-1/2 code's 4 distinct branch metrics (2 sub,
        # 2 mul, 1 add each); a state and step: two adds, the compare, the
        # tie's add and compare, the select
        return (4 * soft.numel() + R * (N - k + 1) + 4 * R * S,
                R * N * (4 * 5 + 6 * S))
    if tag == "K14":    # frames, state and F ring slots in; gains, state
        core, st, sig = args[:3]        # and the F slots out
        F = sig.shape[-2]
        bins = sig.numel() // F
        b = 4 * bins * (2 * F + 2 * 2 * F + 4 + 3) + 2 * (
            st["has_prev"].numel() + 8)
        # a bin and frame: the history's 7, the gain's 19 and E1's 36
        # (both of its branches; exp, log and powf not counted)
        return b, 62 * bins * F
    if tag == "K15":    # b or x (and a tensor a), y0 in; y or out (and
        a, b, y0 = args[:3]                 # the new state) out
        form = args[3] if len(args) > 3 else "scan"
        e, n, parts = b.element_size(), b.numel(), 2 if b.is_complex() else 1
        ve = 4 if form == "nb" else e
        by = 2 * n * e + y0.numel() * ve * (1 if form == "scan" else 2) + (
            4 * n if hasattr(a, "numel") else 0)
        # a multiply-add a sample on each part; the DC blocker's gain and
        # difference (2 a part more); the noise blanker's multiply-add
        # (2), |x| (3), gain·|x|, two divisions, a compare (4) and x·gain
        # (a part)
        return by, {"scan": 2 * parts, "dc": 4 * parts,
                    "nb": 9 + parts}[form] * n
    raise KeyError(tag)


def band_taps(kern) -> int:
    """Sum over the phase rows of a FIR kernel [I, kw] of each row's
    nonzero band, last nonzero tap − first + 1: the multiply-adds an
    output of that row needs (csrc/fir_tile.cuh skips the rest)."""
    total = 0
    for row in kern.detach().cpu().numpy().reshape(-1, kern.shape[-1]):
        nz = np.flatnonzero(row)
        total += int(nz[-1] - nz[0] + 1) if nz.size else 0
    return total


def fir_out_len(tag: str, args) -> int:
    """Outputs per row of a K8 (x, tail, kern, I, D) or K9 (x, tail,
    taps, D) call."""
    x, tail, kern = args[:3]
    I, D = (args[3], args[4]) if tag == "K8" else (1, args[3])
    return ((tail.shape[-1] + x.shape[-1] - kern.shape[1]) // D + 1) * I


def bound(tag: str, args) -> tuple:
    """(bound_ms, bound_by) of kernel ``tag`` on these arguments."""
    b, ops = work(tag, args)
    tb, to = b / HBM_BPS * 1e3, ops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def event_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def call_profile(fn, reps: int = 20, by_kernel: dict | None = None,
                 counts: dict | None = None, events: dict | None = None,
                 window: dict | None = None) -> tuple:
    """(device µs, kernel launches) per call of ``fn`` from a torch.profiler
    window of ``reps`` calls: the time of the kernels and copies the window
    saw on the card over ``reps`` (the wrapper's host time, which CUDA
    events around a short kernel also count, left out), and each kernel's
    count over ``reps``, rounded, at least 1, so that an event the
    profiler drops now and then does not count as a missing launch.  The
    window follows a warm-up step of ``reps`` calls inside the profiler.
    A window that saw no device activity at all, or fewer launches of the
    repo's own kernels (csrc/) than the wrappers counted over the same
    calls, is taken again, twice at most, each retake printed, and the
    window that saw the largest share of them kept (late in a long run
    the profiler dropped up to half of a window's events, and the device
    µs read low); ``by_kernel`` gets µs per call by kernel,
    ``counts`` launches per call by kernel (rounded, at least 1),
    ``events`` each kernel's (device µs, launches) as the window saw
    them, ``window`` the kept window's ``calls``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    best, best_share = {}, -1.0
    for attempt in range(3):
        fn()
        torch.cuda.synchronize()
        got = {}

        def ready(p):
            got["events"] = p.key_averages()
        # a warm-up step of ``reps`` calls inside the profiler, its events
        # discarded: the profiler loses a window's first events (late in a
        # long run up to half of 20 calls' launches), not the active
        # step's
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
            n0 = wrapper_launches()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            counted = wrapper_launches() - n0
            prof.step()
        seen = {}
        for e in got.get("events", []):
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            # the schedule's step annotation spans the window's kernels
            if dev_us > 0 and e.count and not e.key.startswith(
                    ("aten::", "cuda", "ProfilerStep")):
                seen[e.key] = (dev_us, e.count)
        own = sum(c for key, (_, c) in seen.items()
                  if short_kernel(key) in own_kernels())
        share = own / counted if counted else 1.0
        if seen and share > best_share:
            best, best_share = seen, share
        if attempt == 2 or (seen and own >= counted):
            break
        print("profiler window saw no device activity; taken again"
              if not seen else
              f"profiler window saw {own} of the {counted} launches the "
              f"wrappers counted; taken again")
    seen = best
    if window is not None:
        window["calls"] = reps
    launches = sum(max(1, round(count / reps)) for key, (_, count)
                   in seen.items() if not key.startswith(("Memcpy", "Memset")))
    for key, (total, count) in seen.items():
        k = short_kernel(key)
        if events is not None:
            t0, n0 = events.get(k, (0.0, 0))
            events[k] = (t0 + total, n0 + count)
        if by_kernel is not None:
            by_kernel[k] = by_kernel.get(k, 0.0) + total / reps
        if counts is not None and not key.startswith(("Memcpy", "Memset")):
            counts[k] = counts.get(k, 0) + max(1, round(count / reps))
    return sum(total for total, _ in seen.values()) / reps, launches


@functools.lru_cache(maxsize=None)
def own_kernels() -> frozenset:
    """The names of the repo's CUDA kernels (``__global__`` functions of
    sdrplusplusbrown_tpu_torch/csrc/), as ``short_kernel`` gives them."""
    from sdrplusplusbrown_tpu_torch.kernels import _build
    names = set()
    for f in os.listdir(_build.CSRC):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(_build.CSRC, f)) as fh:
                names.update(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)", fh.read()))
    return frozenset(names)


def wrapper_launches() -> int:
    """The CUDA launches every kernel wrapper has counted so far."""
    return sum(kernel_count(tag) for tag in KERNELS)


def device_us(fn, reps: int = 20) -> float:
    """Device time per call of ``fn`` in µs (``call_profile``)."""
    return call_profile(fn, reps)[0]


def fft_launches(tag: str, launches: int, N: int, n_frames: int,
                 by_kernel: dict) -> None:
    """A spectrum kernel call made the launches its route plans: one for
    the one-pass route (N <= 4 096), two for the four-step.  Fails on
    another count (``call_profile``'s); a profiler that saw no kernel at
    all measures nothing and is reported so.  Prints the device time of
    each of the call's kernels."""
    from sdrplusplusbrown_tpu_torch.ops import fft_kernel
    p = fft_kernel.plan(N, n_frames)
    seen = f"{launches}" if launches else "not measured (no kernel in " \
        "the profiler window)"
    print(f"{tag} at {n_frames} x {N}: {p['route']} route, "
          f"CUDA launches a call {seen}, "
          + ", ".join(f"{ln['entry']} {ln['blocks']} blocks of "
                      f"{ln['threads']} threads" for ln in p["launches"])
          + "; device us a call: "
          + ", ".join(f"{k} {v:.1f}" for k, v in by_kernel.items()))
    if launches and launches != len(p["launches"]):
        fail(f"{tag}: {launches} CUDA launches a call, the {p['route']} "
             f"route plans {len(p['launches'])}")


def noise_planes(T: int, dev):
    """Bench-style input: (re, im) planes of N(0, 0.1²) noise."""
    import torch
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy((rng.standard_normal(T) * 0.1)
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


def short_kernel(key: str) -> str:
    """A profiler kernel name without namespaces, template arguments or
    parameter list."""
    k = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[(<]", k, maxsplit=1)[0].split("::")[-1].strip()


def step_rate(label: str, step, st, T: int, card: str) -> float:
    """Times ``step`` (state → state') on one T-sample block: the mean of
    100 pipelined steps (the throughput), the wall-time percentiles of 200
    steps each followed by a sync (the latency), and a torch.profiler
    window of 20 synced steps.  From the window: device time per step by
    kernel, the kernel launches and host-to-device copies per step, and
    the device's idle share, 1 − (the window's kernel and copy time) /
    (its wall time); one stream, so those never overlap.  Returns the
    window's launches per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        st = step(st)
    torch.cuda.synchronize()
    walls = []
    for _ in range(200):
        t0 = time.perf_counter()
        st = step(st)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(100):
        st = step(st)
    torch.cuda.synchronize()
    pipe_s = (time.perf_counter() - t0) / 100
    pct = " / ".join(f"{np.percentile(walls, q):.4f}" for q in (50, 10, 90, 99))
    print(f"{label} step (T={T}): pipelined "
          f"{pipe_s * 1e3:.4f} ms, {T / pipe_s / 1e6:.1f} MS/s wideband; "
          f"synced median / p10 / p90 / p99 {pct} ms [{card}]")
    n = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            st = step(st)
            torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_kernel, launches, h2d = {}, 0, 0
    for evt in prof.key_averages():
        if evt.key == "cudaLaunchKernel":
            launches += evt.count
        if "Memcpy HtoD" in evt.key:
            h2d += evt.count
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        # device-side entries: kernels and copies, not the CPU ops and
        # runtime calls that launched them
        if us > 0 and not evt.key.startswith(("aten::", "cuda")):
            k = short_kernel(evt.key)
            by_kernel[k] = by_kernel.get(k, 0.0) + us / n
    busy = sum(by_kernel.values())
    if busy <= 0:
        print(f"{label} profile: device time not measured (the profiler "
              f"saw no device activity); {launches / n:.1f} launches and "
              f"{h2d / n:.1f} host-to-device copies per step")
        return launches / n
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} profile ({n} synced steps): device {busy:.1f} us/step, "
          f"idle share {1.0 - busy * n / window_us:.3f}, "
          f"{launches / n:.1f} kernel launches and {h2d / n:.1f} "
          f"host-to-device copies per step; us/step by kernel: "
          + ", ".join(f"{k} {v:.1f}" for k, v in top) + f" [{card}]")
    return launches / n


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sdrplusplusbrown_tpu_torch  # noqa: F401  (fails outside the repo)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    dev = torch.device("cuda", 0)
    report = drive(dev, card)
    report.update(drive_scanner(dev, card))
    report.update(drive_app(dev, card))
    report.update(drive_bank(dev, card, report))
    report.update(drive_channelizer(dev, card))
    drive_served(dev, card, report)
    drive_noise(dev, card, report)
    drive_loops(dev, card, report)
    drive_rds(dev, card, report)
    drive_network(dev, card, report)
    drive_modes(dev, card, report)
    drive_trx(dev, card, report)
    drive_decoders(dev, card, report)
    drive_wideband(dev, card, report)
    drive_voice(dev, card, report)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("launches_path", "launches_by_path", "cycles_a_step")
    print(json.dumps({"kernels": [
        {k: report[t][k] for k in keys + extra if k in report[t]}
        for t in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def stereo_oracle(aud: np.ndarray) -> tuple:
    """(mean 1 kHz tone SNR in L, L/R separation) in dB of audio [C, 2, n]
    whose stations carry the tone in L only."""
    L, R = aud[:, 0], aud[:, 1]
    sep = 10 * np.log10(np.mean(L ** 2) / max(np.mean(R ** 2), 1e-300))
    return float(np.mean([tone_snr_db(row) for row in L])), float(sep)


def drive(dev, card: str) -> dict:
    """Phases 2-5 on ``dev``; raises on the first failure.  Returns the
    K1-K4 entries of the kernel report."""
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu_torch.ops import fft_kernel as k4
    from sdrplusplusbrown_tpu_torch.ops import precision
    from sdrplusplusbrown_tpu_torch.ops.spectrum import SpectrumPath

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("ptxas:", line.split("ptxas info    :")[-1].strip())

    radio = Radio(FS, DEMOD_WFM, device=dev)
    spec = SpectrumPath(FS, fft_size=FFT, fft_rate=20.0, device=dev)
    g = int(np.lcm(radio.in_multiple, spec.in_multiple))
    T = (STEP + g - 1) // g * g
    x = stereo_wideband(3 * T, OFFSETS)
    blocks = [(torch.from_numpy(x[b * T:(b + 1) * T].real.copy()).to(dev),
               torch.from_numpy(x[b * T:(b + 1) * T].imag.copy()).to(dev))
              for b in range(3)]

    def run3(handoff: str):
        precision.set_handoff_dtype(handoff)
        st = radio.init_state_shared(C)
        outs = []
        for b, xb in enumerate(blocks):
            params = radio.make_params_shared(OFFSETS if b < 2 else RETUNE)
            (audio, spectra), st = radio.apply_shared(params, st, xb,
                                                      spectrum=spec)
            outs.append((audio, spectra))
        torch.cuda.synchronize()
        return outs

    # ---- 3. kernels against their plain versions --------------------------
    # record each kernel's arguments (the last of the three steps, state
    # settled), then run kernel and plain version on exactly those tensors
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phases 3-9: TF32 off for every kernel/plain/library comparison "
          "(torch.backends.cudnn.allow_tf32 = False, "
          "torch.backends.cuda.matmul.allow_tf32 = False)")
    ref32, captured = capture(("K1", "K2", "K3", "K4"),
                              lambda: run3("float32"))
    report = {}
    for tag in ("K1", "K2", "K3", "K4"):
        args = captured[tag][-1]
        mod, name = kernel_fn(tag, "")
        kern = getattr(mod, name + "_kernel")
        ref = getattr(mod, name + "_ref")
        got = kern(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        if tag in ("K1", "K2"):
            got, want = got[0], want[0]
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all():
            fail(f"{tag}: non-finite kernel output")
        if tag == "K4":
            pk = want.max(dim=-1, keepdim=True).values
            d = (got - want).abs()
            e60 = float(d[want > pk - 60].max())
            e80 = float(d[want > pk - 80].max())
            agree = f"{e60:.2e} dB within 60 dB, {e80:.2e} within 80 dB"
            ok = e60 <= 0.01 and e80 <= 0.1
        else:
            s = snr_db(want, got)
            min_db = 80.0 if tag == "K1" else 70.0
            agree = f"{s:.1f} dB SNR (bound {min_db:.0f})"
            ok = s >= min_db
        ms = event_ms(lambda: kern(*args))
        plain_ms = event_ms(lambda: ref(*args))
        split = {}
        k_us, n_launch = call_profile(lambda: kern(*args), by_kernel=split)
        p_us = device_us(lambda: ref(*args))
        lib = library_call(tag, args)
        if tag == "K4":
            fft_launches(tag, n_launch, args[4],
                         len(k4.frame_starts(args[0].shape[0], args[2],
                                             args[3])), split)
        library_ms = None if lib is None else event_ms(lib)
        libs = "n/a" if lib is None else \
            f"{library_ms:.4f} ms (device {device_us(lib):.1f} us)"
        bms, by = bound(tag, args)
        print(f"{tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {libs}, bound {bms:.4f} ms ({by}), "
              f"max|err| {err:.3e}, {agree}; device time per call "
              f"(profiler) kernel {k_us:.1f} us in {n_launch:.0f} launches, "
              f"plain {p_us:.1f} us [{card}]")
        if not ok:
            fail(f"{tag}: kernel disagrees with its plain version: {agree}")
        if tag == "K1":
            mix = sum(v for k, v in split.items() if "mix" in k)
            print(f"K1 device time per call: mix stage {mix:.1f} us, "
                  f"chained stages {k_us - mix:.1f} us in "
                  f"{n_launch - 1:.0f} launches [{card}]")
        if tag in ("K1", "K2"):
            tails_exact(tag, args, "WFM-8, float32 handoff")
        report[tag] = {"name": name, "route": "cuda",
                       "source": KERNELS[tag][2], "replaces": KERNELS[tag][3],
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": library_ms}

    # ---- 4. the main path, production bf16 handoff ------------------------
    reset_counts()
    outs, cap4 = capture(("K1", "K2", "K3", "K4"), lambda: run3("bf16"))
    for tag in ("K1", "K2", "K3", "K4"):
        mod, name = kernel_fn(tag, "_kernel")
        n = getattr(mod, name).launches
        report[tag]["launches"] = n
        if n < 1:
            fail(f"{tag}: the main path never launched {name}")
    hold_launches("WFM-8, 3 steps", {t: report[t]["launches"] for t in
                                     ("K1", "K2", "K3", "K4")}, cap4)
    for b, (audio, spectra) in enumerate(outs):
        if audio.shape != (C, 2, T // 50) or spectra.shape != (
                T // spec.reshaper.interval, FFT):
            fail(f"step {b}: shapes {tuple(audio.shape)}, "
                 f"{tuple(spectra.shape)}")
        if not (torch.isfinite(audio).all() and torch.isfinite(spectra).all()):
            fail(f"step {b}: non-finite output")
    a16 = outs[1][0].double().cpu().numpy()
    a32 = ref32[1][0].double().cpu().numpy()
    d_snr = 10 * np.log10(np.mean(a32 ** 2) / max(np.mean((a16 - a32) ** 2),
                                                   1e-300))
    print(f"bf16 vs float32 audio (step 2): {d_snr:.1f} dB (bound 45)")
    if d_snr <= 45.0:
        fail("bf16 handoff audio too far from the float32 run")
    for b in (1, 2):
        # channels the retune moved off their carrier carry no oracle
        on = [ch for ch in range(C) if b < 2 or RETUNE[ch] == OFFSETS[ch]]
        snr, sep = stereo_oracle(outs[b][0].double().cpu().numpy()[on])
        print(f"step {b}: tone SNR {snr:.1f} dB (bound 35), "
              f"L/R separation {sep:.1f} dB (bound 25)")
        if snr <= 35.0 or sep <= 25.0:
            fail(f"step {b}: audio oracle failed")
        sp = outs[b][1][0].cpu().numpy()
        floor = np.percentile(sp, 2)
        for o in OFFSETS:
            k = int((o / FS + 0.5) * FFT)
            w = int(75e3 / FS * FFT)
            if sp[max(k - w, 0):k + w].max() < floor + 30.0:
                fail(f"step {b}: no spectrum peak at carrier {o:.0f} Hz")
        kmax = int(np.argmax(sp))
        fmax = (kmax / FFT - 0.5) * FS
        if np.min(np.abs(OFFSETS - fmax)) > 100e3:
            fail(f"step {b}: spectrum peak at {fmax:.0f} Hz, off the carriers")
    print("main path: launches "
          + ", ".join(f"{t}={report[t]['launches']}" for t in report))

    # ---- 5. the WFM-8 step on bench-style noise input --------------------
    precision.set_handoff_dtype("bf16")
    xn = noise_planes(T, dev)
    params = radio.make_params_shared(OFFSETS)
    n = step_rate(f"WFM-8 (C={C}, fft {FFT}, bf16 handoff)",
                  lambda st: radio.apply_shared(params, st, xn,
                                                spectrum=spec)[1],
                  radio.init_state_shared(C), T, card)
    print(f"WFM-8 kernel launches per step: {n:.1f} "
          f"(before K1 and K2 ran on the FIR tile: 87)")
    return report


KERNELS = {
    "K1": ("mono_frontend", "mono_frontend",
           "sdrplusplusbrown_tpu_torch/csrc/mono_frontend.cu",
           "sdrplusplusbrown_tpu/ops/mono_frontend.py:123"),
    "K2": ("wfm_kernel", "wfm_demod",
           "sdrplusplusbrown_tpu_torch/csrc/wfm_demod.cu",
           "sdrplusplusbrown_tpu/ops/wfm_kernel.py:47"),
    "K3": ("wfm_kernel", "mpx_audio_poly",
           "sdrplusplusbrown_tpu_torch/csrc/mpx_poly.cu",
           "sdrplusplusbrown_tpu/ops/wfm_kernel.py:418"),
    "K4": ("fft_kernel", "spectrum_frames_db",
           "sdrplusplusbrown_tpu_torch/csrc/spectrum_fft.cu",
           "sdrplusplusbrown_tpu/ops/pallas_fft.py:253"),
    "K5": ("channelizer_kernel", "pfb_bins",
           "sdrplusplusbrown_tpu_torch/csrc/pfb_channelizer.cu",
           "sdrplusplusbrown_tpu/ops/pallas_channelizer.py:856"),
    "K6": ("chan_frontend", "chan_post",
           "sdrplusplusbrown_tpu_torch/csrc/chan_post.cu",
           "sdrplusplusbrown_tpu/ops/chan_frontend.py:77"),
    "K7": ("demod_kernel", "fm_audio",
           "sdrplusplusbrown_tpu_torch/csrc/fm_audio.cu",
           "sdrplusplusbrown_tpu/ops/demod_kernel.py:80"),
    "K8": ("fir_kernel", "fir_rows",
           "sdrplusplusbrown_tpu_torch/csrc/fir_rows.cu",
           "sdrplusplusbrown_tpu/ops/pallas_fir.py:199"),
    "K9": ("fir_kernel", "fir_cplx",
           "sdrplusplusbrown_tpu_torch/csrc/fir_cplx.cu",
           "sdrplusplusbrown_tpu/ops/pallas_fir.py:441"),
    "K10": ("wfm_kernel", "wfm_stereo",
            "sdrplusplusbrown_tpu_torch/csrc/wfm_demod.cu",
            "sdrplusplusbrown_tpu/ops/pallas_wfm.py:59"),
    "K4f": ("fft_kernel", "spectrum_path_db",
            "sdrplusplusbrown_tpu_torch/csrc/spectrum_fft.cu",
            "sdrplusplusbrown_tpu/ops/pallas_fft.py:64"),
    "K11": ("fused_frontend", "fused_mix",
            "sdrplusplusbrown_tpu_torch/csrc/fused_mix.cu",
            "sdrplusplusbrown_tpu/ops/pallas_fir.py:1034"),
    "K12": ("agc", "agc_rows",
            "sdrplusplusbrown_tpu_torch/csrc/agc.cu",
            "sdrplusplusbrown_tpu/ops/agc.py:77"),
    "K5c": ("channelizer_kernel", "pfb_critical_bins",
            "sdrplusplusbrown_tpu_torch/csrc/pfb_channelizer.cu",
            "sdrplusplusbrown_tpu/ops/pallas_channelizer.py:856"),
    "K4r": ("fft_kernel", "fft_power_db_planes",
            "sdrplusplusbrown_tpu_torch/csrc/spectrum_fft.cu",
            "sdrplusplusbrown_tpu/ops/pallas_fft.py:64"),
    "K13p": ("pll", "pll_rows",
             "sdrplusplusbrown_tpu_torch/csrc/loops.cu",
             "sdrplusplusbrown_tpu/ops/pll.py:69"),
    "K13c": ("costas", "costas_rows",
             "sdrplusplusbrown_tpu_torch/csrc/loops.cu",
             "sdrplusplusbrown_tpu/ops/costas.py:61"),
    "K13m": ("clock_recovery", "mm_rows",
             "sdrplusplusbrown_tpu_torch/csrc/loops.cu",
             "sdrplusplusbrown_tpu/ops/clock_recovery.py:69"),
    "K12c": ("agc", "agc_cplx_rows",
             "sdrplusplusbrown_tpu_torch/csrc/agc.cu",
             "sdrplusplusbrown_tpu/ops/agc.py:56"),
    "K14": ("logmmse", "logmmse_frames",
            "sdrplusplusbrown_tpu_torch/csrc/logmmse.cu",
            "sdrplusplusbrown_tpu/ops/logmmse.py:327"),
    "K15": ("recurrence", "linear_recurrence",
            "sdrplusplusbrown_tpu_torch/csrc/recurrence.cu",
            "sdrplusplusbrown_tpu/ops/recurrence.py:22"),
    "K16": ("fec", "viterbi_rows",
            "sdrplusplusbrown_tpu_torch/csrc/viterbi.cu",
            "sdrplusplusbrown_tpu/ops/fec.py:91"),
    "K13b": ("costas", "costas_nearest_rows",
             "sdrplusplusbrown_tpu_torch/csrc/loops.cu",
             "sdrplusplusbrown_tpu/models/meteor.py:36"),
    "K13f": ("clock_recovery", "fd_rows",
             "sdrplusplusbrown_tpu_torch/csrc/loops.cu",
             "sdrplusplusbrown_tpu/ops/clock_recovery.py:202"),
}


def kernel_fn(tag: str, suffix: str):
    """(module, name + suffix) of a kernel's wrapper; K12c's plain version
    is K12's (``agc_rows_ref`` takes complex rows)."""
    import importlib
    mod = importlib.import_module("sdrplusplusbrown_tpu_torch.ops."
                                  + KERNELS[tag][0])
    if tag == "K12c" and suffix == "_ref":
        return mod, "agc_rows_ref"
    return mod, KERNELS[tag][1] + suffix


def reset_counts() -> None:
    """Every kernel's launch count to 0 (just before a main-path run)."""
    for tag in KERNELS:
        mod, name = kernel_fn(tag, "_kernel")
        getattr(mod, name).launches = 0


def state_copy(st: dict) -> dict:
    """A copy of a state dict's tensors (a LogMMSE state that K14 can take
    while the original goes on)."""
    return {k: v.clone() for k, v in st.items()}


def k14_chain(kern, args):
    """A call of K14 on ``args``' frames that each time takes the state
    the previous call returned (K14 takes the rings of the state it is
    given, ops/logmmse.py:hand_over); the first takes ``args``' state."""
    core, st, sig, hold = args
    box = [st]

    def call():
        box[0], hw = kern(core, box[0], sig, hold)
        return box[0], hw
    return call


#: the record of the running ``capture``, readable while it runs
#: (``module_calls``)
capture_log: dict = {}


def capture(tags, run, suffix: str = "_kernel"):
    """Run ``run()`` with the wrappers of ``tags`` recording their
    arguments; returns (run's result, {tag: [args of each call]}); a K14
    call's state is recorded as a copy (``state_copy``).  ``suffix``
    "_ref": the plain versions' calls instead (a run on the host CPU)."""
    global capture_log
    captured, originals = {}, {}
    capture_log = captured
    for tag in tags:
        mod, name = kernel_fn(tag, suffix)
        originals[tag] = orig = getattr(mod, name)

        def rec(*args, _tag=tag, _orig=orig):
            # K14 takes the rings of the state it is given (hand_over):
            # its call is kept with a copy of that state
            captured.setdefault(_tag, []).append(
                (args[0], state_copy(args[1]), *args[2:]) if _tag == "K14"
                else args)
            return _orig(*args)
        setattr(mod, name, rec)
    try:
        out = run()
    finally:
        for tag in tags:
            mod, name = kernel_fn(tag, suffix)
            setattr(mod, name, originals[tag])
    return out, captured


def check_scanner_kernel(tag: str, args, card: str, bound_db: float,
                         timed: bool, what: str | None = None) -> dict:
    """K5-K7 against its plain version on ``args`` (``what`` names the
    shape in the printout: scanner256's by default); with ``timed`` both
    are timed with CUDA events.  Raises on disagreement."""
    import torch
    mod, name = kernel_fn(tag, "")
    kern = getattr(mod, name + "_kernel")
    ref = getattr(mod, name + "_ref")
    got, want = kern(*args), ref(*args)
    torch.cuda.synchronize()
    if tag == "K6":       # (IF, sums, tails): the valid IF and the sums
        m = args[0].plan(args[8])["m"][-1]
        got, want = (got[0][:, :m], got[1]), (want[0][:, :m], want[1])
    elif tag == "K5" and args[0].M > 64:   # the large-M kernel writes
        V = args[1].shape[0] // args[0].h  # the valid frames' tiles only
        got, want = (got[:, :V],), (want[:, :V],)
    else:
        got, want = got if isinstance(got, tuple) else (got,), \
            want if isinstance(want, tuple) else (want,)
    g, w = got[0].float(), want[0].float()
    if not torch.isfinite(g).all():
        fail(f"{tag}: non-finite kernel output")
    err = float((g - w).abs().max())
    s = snr_db(w, g)
    agree = f"{s:.1f} dB SNR (bound {bound_db:.0f})"
    if tag == "K6":
        rel = float(((got[1] - want[1]).abs() / want[1].abs()).max())
        agree += f", squelch sums rel err {rel:.1e} (bound 1e-5)"
        if rel > 1e-5:
            fail(f"K6: squelch sums disagree: {rel}")
    out = {"name": name, "route": "cuda", "source": KERNELS[tag][2],
           "replaces": KERNELS[tag][3], "max_abs_err": err}
    if timed:
        out["ms"] = event_ms(lambda: kern(*args))
        out["plain_ms"] = event_ms(lambda: ref(*args))
        out["bound_ms"], out["bound_by"] = bound(tag, args)
        out["library_ms"] = None
        k_us, p_us = device_us(lambda: kern(*args)), device_us(
            lambda: ref(*args))
        print(f"{tag} {name}{f' ({what})' if what else ''}: kernel "
              f"{out['ms']:.4f} ms, plain "
              f"{out['plain_ms']:.4f} ms, library n/a, bound "
              f"{out['bound_ms']:.4f} ms ({out['bound_by']}), max|err| "
              f"{err:.3e}, {agree}; device time per call (profiler) "
              f"kernel {k_us:.1f} us, plain {p_us:.1f} us [{card}]")
        if not (tag == "K5" and args[0].M > 64):  # the large-M kernel's
            vs_parent(tag, k_us, out["bound_ms"], card)   # k5_yardsticks
        out["dev_us"] = k_us
    else:
        print(f"{tag} {name} {f'({what})' if what else f'at C = {SCAN_WIDE_C}'}"
              f": max|err| {err:.3e}, {agree}")
    if s < bound_db:
        fail(f"{tag}: kernel disagrees with its plain version: {agree}")
    return out


def drive_scanner(dev, card: str) -> dict:
    """Phases 6-9 on ``dev``; raises on the first failure.  Returns the
    K5-K7 entries of the kernel report."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_NFM
    from sdrplusplusbrown_tpu_torch.ops import precision

    radio = Radio(FS, DEMOD_NFM, squelch_enabled=True, device=dev)
    g = radio.in_multiple
    T = (STEP + g - 1) // g * g
    x = nfm_wideband(3 * T, SCAN_OFFSETS, SCAN_TONES)
    blocks = [(torch.from_numpy(x[b * T:(b + 1) * T].real.copy()).to(dev),
               torch.from_numpy(x[b * T:(b + 1) * T].imag.copy()).to(dev))
              for b in range(3)]

    def run3(handoff: str, C: int = SCAN_C, n: int = 3):
        precision.set_handoff_dtype(handoff)
        st = radio.init_state_channelized(C)
        outs = []
        for b in range(n):
            offs = (SCAN_OFFSETS if b < 2 else SCAN_RETUNE)[:C] if C == \
                SCAN_C else np.linspace(-1.1e6, 1.1e6, C) + 917.0
            params = radio.make_params_channelized(offs,
                                                   squelch_level=SQUELCH_DB)
            audio, st = radio.apply_channelized(params, st, blocks[b],
                                                mono_out=True)
            outs.append(audio)
        torch.cuda.synchronize()
        return outs

    # ---- 6. K5-K7 against their plain versions, scanner128 ---------------
    tags = ("K5", "K6", "K7")
    _, captured = capture(tags, lambda: run3("float32"))
    report = {}
    for tag in tags:
        report[tag] = check_scanner_kernel(tag, captured[tag][-1], card,
                                           100.0 if tag == "K5" else 80.0,
                                           timed=True)
    per_call = {"K5": 1}
    for tag in ("K6", "K7"):
        per_call[tag] = call_launches(tag, captured[tag][-1],
                                      "scanner128, float32")
        tails_exact(tag, captured[tag][-1], "scanner128, float32 handoff")
    check_outputs("K7", captured["K7"][-1], "scanner128, float32 handoff",
                  80.0)
    k6_yardstick(captured["K6"][-1], card)

    # ---- 7. the scanner main path, production bf16 handoff ---------------
    # CUDA launches a call: K5 one, K6 chan_post_plan's two, K7 fm_plan's
    reset_counts()
    outs = run3("bf16")
    for tag in tags:
        mod, name = kernel_fn(tag, "_kernel")
        n = getattr(mod, name).launches
        report[tag]["launches"] = n
        if n != 3 * per_call[tag]:
            fail(f"{tag}: {n} launches in 3 scanner steps, expected "
                 f"{3 * per_call[tag]}")
    for b, audio in enumerate(outs):
        if audio.shape != (SCAN_C, T // 50) or not torch.isfinite(audio).all():
            fail(f"scanner step {b}: shape {tuple(audio.shape)} or "
                 f"non-finite audio")
        opened = (audio.abs().amax(-1) > 0).nonzero().flatten().tolist()
        if opened != SCAN_TONES:
            fail(f"scanner step {b}: open channels {opened}, expected "
                 f"{SCAN_TONES}")
        if b:
            a = audio.double().cpu().numpy()
            snrs = [tone_snr_db(a[ch]) for ch in SCAN_TONES]
            print(f"scanner step {b}: {len(opened)} of {SCAN_C} channels "
                  f"open (the tone channels), tone SNR min "
                  f"{min(snrs):.1f} dB, mean {np.mean(snrs):.1f} dB "
                  f"(bound 40)")
            if min(snrs) < 40.0:
                fail(f"scanner step {b}: tone SNR {min(snrs):.1f} dB")
    print("scanner path: launches "
          + ", ".join(f"{t}={report[t]['launches']}" for t in tags)
          + f" (K6 and K7 counted at each CUDA launch: {per_call['K6']} "
          f"and {per_call['K7']} a step)")

    # ---- 8. scanner256: one step, one launch each ------------------------
    reset_counts()
    _, cap256 = capture(tags, lambda: run3("bf16", C=SCAN_WIDE_C, n=1))
    for tag in tags:
        mod, name = kernel_fn(tag, "_kernel")
        if getattr(mod, name).launches != per_call[tag]:
            fail(f"{tag}: {getattr(mod, name).launches} launches in one "
                 f"scanner256 step, expected {per_call[tag]}")
        # bf16 storage: a float32 difference that crosses a bf16 rounding
        # boundary moves a value by a bf16 ulp (2^-8)
        check_scanner_kernel(tag, cap256[tag][-1], card,
                             60.0 if tag == "K5" else 45.0, timed=False)
    for tag in ("K6", "K7"):
        call_launches(tag, cap256[tag][-1], "scanner256, bf16")
        tails_exact(tag, cap256[tag][-1], "scanner256, bf16 handoff")

    # ---- 9. the scanner128 step (bench.py's: raw mono audio) -------------
    precision.set_handoff_dtype("bf16")
    xn = noise_planes(T, dev)
    params = radio.make_params_channelized(SCAN_OFFSETS,
                                           squelch_level=SQUELCH_DB)
    n = step_rate(f"scanner128 (C={SCAN_C}, raw audio, bf16 handoff)",
                  lambda st: radio.apply_channelized(params, st, xn,
                                                     mono_out=True,
                                                     raw_audio=True)[1],
                  radio.init_state_channelized(SCAN_C), T, card)
    print(f"scanner128: {n:.1f} kernel launches a step (K6 {per_call['K6']} "
          f"and K7 {per_call['K7']} of them; 55 before K6 ran on the FIR "
          f"tile, K6 one)")
    return report


APP_TAGS = ("K8", "K9", "K10", "K4f")


def app_stage(call) -> str:
    """Name of the K8 geometry a captured call (x, tail, kern, I, D) has:
    dtype, rows, I/D and kernel width."""
    x, _, kern, I, D = call
    rows = x.numel() // x.shape[-1]
    return f"{'complex' if x.is_complex() else 'real'} rows {rows} I/D " \
        f"{I}/{D} kw {kern.shape[1]}"


def per_step(paths: dict) -> str:
    """'path n, ...' of a geometry's launches a step on each path."""
    return ", ".join(f"{p} {n:g}" for p, n in paths.items())


def library_call(tag: str, args):
    """One PyTorch call computing kernel ``tag``'s function on ``args``
    (its inputs prepared outside the timed call), or None."""
    import torch
    import torch.nn.functional as F
    if tag == "K8":
        x, tail, kern, I, D = args
        ext = torch.cat([tail, x], dim=-1)
        W = ext.shape[-1]
        rows = (torch.cat([ext.real.reshape(-1, W), ext.imag.reshape(-1, W)])
                if x.is_complex() else ext.reshape(-1, W))[:, None]
        return lambda: F.conv1d(rows, kern[:, None], stride=D)
    if tag == "K9":
        x, tail, taps, D = args
        ext = torch.cat([tail, x], dim=-1)
        W = ext.shape[-1]
        planes = torch.stack([ext.real.reshape(-1, W),
                              ext.imag.reshape(-1, W)], dim=1)
        hr, hi = taps[0], taps[1]
        ker = torch.stack([torch.stack([hr, -hi]), torch.stack([hi, hr])])
        return lambda: F.conv1d(planes, ker, stride=D)
    if tag == "K3":     # one strided correlation: one conv1d call
        pipe, raw, m_in, ptail, dt = args
        ext = torch.cat([ptail, raw[:, :m_in].float()], dim=1)[:, None]
        ker = pipe.taps(raw.device, dt)[:, None, :]
        return lambda: F.conv1d(ext, ker, stride=pipe.D)
    if tag == "K4":     # the FFT of the windowed frames
        from sdrplusplusbrown_tpu_torch.ops import fft_kernel as k4
        xr, xi, keep, interval, N, _, window = args
        starts = k4.frame_starts(xr.shape[0], keep, interval)
        fr = torch.stack([torch.complex(xr[p:p + keep], xi[p:p + keep])
                          for p in starts]) * window
        return lambda: torch.fft.fft(fr, n=N, dim=-1)
    if tag == "K4f":
        from sdrplusplusbrown_tpu_torch.ops import fft_kernel as k4
        x, keep, interval, N, _, window = args
        starts = k4.frame_starts(x.shape[0], keep, interval, align=1)
        fr = torch.stack([x[p:p + keep] for p in starts]) * window
        return lambda: torch.fft.fft(fr, n=N, dim=-1)
    if tag == "K4r":    # the FFT of every channel's frames
        xr, xi, N = args[:3]
        fr = torch.complex(xr.float(), xi.float())
        return lambda: torch.fft.fft(fr, n=N, dim=-1)
    if tag == "K11":    # the pre-twiddle sums: one strided 2-in conv
        xr, xi, tr, ti, h, D, omega = args[:7]
        k = torch.arange(h.shape[0], dtype=torch.float32, device=h.device)
        ang = omega[:, None] * k
        gr, gi = h * torch.cos(ang), h * torch.sin(ang)
        ker = torch.cat([torch.stack([gr, -gi], dim=1),
                         torch.stack([gi, gr], dim=1)])
        ext = torch.stack([torch.cat([tr, xr]), torch.cat([ti, xi])])[None]
        return lambda: F.conv1d(ext, ker, stride=D)
    return None


def check_app_kernel(tag: str, args, card: str, what: str,
                     timed: bool = True, plain_reps: int = 20,
                     min_db: float = 100.0) -> dict:
    """K8-K12, K4f, K4r, K5c, K14 or K15 against its plain version on
    ``args``
    (``min_db`` SNR, or the spectra's dB bars); with ``timed`` both are
    timed with CUDA events beside the library call (the plain version
    over ``plain_reps`` calls; with 0, for a per-sample plain loop of
    ~10^5 launches a call, its one call that the comparison makes, and
    no profiler window).  Raises on disagreement."""
    import torch
    mod, name = kernel_fn(tag, "")
    kern = getattr(mod, name + "_kernel")
    ref = getattr(mod, name + "_ref")
    if tag == "K14":    # K14 takes the rings it is given: it runs on a
        kern_call = k14_chain(kern, (args[0], state_copy(args[1]),  # copy
                                     *args[2:]))
    else:
        kern_call = functools.partial(kern, *args)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    marks[0].record()
    want = ref(*args)
    marks[1].record()
    got = kern_call()
    torch.cuda.synchronize()
    if tag in ("K8", "K9"):     # (y, new tail): the tail is a copy
        if not torch.equal(got[1], want[1]):
            fail(f"{tag} {what}: new tail differs from the plain version")
        got, want = got[0], want[0]
    if tag == "K12":            # (y, amp, env): the state exact
        if not (torch.equal(got[1], want[1])
                and torch.equal(got[2], want[2])):
            fail(f"K12 {what}: the new state differs from the plain "
                 f"version")
        got, want = got[0], want[0]
    if tag == "K14":            # (state, hw): the history exact, then
        for k in ("hist", "dev_hist", "sums", "devs", "count", "pos",
                  "has_prev"):  # the gains and X held to min_db
            if not torch.equal(got[0][k], want[0][k]):
                fail(f"K14 {what}: the new {k} differs from the plain "
                     f"version")
        got, want = (torch.cat([got[1].flatten(), got[0]["Xk_prev"]
                                .flatten()]),
                     torch.cat([want[1].flatten(), want[0]["Xk_prev"]
                                .flatten()]))
    if tag == "K15" and isinstance(got, tuple):     # a fused form's (out,
        got, want = (torch.cat([t.flatten() for t in got]),  # new state)
                     torch.cat([t.flatten() for t in want]))
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{tag} {what}: non-finite kernel output")
    err = float((got - want).abs().max())
    if tag in ("K4f", "K4r"):
        pk = want.max(dim=-1, keepdim=True).values
        d = (got - want).abs()
        e60 = float(d[want > pk - 60].max())
        e80 = float(d[want > pk - 80].max())
        agree = f"{e60:.2e} dB within 60 dB, {e80:.2e} within 80 dB"
        ok = e60 <= 0.01 and e80 <= 0.1
    elif not want.any():
        ok = torch.equal(got, want)
        agree = "all-zero plain output, kernel " + ("equal" if ok else
                                                    "not equal")
    else:
        sn = snr_db(want, got)
        agree = f"{sn:.1f} dB SNR (bound {min_db:.0f})"
        ok = sn >= min_db
    if not timed:
        print(f"{tag} {name} ({what}): max|err| {err:.3e}, {agree}")
        if not ok:
            fail(f"{tag} {what}: kernel disagrees with its plain version: "
                 f"{agree}")
        return {"max_abs_err": err}
    ms = event_ms(kern_call)
    plain_ms = event_ms(lambda: ref(*args), plain_reps) if plain_reps \
        else marks[0].elapsed_time(marks[1])
    lib = library_call(tag, args)
    library_ms = event_ms(lib) if lib is not None else None
    split = {}
    k_us, n_launch = call_profile(kern_call, by_kernel=split)
    us = [k_us, device_us(lambda: ref(*args), plain_reps)
          if plain_reps else float("nan")]
    if lib is not None:
        us.append(device_us(lib))
    if tag == "K4f":
        fft_launches(tag, n_launch, args[3], args[0].shape[0] // args[2],
                     split)
    if tag == "K4r":
        fft_launches(tag, n_launch, args[2], args[0].numel() // args[2],
                     split)
    bms, by = bound(tag, args)
    libs = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"{tag} {name} ({what}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, library {libs}, bound {bms:.4f} ms ({by}), max|err| "
          f"{err:.3e}, {agree}; device time per call (profiler) kernel "
          f"{us[0]:.1f} us in {n_launch:.0f} launches, plain {us[1]:.1f} us"
          + (f", library {us[2]:.1f} us" if lib is not None else "")
          + f" [{card}]")
    vs_parent(tag, us[0], bms, card)
    if not ok:
        fail(f"{tag} {what}: kernel disagrees with its plain version: "
             f"{agree}")
    return {"name": name, "route": "cuda", "source": KERNELS[tag][2],
            "replaces": KERNELS[tag][3], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def drive_app(dev, card: str) -> dict:
    """Phases 10-12 on ``dev``; raises on the first failure.  Returns the
    K8-K10 and K4f entries of the kernel report."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.iq_frontend import IQFrontEnd
    from sdrplusplusbrown_tpu_torch.models.radio import (Radio, DEMOD_NFM,
                                                         DEMOD_WFM)
    from sdrplusplusbrown_tpu_torch.ops.spectrum import make_fft_window

    fe = IQFrontEnd(FS, decim_ratio=1, fft_size=FFT, fft_rate=20.0,
                    device=dev)
    wfm = Radio(FS, DEMOD_WFM, squelch_enabled=True, device=dev)
    nfm = Radio(FS, DEMOD_NFM, squelch_enabled=True, device=dev)
    g = int(np.lcm.reduce([fe.in_multiple, wfm.in_multiple,
                           nfm.in_multiple]))
    T = (STEP + g - 1) // g * g

    def blocks(x):
        return [torch.from_numpy(x[b * T:(b + 1) * T]).to(dev)
                for b in range(3)]

    x_wfm = blocks(stereo_wideband(3 * T, APP_WFM))
    x_nfm = blocks(nfm_wideband(3 * T, APP_NFM, range(len(APP_NFM))))
    x_wfm8 = blocks(stereo_wideband(3 * T, OFFSETS))

    def run3(xs, radios):
        """Three app steps: IQFrontEnd, then each (radio, offsets, batch,
        squelch level) on its baseband, the radios retuned before step 3.
        Returns [(spectra, [audio per radio])]."""
        fst = fe.init_state()
        states = [r.init_state(batch) for r, _, batch, _ in radios]
        outs = []
        for b, xb in enumerate(xs):
            (bb, spectra), fst = fe.apply(None, fst, xb)
            auds = []
            for i, (r, offs, _, lvl) in enumerate(radios):
                p = r.make_params(offs[0] if b < 2 else offs[1],
                                  squelch_level=lvl)
                a, states[i] = r.apply(p, states[i], bb)
                auds.append(a)
            outs.append((spectra, auds))
        torch.cuda.synchronize()
        return outs

    wfm1 = [(wfm, APP_WFM, (), None)]
    nfm2 = [(nfm, APP_NFM, (), None), (nfm, APP_NFM_OFF, (), SQUELCH_DB)]
    wfm8 = [(wfm, (OFFSETS, RETUNE), (C,), None)]

    # ---- 10. K8, K9, K10, K4f against their plain versions ---------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 10: TF32 off for every kernel/plain/library comparison "
          "(torch.backends.cudnn.allow_tf32 = False, "
          "torch.backends.cuda.matmul.allow_tf32 = False)")
    _, cap = capture(APP_TAGS, lambda: run3(x_wfm, wfm1))
    _, cap_n = capture(("K8",), lambda: run3(x_nfm, nfm2))
    _, cap8 = capture(("K8", "K10"), lambda: run3(x_wfm8, wfm8))
    # every distinct K8 geometry of the three paths, each held against the
    # plain version on its last call (state settled) and timed, with its
    # launches a step on each path
    stages = {}
    for path, c in (("WFM ()", cap), ("NFM ()", cap_n), (f"WFM ({C},)", cap8)):
        for call in c["K8"]:
            paths, last = stages.get(app_stage(call), ({}, None))
            paths[path] = paths.get(path, 0) + 1 / 3
            # a squelched radio's all-zero block checks nothing: keep the
            # last call with data
            keep = last is not None and not bool(call[0].any())
            stages[app_stage(call)] = (paths, last if keep else call)
    timed = {"stage-0 decimator": ("complex", 1, 4), "bandwidth FIR":
             ("complex", 1, 1), "5/6 polyphase": ("complex", 5, 6),
             "48/125 audio polyphase": ("real", 48, 125)}
    names = {}
    for what, (kind, I, D) in timed.items():
        key = [k for k in stages if k.startswith(f"{kind} rows ")
               and f" I/D {I}/{D} " in k and "WFM ()" in stages[k][0]]
        if len(key) != 1:
            fail(f"K8: no single WFM () {what} call among {sorted(stages)}")
        names[key[0]] = what
    report, k8 = {}, []
    for key in sorted(stages):
        paths, call = stages[key]
        what = f"{names.get(key, 'stage')}, {key}"
        k8.append(check_app_kernel(
            "K8", call, card, f"{what}, launches a step: {per_step(paths)}"))
    print(f"K8: {len(stages)} distinct geometries held against the plain "
          f"version (100 dB, the new tail exact) and timed")
    report["K8"] = dict(k8[0], max_abs_err=max(e["max_abs_err"]
                                               for e in k8))
    for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
        report["K8"][k] = sum(e[k] for e in k8)
    report["K8"]["bound_by"] = "+".join(sorted({e["bound_by"] for e in k8}))
    report["K9"] = check_app_kernel("K9", cap["K9"][-1], card,
                                    "pilot band-pass")
    report["K10"] = check_app_kernel("K10", cap8["K10"][-1], card,
                                     f"stereo section, C = {C}")
    report["K4f"] = check_app_kernel("K4f", cap["K4f"][-1], card,
                                     f"{FFT} points")
    keep = fe.spectrum.reshaper.interval
    win = torch.from_numpy(make_fft_window("nuttall", keep)).to(dev)
    check_app_kernel("K4f", (x_wfm[0], keep, keep, 262_144, -300.0, win),
                     card, "262144 points")

    # ---- 11. the app step, three steps with a retune ---------------------
    reset_counts()
    seen = {}

    def counted_run(label, xs, radios):
        before = {t: kernel_count(t) for t in APP_TAGS}
        outs, cap = capture(APP_TAGS, lambda: run3(xs, radios))
        seen[label] = {t: kernel_count(t) - before[t] for t in APP_TAGS}
        hold_launches(f"app step, {label}, 3 steps", seen[label], cap)
        for spectra, auds in outs:
            for a in auds:
                if not torch.isfinite(a).all():
                    fail(f"{label}: non-finite audio")
            if spectra.shape != (T // fe.spectrum.reshaper.interval, FFT):
                fail(f"{label}: spectra {tuple(spectra.shape)}")
        return outs

    outs = counted_run("WFM, batch ()", x_wfm, wfm1)
    n = seen["WFM, batch ()"]
    if min(n["K4f"], n["K8"], n["K9"]) < 1 or n["K10"]:
        fail(f"WFM batch (): launch pattern {n}")
    for b in (1, 2):
        aud = outs[b][1][0].double().cpu().numpy()[None]
        snr, sep = stereo_oracle(aud[..., APP_SKIP:] if b == 2 else aud)
        print(f"WFM step {b}: tone SNR {snr:.1f} dB (bound 35), L/R "
              f"separation {sep:.1f} dB (bound 25)")
        if snr <= 35.0 or sep <= 25.0:
            fail(f"WFM step {b}: audio oracle failed")
        sp = outs[b][0][0].cpu().numpy()
        floor = np.percentile(sp, 2)
        w = int(75e3 / FS * FFT)
        for o in APP_WFM:
            k = int((o / FS + 0.5) * FFT)
            if sp[k - w:k + w].max() < floor + 30.0:
                fail(f"WFM step {b}: no spectrum peak at {o:.0f} Hz")
        fmax = (int(np.argmax(sp)) / FFT - 0.5) * FS
        if np.min(np.abs(np.array(APP_WFM) - fmax)) > 100e3:
            fail(f"WFM step {b}: spectrum peak at {fmax:.0f} Hz")
    outs = counted_run("NFM, batch (), two radios", x_nfm, nfm2)
    for b in range(3):
        on, off = outs[b][1]
        if on.shape != (2, T // 50) or off.any():
            fail(f"NFM step {b}: shape {tuple(on.shape)} or the squelched "
                 f"radio is not silent")
        if b:
            row = on[0].double().cpu().numpy()
            snr = tone_snr_db(row[APP_SKIP:] if b == 2 else row)
            print(f"NFM step {b}: tone SNR {snr:.1f} dB (bound 40), the "
                  f"radio off the signal (squelch {SQUELCH_DB:.0f} dB) "
                  f"exactly silent")
            if snr <= 40.0:
                fail(f"NFM step {b}: tone SNR {snr:.1f} dB")
    outs = counted_run(f"WFM, batch ({C},)", x_wfm8, wfm8)
    n = seen[f"WFM, batch ({C},)"]
    if n["K10"] < 1 or n["K9"]:
        fail(f"WFM batch ({C},): launch pattern {n}")
    for b in (1, 2):
        on = [ch for ch in range(C) if b < 2 or RETUNE[ch] == OFFSETS[ch]]
        snr, sep = stereo_oracle(outs[b][1][0].double().cpu().numpy()[on])
        print(f"WFM-{C} step {b}: tone SNR {snr:.1f} dB (bound 35), L/R "
              f"separation {sep:.1f} dB (bound 25)")
        if snr <= 35.0 or sep <= 25.0:
            fail(f"WFM-{C} step {b}: audio oracle failed")
    # launches: those of the path each entry was measured on; every
    # path's own count beside it
    for t in APP_TAGS:
        path = f"WFM, batch ({C},)" if t == "K10" else "WFM, batch ()"
        report[t]["launches"] = seen[path][t]
        report[t]["launches_path"] = path
        report[t]["launches_by_path"] = {p: v[t] for p, v in seen.items()}

    # ---- 12. the app step's rate and profile ------------------------------
    xn = torch.complex(*noise_planes(T, dev))
    for label, batch, offs in (("WFM", (), APP_WFM[0]),
                               (f"WFM-{C}", (C,), OFFSETS)):
        params = wfm.make_params(offs)

        def step(st, params=params):
            (bb, _), fst = fe.apply(None, st[0], xn)
            return fst, wfm.apply(params, st[1], bb)[1]
        step_rate(f"app step IQFrontEnd + Radio.apply {label} (batch "
                  f"{batch}, squelch on, fft {FFT})", step,
                  (fe.init_state(), wfm.init_state(batch)), T, card)
    quad_cost(wfm, dev, card)
    return report


def quad_cost(radio, dev, card: str) -> None:
    """What Radio.apply's discriminator costs on the card: ``quad_xla``
    (XLA's complex multiply, float64 elementwise ops) beside K2's plain
    ``quad_planes`` on the same WFM IF planes (50 000 samples per step),
    at batch () and (8,): device time and launches per call."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops import demod
    inv = radio.demod.quad.inv_deviation
    g = torch.Generator(device=dev).manual_seed(3)
    for batch in ((), (C,)):
        x = torch.randn(batch + (50_001,), generator=g, device=dev,
                        dtype=torch.complex64)
        er, ei = x.real[..., 1:], x.imag[..., 1:]
        erp, eip = x.real[..., :-1], x.imag[..., :-1]
        cost = {name: call_profile(lambda f=f: f(er, ei, erp, eip, inv))
                for name, f in (("quad_xla", demod.quad_xla),
                                ("quad_planes", demod.quad_planes))}
        print(f"discriminator at batch {batch}, 50000 samples: "
              + "; ".join(f"{n} {us:.1f} us device, {ln:.0f} launches per "
                          f"call" for n, (us, ln) in cost.items())
              + f" [{card}]")


BANK_FS = (2_400_000.0, 10_000_000.0)
BANK_SECONDS = 0.1       # per step, rounded up to the bank's granularity
BANK_STEPS = 5
BANK_MARGIN_DB = 3.0     # the card's tone SNR may sit this far under the CPU's
# and never under this: the AM and USB audio AGC (attack 50/IF) follows
# the rectified 1 kHz tone and distorts it, so their tone SNR is ~21 dB
# on the plain path too
BANK_MIN_DB = 15.0
BANK_TAGS = ("K1", "K7", "K8", "K11", "K12")
# a kernel's bf16 output against its plain version's: a float32
# difference that crosses a bf16 rounding boundary moves a value by 2^-8
BF16_DB = 45.0


def multimode_wideband(n: int, fs: float, carriers,
                       seed: int = 13) -> np.ndarray:
    """One carrier per (demod id, offset Hz) pair, plus low noise: NFM
    an FM carrier (1 kHz tone, 2 kHz peak deviation), AM a 50 % AM
    carrier (1 kHz tone), USB a carrier 1 kHz above the VFO's suppressed
    carrier (its offset is the passband's centre, 1.4 kHz higher), any
    other mode a carrier on the offset."""
    from sdrplusplusbrown_tpu_torch.models.radio import (DEMOD_AM,
                                                         DEMOD_NFM,
                                                         DEMOD_USB)
    t = np.arange(n) / fs
    tone = np.sin(2 * np.pi * TONE_HZ * t)
    fm = 2 * np.pi * 2000.0 * np.cumsum(tone) / fs
    rng = np.random.default_rng(seed)
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for d, f in carriers:
        if d == DEMOD_NFM:
            x = x + 0.2 * np.exp(1j * (2 * np.pi * f * t + fm))
        elif d == DEMOD_AM:
            x = x + 0.2 * (1 + 0.5 * tone) * np.exp(2j * np.pi * f * t)
        elif d == DEMOD_USB:
            x = x + 0.1 * np.exp(2j * np.pi * (f - 400.0) * t)
        else:
            x = x + 0.1 * np.exp(2j * np.pi * f * t)
    return x.astype(np.complex64)


def bank_label(fs: float) -> str:
    return f"multimode8 @ {fs / 1e6:g} MS/s"


def drive_bank(dev, card: str, report: dict) -> dict:
    """Phases 13-15 on ``dev``; raises on the first failure.  Returns the
    K11 and K12 entries of the kernel report and adds the bank paths'
    launches to the K1, K7 and K8 entries."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    from sdrplusplusbrown_tpu_torch.ops import precision

    vfos = rb.multimode8_vfos()
    banks, xs = {}, {}
    for fs in BANK_FS:
        bank = rb.RadioBank(fs, vfos, device=dev)
        g = bank.in_multiple
        T = -(-int(fs * BANK_SECONDS) // g) * g
        x = multimode_wideband(BANK_STEPS * T, fs,
                               [(v.demod_id, v.offset_hz) for v in vfos])
        banks[fs] = (bank, T)
        xs[fs] = [(torch.from_numpy(x[b * T:(b + 1) * T].real.copy()),
                   torch.from_numpy(x[b * T:(b + 1) * T].imag.copy()))
                  for b in range(BANK_STEPS)]
        print(f"{bank_label(fs)}: T = {T}, routes "
              + ", ".join(f"{r.demod_name} {r._build_vfo_shared().route}"
                          for r in bank.radios.values()))

    def run(fs, device, steps):
        """``steps`` bank steps on ``device`` (the host's copy of the bank
        for the CPU); the audio of each."""
        bank = banks[fs][0] if device != "cpu" else rb.RadioBank(
            fs, vfos, device="cpu")
        params, st, outs = bank.make_params(), bank.init_state(), []
        for b in range(steps):
            xb = tuple(t.to(device) for t in xs[fs][b])
            audio, st = bank.apply(params, st, xb, mono_out=True)
            outs.append(audio)
        if device != "cpu":
            torch.cuda.synchronize()
        return outs

    # ---- 13. K1, K7, K11, K12 and the bank's K8 geometries against plain --
    precision.set_handoff_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k7_per = {}         # K7's CUDA launches a call on each bank
    caps = {fs: capture(BANK_TAGS, lambda fs=fs: run(fs, dev, 2))[1]
            for fs in BANK_FS}
    # K1 and K7 at the bank's own shapes: at 2.4 MS/s K1 takes the NFM
    # (raw buffer) and the AM and USB chains (float32 IF), K7 the NFM
    # group's K1 buffer; at 10 MS/s K7 reads K11 + K8's float32 buffer.
    # Each group's call of the second step, then the same with the
    # production bf16 handoff, where K1 rounds its taps to bf16 and
    # writes the raw buffer (and K7 its audio) in bf16
    bank24 = banks[BANK_FS[0]][0]
    n24 = len(bank24.radios)
    for fs in BANK_FS:
        for i, call in enumerate(caps[fs].get("K1", [])[-n24:]):
            check_outputs("K1", call, f"{bank_label(fs)} group {i}, "
                          f"float32 handoff", 100.0)
            tails_exact("K1", call, f"{bank_label(fs)} group {i}, float32 "
                        f"handoff")
        check_outputs("K7", caps[fs]["K7"][-1],
                      f"{bank_label(fs)}, float32 handoff", 100.0)
        tails_exact("K7", caps[fs]["K7"][-1],
                    f"{bank_label(fs)}, float32 handoff")
        k7_per[fs] = call_launches("K7", caps[fs]["K7"][-1],
                                   f"{bank_label(fs)}, float32")
    precision.set_handoff_dtype("bf16")
    for fs in BANK_FS:
        cap16 = capture(("K1", "K7"), lambda fs=fs: run(fs, dev, 2))[1]
        for i, call in enumerate(cap16.get("K1", [])[-n24:]):
            f32_if = call[7] == torch.float32
            check_outputs("K1", call, f"{bank_label(fs)} group {i}, bf16 "
                          f"handoff, {'float32 IF' if f32_if else 'raw'}",
                          100.0 if f32_if else BF16_DB)
            tails_exact("K1", call, f"{bank_label(fs)} group {i}, bf16 "
                        f"handoff")
        check_outputs("K7", cap16["K7"][-1],
                      f"{bank_label(fs)}, bf16 handoff", BF16_DB)
        tails_exact("K7", cap16["K7"][-1], f"{bank_label(fs)}, bf16 handoff")
        call_launches("K7", cap16["K7"][-1], f"{bank_label(fs)}, bf16")
    if len(caps[BANK_FS[0]].get("K1", [])) != 2 * n24 or \
            caps[BANK_FS[1]].get("K1"):
        fail("K1: not one call per group and step at 2.4 MS/s only")
    precision.set_handoff_dtype("float32")
    k11 = caps[BANK_FS[1]]["K11"]
    n_groups = len(banks[BANK_FS[1]][0].radios)
    for i, call in enumerate(k11[-n_groups:-1]):
        check_app_kernel("K11", call, card, f"10 MS/s group {i}",
                         timed=False)
    out = {"K11": check_app_kernel("K11", k11[-1], card,
                                   "10 MS/s, last group, C = 4")}
    # K11 is not on the 2.4 MS/s path (K1 takes every chain): held at its
    # groups' stage-0 shapes all the same
    xr, xi = (t.to(dev).contiguous() for t in xs[BANK_FS[0]][0])
    for d, r in bank24.radios.items():
        fused = r._build_vfo_shared().fused
        p = bank24.make_params()[d]["vfo"]["fused"]
        st = bank24.init_state()[d]["vfo"]["fused"]
        check_app_kernel("K11", (xr, xi, st["tail"].real.contiguous(),
                                 st["tail"].imag.contiguous(), fused.h(dev),
                                 fused.decim, p["omega"], st["phase"],
                                 p["omega_dec"], p["omega_dec_span"]),
                         card, f"2.4 MS/s {r.demod_name} stage 0, K = "
                         f"{fused.K}, not on the path", timed=False)
    shapes = {}
    for fs in BANK_FS:
        for call in caps[fs]["K12"]:
            shapes[(bank_label(fs), tuple(call[1].shape))] = call
    timed = (bank_label(BANK_FS[0]), max(k[1] for k in shapes
                                         if k[0] == bank_label(BANK_FS[0])))
    for key, call in sorted(shapes.items()):
        what = f"{key[0]}, rows x T {key[1][0]} x {key[1][1]}"
        if key == timed:
            out["K12"] = check_app_kernel("K12", call, card, what,
                                          plain_reps=2)
        else:
            check_app_kernel("K12", call, card, what, timed=False)
        k12_floor(call, what, card)
    stages = {}
    for fs in BANK_FS:
        for call in caps[fs]["K8"]:
            paths, _ = stages.get(app_stage(call), ({}, None))
            paths[bank_label(fs)] = paths.get(bank_label(fs), 0) + 1 / 2
            stages[app_stage(call)] = (paths, call)
    # every geometry timed: at 10 MS/s the first decimator behind K11 is
    # the TPU's _plane_decim_kernel, the USB polyphase its _plane_poly
    # kernels
    for key in sorted(stages):
        paths, call = stages[key]
        check_app_kernel("K8", call, card,
                         f"{key}, launches a step: {per_step(paths)}")
    print(f"K8: {len(stages)} distinct geometries of the two bank paths held "
          f"against the plain version (100 dB, the new tail exact) and "
          f"timed")

    # ---- 14. five steps of each bank, production bf16 handoff -------------
    precision.set_handoff_dtype("bf16")
    expect = {BANK_FS[0]: ("K1", "K11"), BANK_FS[1]: ("K11", "K1")}
    for fs in BANK_FS:
        label = bank_label(fs)
        reset_counts()
        outs, cap = capture(BANK_TAGS, lambda fs=fs: run(fs, dev, BANK_STEPS))
        n = {t: kernel_count(t) for t in BANK_TAGS}
        hold_launches(f"{label}, {BANK_STEPS} steps", n, cap)
        print(f"{label}: K7 {k7_per[fs]} CUDA launches a call")
        on, off = expect[fs]
        if min(n[on], n["K7"], n["K8"], n["K12"]) < 1 or n[off]:
            fail(f"{label}: launch pattern {n}")
        for t in BANK_TAGS:
            entry = out.get(t, report.get(t))
            entry.setdefault("launches_by_path", {})[
                f"{label} ({BANK_STEPS} steps)"] = n[t]
            if t in ("K11", "K12") and (t == "K12") == (fs == BANK_FS[0]):
                entry["launches"] = n[t]
                entry["launches_path"] = f"{label} ({BANK_STEPS} steps)"
        for a in outs:
            for d, y in a.items():
                if y.shape != (len(banks[fs][0].groups[d]),
                               banks[fs][1] * 48_000 // int(fs)) or \
                        not torch.isfinite(y).all():
                    fail(f"{label}: group {d} audio {tuple(y.shape)} or "
                         f"non-finite")
        cpu = run(fs, "cpu", BANK_STEPS)[-1]
        rows = []
        for d, y in outs[-1].items():
            for i, v in enumerate(banks[fs][0].groups[d]):
                got = tone_snr_db(y[i].double().cpu().numpy())
                ref = tone_snr_db(cpu[d][i].double().numpy())
                bar = max(ref - BANK_MARGIN_DB, BANK_MIN_DB)
                rows.append(f"{v.name} {got:.1f} (CPU {ref:.1f}, bar "
                            f"{bar:.1f})")
                if got < bar:
                    fail(f"{label}: {v.name} tone SNR {got:.1f} dB, bar "
                         f"{bar:.1f}")
        print(f"{label} step {BANK_STEPS}: tone SNR dB, card against the "
              f"port's plain path on the host CPU: " + "; ".join(rows))

    # ---- 15. each bank's step on bench-style noise -------------------------
    for fs in BANK_FS:
        bank, T = banks[fs]
        xn = noise_planes(T, dev)
        params = bank.make_params()
        step_rate(f"{bank_label(fs)} (bf16 handoff, mono audio)",
                  lambda st, b=bank, p=params, x=xn:
                  b.apply(p, st, x, mono_out=True)[1],
                  bank.init_state(), T, card)
    return out


CHZ_TONES = list(range(3, CHZ_M, 8))     # one tone every 8th channel
CHZ_TONE_HZ = 20e3                       # each tone's offset from its centre


def chz_wideband(T: int, freqs, seed: int = 17) -> tuple:
    """The channelizer64 oracle input: a tone of amplitude 0.3 at
    ``freqs[m]`` + 20 kHz for every m in CHZ_TONES, over N(0, 0.1²) noise;
    (re, im) float32 planes."""
    rng = np.random.default_rng(seed)
    x = 0.1 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    t = np.arange(T) / CHZ_FS
    for m in CHZ_TONES:
        x = x + 0.3 * np.exp(2j * np.pi * (freqs[m] + CHZ_TONE_HZ) * t)
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def chz_tone_oracle(spec) -> str:
    """Every tone of ``chz_wideband`` peaks in its own channel at its bin
    (20 kHz of the 156.25 kHz channel: bin 131 of 1024, ±2) at least 25 dB
    over the noise floor (the median of the other channels' bins), and no
    other channel rises 20 dB over that floor.  Raises, or returns a
    summary line."""
    sp = spec.float().cpu().numpy()                # [M, F, N]
    M, _, N = sp.shape
    others = [m for m in range(M) if m not in CHZ_TONES]
    floor = float(np.median(sp[others]))
    want = round(CHZ_TONE_HZ / (CHZ_FS / M) * N)
    peaks = []
    for m in CHZ_TONES:
        avg = sp[m].mean(axis=0)
        kmax = int(np.argmax(avg))
        peaks.append(float(avg[kmax]) - floor)
        if abs(kmax - want) > 2 or peaks[-1] < 25.0:
            fail(f"channelizer64: channel {m}'s tone peaks at bin {kmax}, "
                 f"{peaks[-1]:.1f} dB over the floor (want bin {want}, "
                 f">= 25 dB)")
    rise = float(sp[others].max()) - floor
    if rise > 20.0:
        fail(f"channelizer64: a channel without a tone rises {rise:.1f} dB "
             f"over the floor")
    return (f"{len(CHZ_TONES)} tones each at bin {want} of its channel, "
            f"{min(peaks):.1f}-{max(peaks):.1f} dB over the floor "
            f"({floor:.1f} dB; bound 25), the other {len(others)} channels "
            f"at most {rise:.1f} dB over it (bound 20)")


def drive_channelizer(dev, card: str) -> dict:
    """Phases 16-18 on ``dev``; raises on the first failure.  Returns the
    K5c and K4r entries of the kernel report."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops import precision

    ch, step = channelizer64(dev)
    M, T = CHZ_M, CHZ_T
    xr, xi = chz_wideband(3 * T, ch.channel_freqs())
    blocks = [(torch.from_numpy(xr[b * T:(b + 1) * T]).to(dev),
               torch.from_numpy(xi[b * T:(b + 1) * T]).to(dev))
              for b in range(3)]

    def run3():
        st, outs = ch.init_state(), []
        for xb in blocks:
            spec, st = step(st, xb)
            outs.append((spec, st))
        torch.cuda.synchronize()
        return outs

    # ---- 16. K5c and K4r against their plain versions ---------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    for handoff in ("float32", "bf16"):
        precision.set_handoff_dtype(handoff)
        _, cap = capture(("K5c", "K4r"), run3)
        f32 = handoff == "float32"
        # the production bf16 handoff is the one timed
        report["K5c"] = check_app_kernel(
            "K5c", cap["K5c"][-1], card, f"M = {M}, tpp = {ch.tpp}, T = {T}, "
            f"W = {cap['K5c'][-1][5]}, {handoff} bins", timed=not f32,
            min_db=100.0 if f32 else BF16_DB)
        report["K4r"] = check_app_kernel(
            "K4r", cap["K4r"][-1], card, f"{M} channels x "
            f"{cap['K4r'][-1][0].shape[1]} frames of {CHZ_FFT}, {handoff} "
            f"bins read in place", timed=not f32)
    pipe = ch.pfb()
    W = cap["K5c"][-1][5]
    print(k5_as_written(pipe, W, cap["K5c"][-1][6],
                        report["K5c"]["bound_ms"], report["K5c"]["bound_by"]))

    # ---- 17. three channelizer64 steps, production bf16 handoff ----------
    reset_counts()
    outs, cap = capture(("K5c", "K4r"), run3)
    n = {t: kernel_count(t) for t in ("K5c", "K4r", "K5", "K4", "K4f",
                                      "K1", "K11")}
    hold_launches("channelizer64, 3 steps", n, cap)
    if n["K5c"] != 3 or n["K4r"] != 3 or any(
            n[t] for t in ("K5", "K4", "K4f", "K1", "K11")):
        fail(f"channelizer64: launch pattern {n}")
    report["K5c"]["launches"] = report["K4r"]["launches"] = 3
    nh = pipe.n_hist
    for b, (spec, st) in enumerate(outs):
        if spec.shape != (M, T // (M * CHZ_FFT), CHZ_FFT) or \
                not torch.isfinite(spec).all():
            fail(f"channelizer64 step {b}: spectra {tuple(spec.shape)} or "
                 f"non-finite")
        tail = torch.complex(blocks[b][0][-nh:], blocks[b][1][-nh:])
        if not torch.equal(pipe.state_to_xw(st), tail):
            fail(f"channelizer64 step {b}: the carried state is not the "
                 f"block's last {nh} samples")
        print(f"channelizer64 step {b}: {chz_tone_oracle(spec)}; state "
              f"carried exactly")

    # ---- 18. the channelizer64 step on bench.py's noise -------------------
    xn = tuple(torch.from_numpy(a).to(dev) for a in channelizer64_noise())
    step_rate(f"channelizer64 (M={M}, fft {CHZ_FFT}, bf16 handoff)",
              lambda st: step(st, xn)[1], ch.init_state(), T, card)
    return report


def k5_as_written(pipe, W: int, tap_dtype, bound_ms: float,
                  bound_by: str, rows=None, T: int | None = None) -> str:
    """What K5's design costs as written on ``W`` frames: the fold's
    2·K0 float32 multiply-adds a frame and plane at the FP32 peak, and the
    DFT's tensor-core work, [KP, KP] · [KP, W tiles] (KP = 2M padded to 16)
    in bf16 once for each product of the split (3 where the matrix is one
    bf16 part, 6 for three), at the bf16 peak.  Above M = 64 (the large-M
    kernel on ``rows``, default all 2M, and the tiles of the T/h valid
    frames): each block's rbp rows by KP, and each block's fold of its
    tile (every row group folds it again)."""
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    _, na = pipe.dft_parts("cpu", tap_dtype)
    R = 2 * pipe.M if rows is None else rows.shape[0]
    V = W if T is None else T // pipe.h
    plan = ck.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, na, R, V)
    KP = -(-2 * pipe.M // 16) * 16
    passes = 3 if na == 1 else 6
    frames = plan["tiles"] * plan["nt"]
    if plan["big"]:
        mma = 2.0 * plan["rgroups"] * plan["rbp"] * KP * frames * passes
        fold = 2.0 * 2 * pipe.K0 * frames * plan["rgroups"]
    else:
        mma = 2.0 * KP * KP * frames * passes
        fold = 2.0 * 2 * pipe.K0 * W
    return (f"K5 as written on {frames if plan['big'] else W} frames "
            f"(M = {pipe.M}, tpp = {pipe.tpp}"
            + (f", {plan['rgroups']} row groups of {plan['rbp']}"
               if plan["big"] else "") + "): "
            f"the fold {fold / 1e9:.3f} GFLOP float32, "
            f"{fold / FP32_FLOPS * 1e3:.4f} ms at the FP32 peak; the DFT "
            f"{mma / 1e9:.3f} GFLOP on the tensor cores ({na} matrix "
            f"part(s), {passes} bf16 products), {mma / BF16_FLOPS * 1e3:.4f} "
            f"ms at the bf16 peak; its bound {bound_ms:.4f} ms ({bound_by})")


#: the earlier large-M kernel (every row, every tile), device µs a call in
#: phase 27 (a), bf16 handoff (PERF.md §6: NVIDIA H100 80GB HBM3, 700 W),
#: by (M, critical form)
EARLIER_BIG_US = {(160, False): "36.4", (100, False): "36.6-36.7",
               (800, False): "210.7", (128, True): "87.0"}


def k5_yardsticks(call, k_us: float, card: str) -> None:
    """Two PyTorch calls the port never makes, timed beside the large-M
    kernel on its call: the selected rows of the float32 DFT matrix
    [R, 2M] times the folded frames [2M, T/h] (one ``torch.matmul``, the
    gathered form) and one ``torch.fft.fft`` of the folded frames (every
    bin); the folded frames are the kernel's probe.  With the earlier
    large-M kernel's time (``EARLIER_BIG_US``)."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    pipe, xr, xi, xwr, xwi, W, tdt, odt = call[:8]
    rows = call[8] if len(call) > 8 else None
    V = xr.shape[0] // pipe.h
    R = 2 * pipe.M if rows is None else rows.shape[0]
    _, fold = ck._launch_pfb(pipe, xr, xi, xwr, xwi, W, tdt, odt, rows,
                             probe=True)
    v = fold[:, :V].contiguous()
    _, cm, sm = pipe.operands(xr.device, tdt)
    A = ck.dft_matrix(cm, sm)
    A = (A if rows is None else A[rows.long()]).contiguous()
    z = torch.complex(v[:pipe.M], v[pipe.M:]).t().contiguous()  # [V, M]
    mm_us = device_us(lambda: torch.matmul(A, v))
    fft_us = device_us(lambda: torch.fft.fft(z, dim=-1))
    print(f"K5 large-M yardsticks (M = {pipe.M}, {R} rows, {V} frames): "
          f"torch.matmul of the rows by the folded frames (float32) "
          f"{mm_us:.1f} us, torch.fft.fft of the folded frames (every "
          f"bin) {fft_us:.1f} us; the kernel {k_us:.1f} us, the earlier "
          f"design {EARLIER_BIG_US.get((pipe.M, pipe.critical), 'n/a')} us "
          f"(PERF.md) [{card}]")


def vs_parent(tag: str, us: float, bound_ms: float, card: str) -> None:
    """A redesigned kernel's device µs a call beside its bound and the
    earlier design's recorded time (PARENT_US)."""
    if tag in PARENT_US:
        was, where = PARENT_US[tag]
        print(f"{tag}: {us:.1f} us a call on the device, bound "
              f"{bound_ms * 1e3:.1f} us, the earlier design {was:.1f} us "
              f"({where}) [{card}]")


def check_outputs(tag: str, args, what: str, bound_db: float) -> None:
    """Kernel ``tag`` against its plain version on ``args``, every tensor
    each returns (the IF or audio, and each stage input or state): each
    bit-identical, or >= ``bound_db``.  Raises on disagreement."""
    import torch
    mod, name = kernel_fn(tag, "")
    got = getattr(mod, name + "_kernel")(*args)
    want = getattr(mod, name + "_ref")(*args)
    torch.cuda.synchronize()

    def flat(t):
        if isinstance(t, (tuple, list)):
            return [u for v in t for u in flat(v)]
        return [t] if isinstance(t, torch.Tensor) else []
    got, want = flat(got), flat(want)
    if [(t.shape, t.dtype) for t in got] != [(t.shape, t.dtype)
                                             for t in want]:
        fail(f"{tag} {what}: outputs' shapes or dtypes differ")
    err, worst, n_exact = 0.0, float("inf"), 0
    for g, w in zip(got, want):
        if g.is_complex():
            g, w = torch.view_as_real(g), torch.view_as_real(w)
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            fail(f"{tag} {what}: non-finite kernel output")
        if torch.equal(g, w):
            n_exact += 1
            continue
        err = max(err, float((g - w).abs().max()))
        worst = min(worst, snr_db(w, g) if w.any() else -float("inf"))
    agree = (f"worst {worst:.1f} dB SNR (bound {bound_db:.0f})"
             if n_exact < len(got) else "all bit-identical")
    print(f"{tag} {name} ({what}): {len(got)} outputs, {n_exact} "
          f"bit-identical, max|err| {err:.3e}, {agree}")
    if worst < bound_db:
        fail(f"{tag} {what}: kernel disagrees with its plain version: "
             f"{agree}")


def tails_exact(tag: str, args, what: str) -> None:
    """K1's, K2's, K6's or K7's new carried state on ``args``, each tensor
    exactly the plain version's rule (concat the carried tail, rounded to
    the tail dtype, with the stage's input, keep the last samples, round)
    applied to the kernels' own stage inputs: K1's stage 0 and each
    chained stage's output, K2's discriminator output (the first launch's
    probe) and halfband outputs, K6's rotated bins z (its d2 launch's
    staging probe) and 2:1 FIR output y1, K7's discriminator output d
    (its FIR tile's staging probe) and audio FIR output u, and K7's quad
    sample, the gated IF's last.  Fails on any difference."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops import chan_frontend as cf
    from sdrplusplusbrown_tpu_torch.ops import demod_kernel as dk
    from sdrplusplusbrown_tpu_torch.ops import mono_frontend as mf
    from sdrplusplusbrown_tpu_torch.ops import wfm_kernel as wk
    from sdrplusplusbrown_tpu_torch.ops.precision import round_to

    def planes(t):
        return torch.cat([t.real, t.imag]).float() if t.is_complex() else t

    def rule(t_in, y, n, dt):
        return round_to(torch.cat([round_to(planes(t_in), dt), planes(y)],
                                  dim=1)[:, -n:], dt)
    if tag == "K7":
        pipe, iq, m_if, gate, qprev, ftail, ptail, odt, t_dt = args
        _, q, nf, np_, (d, u) = dk._fm_audio_launches(*args, probe=True)
        got = [q, nf, np_]
        want = [round_to(iq[:, m_if - 1].float()
                         * torch.cat([gate, gate]), t_dt),
                rule(ftail, d[:, :m_if], pipe.histF, t_dt),
                rule(ptail, u[:, :m_if], pipe.histP, t_dt)]
        wrapper = dk.fm_audio_kernel(*args)[1:]
    elif tag == "K6":
        pipe, Tb, tails, t_dt = args[0], args[8], args[7], args[10]
        _, _, got, (z, y1) = cf._chan_post_launches(*args, probe=True)
        want = [rule(tails[0], z[:, :Tb], pipe.hists[0], t_dt),
                rule(tails[1], y1[:, :Tb // 2], pipe.hists[1], t_dt)]
        wrapper = cf.chan_post_kernel(*args)[2]
    elif tag == "K1":
        pipe, xr, xi, tail, omega, base, tails, odt, tap_dt, t_dt = args
        h0, kernels = pipe.taps(xr.device, tap_dt)
        y0 = mf.mono_mix_kernel(pipe, xr, xi, tail, omega, base, h0)
        _, got, mids = mf.mono_stages_kernel(pipe, y0, tails, kernels, odt,
                                             t_dt)
        want = [rule(t, y, st["carry"], t_dt) for st, t, y in
                zip(pipe.stages, tails, [y0] + mids)]
        wrapper = mf.mono_frontend_kernel(*args)[1]
    else:
        pipe, iq, m_if, quad, hb_tails, hist, odt = args
        lr, q, hbt, h, ins = wk._wfm_demod_launches(*args, probe=True)
        got = [q[:, 0], *hbt, h]
        want = [round_to(iq[:, m_if - 1].float(), odt)]
        want += [rule(t, y, t.shape[1], odt) for t, y in zip(hb_tails, ins)]
        want.append(rule(hist, ins[-1], pipe.K, odt))
        w = wk.wfm_demod_kernel(*args)
        wrapper = [w[1][:, 0], *w[2], w[3]]
    torch.cuda.synchronize()
    bad = [i for i, (g, w, v) in enumerate(zip(got, want, wrapper))
           if not (torch.equal(planes(g), w) and torch.equal(g, v))]
    print(f"{tag} ({what}): {len(got) - len(bad)} of {len(got)} new state "
          f"tensors exactly the plain version's rule on the kernels' own "
          f"stage inputs")
    if bad or len(got) != len(want):
        fail(f"{tag} {what}: new state {bad} differs from the plain rule")


@functools.lru_cache(maxsize=None)
def sm_clock_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0])


def k12_floor(call, what: str, card: str) -> None:
    """K12's device µs a launch on ``call`` beside its chain floor: T
    steps of CHAIN_CYCLES dependent cycles at the SM clock."""
    from sdrplusplusbrown_tpu_torch.ops import agc
    us, n = call_profile(lambda: agc.agc_rows_kernel(*call))
    T = call[1].shape[1]
    clock = sm_clock_mhz()
    floor = T * CHAIN_CYCLES / clock
    print(f"K12 ({what}): {us:.1f} us a call in {n} launches; chain floor "
          f"{floor:.1f} us ({T} x {CHAIN_CYCLES} cycles at {clock:.0f} "
          f"MHz); {us / floor:.2f}x the floor [{card}]")


#: the plan that fixes each multi-launch scanner kernel's CUDA launches,
#: and the kernels it launches (K6's wrapper also sums its squelch
#: partials with one torch reduction)
PLANNERS = {"K6": ("chan_post_plan", ("post_d2_kernel", "post_fir_kernel")),
            "K7": ("fm_plan", ("fir_kernel", "poly_kernel"))}


def call_launches(tag: str, call, what: str) -> int:
    """K6's or K7's CUDA launches a call on ``call``, as its wrapper
    counts them (one at each launch), which must be its plan's
    (``planned_launches``) and, where the profiler saw the call's kernels,
    the profiler's count of them (a window that missed a kernel is taken
    again, twice at most); and its device time by launch (profiler; "not
    measured" where the window saw none).  Returns the wrapper's count."""
    mod, name = kernel_fn(tag, "_kernel")
    fn = getattr(mod, name)
    n0 = fn.launches
    fn(*call)
    counted = fn.launches - n0
    planner, own = PLANNERS[tag]
    # a window in which the profiler dropped all the launches of one of
    # the call's kernels (it can: one saw 1 of 40) is taken again, twice
    # at most, before its count is held to the wrapper's
    for _ in range(3):
        split, counts = {}, {}
        us, _ = call_profile(lambda: fn(*call), by_kernel=split,
                             counts=counts)
        n = sum(v for k, v in counts.items() if k in own)
        if n in (0, counted):
            break
        print(f"{tag} ({what}): the profiler saw {n} of the {counted} "
              f"launches a call; window taken again")
    planned = planned_launches(tag, call)
    seen = (f"{us:.1f} us a call, {n} CUDA launches of its own (profiler: "
            + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + ")"
            if n else f"device time and launches not measured (the "
            f"profiler saw no {tag} kernel)")
    print(f"{tag} ({what}): {counted} CUDA launches a call counted by the "
          f"wrapper, {planner} plans {planned}; {seen}")
    if counted != planned or (n and n != counted):
        fail(f"{tag} {what}: {counted} CUDA launches a call counted, "
             f"{n or 'none'} seen by the profiler, {planner} plans "
             f"{planned}")
    return counted


def k6_yardstick(call, card: str) -> None:
    """One conv1d (TF32 off) of K6's 304-tap stage alone, on the same
    [fir tail | y1] rows (the kernel's own y1, its probe) as planes
    [2C, n]: a yardstick beside K6's bandwidth launch (no single library
    call computes K6)."""
    import torch
    import torch.nn.functional as F
    from sdrplusplusbrown_tpu_torch.ops import chan_frontend as cf
    pipe, tails, t_dt = call[0], call[7], call[10]
    y1 = cf._chan_post_launches(*call, probe=True)[3][1]
    ext = torch.cat([tails[1], torch.cat([y1.real, y1.imag])], dim=1)[:, None]
    taps = pipe.dev_taps(ext.device, t_dt)[1][None, None]
    ms = event_ms(lambda: F.conv1d(ext, taps))
    split = {}
    call_profile(lambda: cf.chan_post_kernel(*call), by_kernel=split)
    print(f"K6 yardstick: one conv1d of the {taps.shape[-1]}-tap stage "
          f"alone on {ext.shape[0]} x {ext.shape[-1]} rows, {ms:.4f} ms "
          f"(device {device_us(lambda: F.conv1d(ext, taps)):.1f} us), "
          f"beside K6's bandwidth launch "
          f"{split.get('post_fir_kernel', 0.0):.1f} us and its d2 launch "
          f"{split.get('post_d2_kernel', 0.0):.1f} us [{card}]")


def kernel_count(tag: str) -> int:
    mod, name = kernel_fn(tag, "_kernel")
    return getattr(mod, name).launches


def planned_launches(tag: str, args) -> int:
    """CUDA launches one call of kernel ``tag`` on ``args`` makes, each of
    which its wrapper counts: K1 stage 0 and one a chained stage, K2
    three, K4, K4f and K4r their FFT route's (``fft_kernel.plan``: one
    pass or a four-step pair), K6 ``chan_post_plan``'s two, K7
    ``fm_plan``'s two, any other one."""
    from sdrplusplusbrown_tpu_torch.ops import (chan_frontend, demod_kernel,
                                                fft_kernel, mono_frontend,
                                                wfm_kernel)
    if tag == "K1":
        return mono_frontend.frontend_launches(args[0])
    if tag == "K2":
        return wfm_kernel.WFM_DEMOD_LAUNCHES
    if tag in ("K4", "K4f"):
        x, keep, interval, N = (args[0], *args[2:5]) if tag == "K4" \
            else args[:4]
        n = len(fft_kernel.frame_starts(x.shape[0], keep, interval,
                                        **({} if tag == "K4" else
                                           {"align": 1})))
        return len(fft_kernel.plan(N, n)["launches"])
    if tag == "K4r":
        xr, _, N = args[:3]
        return len(fft_kernel.plan(N, xr.numel() // N)["launches"])
    if tag == "K6":
        pipe, Tb, om = args[0], args[8], args[3]
        return chan_frontend.chan_post_plan(pipe, Tb,
                                            om.shape[0])["launches"]
    if tag == "K7":
        pipe, iq, m_if = args[:3]
        return demod_kernel.fm_plan(pipe, m_if, iq.shape[0] // 2)["launches"]
    return 1


def hold_launches(label: str, counts: dict, cap: dict) -> None:
    """Each kernel's count in ``counts`` (its wrapper's, over a main-path
    run) must be the CUDA launches its calls in ``cap`` (that run's
    captured arguments) plan: ``planned_launches`` summed.  Fails
    otherwise."""
    want = {t: sum(planned_launches(t, a) for a in cap.get(t, []))
            for t in counts}
    print(f"{label}: CUDA launches counted by the wrappers "
          + ", ".join(f"{t}={v}" for t, v in counts.items())
          + " (each held to its calls' planned launches)")
    bad = {t: (counts[t], want[t]) for t in counts if counts[t] != want[t]}
    if bad:
        fail(f"{label}: launches counted / planned {bad}")


# ---- the served app (phases 19-21) -----------------------------------
SERVED_SECONDS = 0.5          # the capture, looped by the file source
SERVED_BLOCKS = 6
SERVED_DC = 0.1               # the DC offset added to the capture's IQ
SERVED_RT_SECONDS = 10.0      # phase 21's run of the threaded pump
SERVED_TAGS = ("K4f", "K8", "K9", "K15")     # K15: the DC blocker


def served_capture(path: str) -> None:
    """A 2.4 MS/s WAV capture (float32 IQ): the stereo FM stations of
    APP_WFM, the NFM carriers of APP_NFM (1 kHz tone) and a DC offset."""
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    n = int(FS * SERVED_SECONDS)
    x = (stereo_wideband(n, APP_WFM)
         + nfm_wideband(n, APP_NFM, range(len(APP_NFM))) + SERVED_DC)
    write_wav(path, x.astype(np.complex64), FS, bits=32)


def served_config(capture: str, pump: str, dc_blocking: bool = True,
                  squelched: bool = True) -> dict:
    """The served app's config.json: the capture through a file source,
    fftSize 65 536 at 20 fps, a WFM radio and an NFM radio on their
    first carriers and, with ``squelched``, a second NFM radio off the
    signal (its squelch set to SQUELCH_DB over the control plane)."""
    mods = {"W": {"type": "radio", "demod": "WFM", "offset": APP_WFM[0]},
            "N": {"type": "radio", "demod": "NFM", "offset": APP_NFM[0]}}
    if squelched:
        mods["Q"] = {"type": "radio", "demod": "NFM",
                     "offset": APP_NFM_OFF[0]}
    return {"source": {"type": "file", "path": capture, "loop": True},
            "fftSize": FFT, "fftRate": 20, "pump": pump,
            "dcBlocking": dc_blocking, "modules": mods}


def new_app(root: str, config: dict, dev, run_pump: bool = False):
    from sdrplusplusbrown_tpu_torch.app import SDRApp
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    return SDRApp(root, run_pump=run_pump, device=dev)


def http_call(base: str, path: str, body: dict | None = None,
              timeout: float = 120.0) -> dict:
    """GET (or POST ``body`` as JSON) on the app's control plane."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def drive_served(dev, card: str, report: dict) -> None:
    """Phases 19-21 on ``dev``; raises on the first failure.  Adds the
    served app's launches to the K4f, K8 and K9 entries."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_served_") as tmp:
        cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024"
                                ".wav")
        served_capture(cap)
        served_in_process(dev, card, report, tmp, cap)
        served_over_http(card, tmp, cap)
        served_in_real_time(dev, card, tmp, cap)


def served_in_process(dev, card: str, report: dict, tmp: str,
                      cap: str) -> None:
    """Phase 19: SDRApp in manual pump mode on the card, six blocks with
    a retune and a set_demod round trip between blocks 3 and 4."""
    import torch
    from sdrplusplusbrown_tpu_torch.io.wav import read_wav_iq
    app = new_app(os.path.join(tmp, "p19"), served_config(cap, "manual"),
                  dev)
    app.start()
    app.modules["Q"].handle_debug_command("set_squelch", f"{SQUELCH_DB}")
    if not app.select_sink("W", "recorder"):
        fail("phase 19: cannot attach the recorder")
    got = {n: [] for n in app.modules}
    for n, m in app.modules.items():
        m.audio_event.bind(lambda blk, n=n: got[n].append(blk))
    blocks = {n: [] for n in app.modules}
    snrs = []

    def run():
        for b in range(SERVED_BLOCKS):
            if b == 3:
                app.set_vfo_offset("W", APP_WFM[1])
                for d in ("USB", "NFM"):
                    r = app.modules["N"].handle_debug_command("set_demod", d)
                    if r.get("demod") != d:
                        fail(f"phase 19: set_demod {d}: {r}")
            if app.pump_step(1) != 1:
                fail("phase 19: the pump stopped")
            for n in app.modules:
                blocks[n].append(np.concatenate(got[n], axis=-1))
                got[n].clear()
            snrs.append({n: app.modules[n].handle_debug_command(
                "get_snr", "")["snr"] for n in app.modules})
        torch.cuda.synchronize()

    reset_counts()
    with no_plain_on_card():
        _, cap19 = capture(tuple(KERNELS), run)
    counts = {t: kernel_count(t) for t in KERNELS}
    hold_launches(f"phase 19, served app, {SERVED_BLOCKS} blocks",
                  {t: counts[t] for t in SERVED_TAGS}, cap19)
    others = {t: n for t, n in counts.items() if n and t not in SERVED_TAGS}
    if min(counts[t] for t in SERVED_TAGS) < 1 or others:
        fail(f"phase 19: launch pattern {counts}")
    for t in SERVED_TAGS:
        report.setdefault(t, {}).setdefault("launches_by_path", {})[
            "served app"] = counts[t]
    # each kernel against its plain version at the shapes the served path
    # gave it: every distinct K8 geometry on its last call with data (the
    # squelched radio's rows are all zero), K9 and K4f on their last calls
    stages = {}
    for call in cap19["K8"]:
        if app_stage(call) not in stages or bool(call[0].any()):
            stages[app_stage(call)] = call
    served = [("K8", call, key) for key, call in sorted(stages.items())]
    served += [("K9", cap19["K9"][-1], "pilot band-pass"),
               ("K4f", cap19["K4f"][-1], f"{FFT} points")]
    for tag, call, what in served:
        err = check_app_kernel(tag, call, card, f"served app, {what}",
                               timed=False)["max_abs_err"]
        report[tag]["max_abs_err"] = max(report[tag]["max_abs_err"], err)
    print(f"phase 19: {len(stages)} distinct K8 geometries, K9 and K4f "
          f"held against their plain versions at the served app's shapes")
    block_len = app.pump_block_len
    line_on = app.last_spectrum.copy()
    app.shutdown()
    print(f"phase 19: served app on {dev} ({block_len}-sample blocks, fft "
          f"{FFT}, DC blocker on): {SERVED_BLOCKS} blocks, launches "
          + ", ".join(f"{t}={counts[t]}" for t in SERVED_TAGS)
          + ", every other kernel 0")
    # the oracles: WFM before (block 3) and after the retune (block 6), NFM
    # before and after its set_demod round trip, the squelched radio silent
    for b in (2, 5):
        aud = blocks["W"][b].astype(np.float64)
        snr, sep = stereo_oracle(aud[None])
        nfm = tone_snr_db(blocks["N"][b][0].astype(np.float64))
        print(f"phase 19 block {b + 1}: WFM tone SNR {snr:.1f} dB (bound "
              f"35), L/R separation {sep:.1f} dB (bound 25); NFM tone SNR "
              f"{nfm:.1f} dB (bound 40); get_snr "
              + ", ".join(f"{n} {v:.1f}" for n, v in snrs[b].items())
              + " dB")
        if snr <= 35.0 or sep <= 25.0 or nfm <= 40.0:
            fail(f"phase 19 block {b + 1}: audio oracle failed")
    for b in range(SERVED_BLOCKS):
        if blocks["Q"][b].any() or blocks["Q"][b].shape != (2, block_len
                                                              // 50):
            fail(f"phase 19 block {b + 1}: the squelched radio is not "
                 f"exactly silent")
        if not all(np.isfinite(v) for v in snrs[b].values()):
            fail(f"phase 19 block {b + 1}: get_snr {snrs[b]}")
    if min(snrs[-1]["W"], snrs[-1]["N"]) <= 20.0:
        fail(f"phase 19: get_snr on the carriers {snrs[-1]}")
    floor = np.percentile(line_on, 2)
    w = int(75e3 / FS * FFT)
    for o in (APP_WFM[1], APP_NFM[0]):
        k = int((o / FS + 0.5) * FFT)
        if line_on[k - w:k + w].max() < floor + 30.0:
            fail(f"phase 19: no spectrum peak at {o:.0f} Hz")
    # the recording is what the audio events carried, as 16-bit PCM
    rec, = [os.path.join(dp, f) for dp, _, fs in os.walk(
        os.path.join(tmp, "p19", "recordings")) for f in fs]
    iq, rate = read_wav_iq(rec)
    want = np.concatenate(blocks["W"], axis=-1)
    want = np.clip(want * 32768.0, -32768, 32767).astype(np.int16) / 32768.0
    if rate != 48_000 or not (np.array_equal(iq.real, want[0].astype(
            np.float32)) and np.array_equal(iq.imag, want[1].astype(
            np.float32))):
        fail("phase 19: the recording differs from the audio events")
    # the DC blocker: the baseband's DC bin against the same run without it
    off = new_app(os.path.join(tmp, "p19off"), served_config(
        cap, "manual", dc_blocking=False), dev)
    off.start()
    off.pump_step(SERVED_BLOCKS)
    line_off = off.last_spectrum.copy()
    off.shutdown()
    dc_on, dc_off = line_on[FFT // 2], line_off[FFT // 2]
    print(f"phase 19: baseband DC bin {dc_on:.1f} dB with the DC blocker, "
          f"{dc_off:.1f} dB without (bound: 30 dB lower); the recording "
          f"({want.shape[1]} frames) equals the audio events")
    if dc_off - dc_on < 30.0:
        fail("phase 19: the DC blocker left the DC bin")


def served_over_http(card: str, tmp: str, cap: str) -> None:
    """Phase 20: ``python -m sdrplusplusbrown_tpu_torch`` in a subprocess
    (the default device, cuda), manual pump, driven over HTTP."""
    import socket
    root = os.path.join(tmp, "p20")
    os.makedirs(root)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(served_config(cap, "manual", squelched=False), f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    log_path = os.path.join(tmp, "p20.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sdrplusplusbrown_tpu_torch", "--root",
             root, "--http", str(port), "--autostart"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 180
        while True:
            if proc.poll() is not None or time.time() > deadline:
                fail("phase 20: the app did not come up")
            try:
                if http_call(base, "/status", timeout=1)["mainLoopStarted"]:
                    break
            except OSError:
                time.sleep(0.2)
        up = time.perf_counter() - t0
        r = http_call(base, "/pump/step", {"blocks": 3})
        st = http_call(base, "/sdr/status")
        if r["stepped"] != 3 or st["blocks"] != 3 or not st["running"]:
            fail(f"phase 20: pump {r}, status {st}")

        def cmd(name, c, args=""):
            return http_call(base, f"/module/{name}/command",
                             {"cmd": c, "args": args})
        out = [cmd("N", "set_demod", "USB"), cmd("N", "get_demod"),
               cmd("N", "set_demod", "NFM"),
               cmd("N", "set_vfo_bandwidth", "10000"),
               cmd("W", "get_demod")]
        want = [{"status": "ok", "demod": "USB", "id": 4},
                {"demod": "USB", "id": 4},
                {"status": "ok", "demod": "NFM", "id": 0},
                {"status": "ok", "bandwidth": 10000.0},
                {"demod": "WFM", "id": 1}]
        if out != want:
            fail(f"phase 20: module commands {out}")
        r = http_call(base, "/sink/select", {"stream": "W",
                                             "sink": "recorder"})
        step = http_call(base, "/pump/step", {"blocks": 2})
        snr = {n: cmd(n, "get_snr")["snr"] for n in ("W", "N")}
        spec = cmd("W", "get_spectrum", ",128")
        st = http_call(base, "/sdr/status")
        if (r.get("status") != "ok" or step["stepped"] != 2
                or st["blocks"] != 5 or min(snr.values()) <= 20.0
                or len(spec["spectrum"]) != 128
                or not all(np.isfinite(spec["spectrum"]))):
            fail(f"phase 20: sink {r}, step {step}, status {st}, "
                 f"snr {snr}")
        http_call(base, "/exit")
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    with open(log_path) as f:
        log = f.read()
    recs = os.listdir(os.path.join(root, "recordings"))
    print(f"phase 20: python -m sdrplusplusbrown_tpu_torch served HTTP "
          f"{up:.1f} s after the start; 5 blocks over /pump/step, "
          f"get_snr W {snr['W']:.1f} dB N {snr['N']:.1f} dB, recording "
          f"{recs}, exit code {rc} [{card}]")
    dev_line = [ln for ln in log.splitlines() if "SDRApp started" in ln]
    print("phase 20 log: " + (dev_line[0] if dev_line else "(no start line)"))
    if rc != 0 or not dev_line or "device cuda:" not in dev_line[0] \
            or len(recs) != 1:
        fail(f"phase 20: exit code {rc}; log tail:\n{log[-3000:]}")


def window_stats(prof, nb: int) -> tuple:
    """A profiler window of ``nb`` blocks → ({kernel: device us a block},
    kernel launches, host-to-device copies, device-to-host copies)."""
    by_kernel, launches, h2d, d2h = {}, 0, 0, 0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us <= 0 or evt.key.startswith(("aten::", "cuda")):
            continue
        by_kernel[short_kernel(evt.key)] = by_kernel.get(
            short_kernel(evt.key), 0.0) + us / nb
        if "Memcpy HtoD" in evt.key:
            h2d += evt.count
        elif "Memcpy DtoH" in evt.key:
            d2h += evt.count
        elif not evt.key.startswith(("Memcpy", "Memset")):
            launches += evt.count
    return by_kernel, launches, h2d, d2h


def device_copies(prof, tmp: str) -> tuple:
    """A profiler window's trace: (each device-to-device copy as (bytes,
    µs), bytes None where the trace gives none; the kernels it holds)."""
    path = os.path.join(tmp, "window_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    os.remove(path)
    copies = [(e.get("args", {}).get("bytes"), float(e.get("dur", 0.0)))
              for e in events if str(e.get("name", "")).startswith("Memcpy")
              and ("DtoD" in e["name"] or "Device -> Device" in e["name"])]
    return copies, sum(e.get("cat") == "kernel" for e in events)


def window_copies(fn, calls: int) -> tuple:
    """``device_copies`` of a profiler window of ``calls`` calls of ``fn``
    after a warm-up step of as many inside the profiler (it loses a
    window's first events); a window that saw no kernel is taken again,
    twice at most."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    got = {}

    def ready(prof):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_copies_") as tmp:
            got["copies"] = device_copies(prof, tmp)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        if got.get("copies", ([], 0))[1]:
            break
    return got.get("copies", ([], 0))


# a 76.8 MB ring's copy reads and writes 153.6 MB: 46 µs at 3.35 TB/s;
# a copy without its bytes in the trace counts as one from this long
RING_COPY_US = 20.0


def ring_copies(copies: list, ring_bytes: int) -> list:
    """The copies of ``device_copies`` that move a whole ring."""
    return [(b, us) for b, us in copies
            if (b is not None and b >= ring_bytes)
            or (b is None and us >= RING_COPY_US)]


def served_in_real_time(dev, card: str, tmp: str, cap: str) -> None:
    """Phase 21: the app with its pump thread on the looping capture for
    SERVED_RT_SECONDS of wall time (``pump_in_real_time``), then the DC
    blocker alone.  On CUDA rtFactor is the front end's host enqueue time
    over the block (IQFrontEnd.apply only queues its launches; the radios
    are outside the clock, as in the JAX app), so the real-time check is
    each block's synced wall time: p99 within the block's duration.
    rtFactor < 1 is held as well."""
    import torch
    run = pump_in_real_time(
        dev, card, os.path.join(tmp, "p21"), served_config(cap, "thread"),
        "phase 21", SERVED_RT_SECONDS,
        prepare=lambda a: a.modules["Q"].handle_debug_command(
            "set_squelch", f"{SQUELCH_DB}"))
    # the DC blocker alone on one block's baseband
    fe, block_len = run["app"].frontend, run["block_len"]
    bb = torch.complex(*noise_planes(block_len, dev))
    st0 = fe.dc.init_state().to(dev)
    us, n = call_profile(lambda: fe.dc.apply(None, st0, bb))
    print(f"phase 21: the DC blocker (K15's dc form) on {block_len} "
          f"samples: {us:.1f} us device and {n} launches a block [{card}]")
    if n != 1:
        fail(f"phase 21: the DC blocker took {n} launches, not 1")
    real_time_bar("phase 21", run, run["dur_ms"])


def real_time_bar(label: str, run: dict, bar_ms: float) -> None:
    """Fails unless /status's rtFactor < 1 and the p99 block wall time is
    under ``bar_ms``."""
    p99 = float(np.percentile(run["w"], 99))
    if run["status"]["rtFactor"] >= 1.0 or p99 >= bar_ms:
        fail(f"{label}: not real time: rtFactor "
             f"{run['status']['rtFactor']}, p99 block {p99:.2f} ms (bound "
             f"{bar_ms:.0f})")


class settled_heap:
    """Within: the heap as it stands out of the garbage collector's way
    (``gc.freeze``), as the entry point (``__main__.py``) leaves its
    startup heap: a full collection then walks only what the pump
    allocates, not the script's own objects (a pass over ~170 000 of
    them takes ~0.1 s of host time), which would land inside a timed
    block."""

    def __enter__(self):
        import gc
        gc.collect()
        gc.freeze()
        return self

    def __exit__(self, *exc):
        import gc
        gc.unfreeze()
        return False


def pump_in_real_time(dev, card: str, root: str, config: dict, label: str,
                      seconds: float, prepare=None) -> dict:
    """The app of ``config`` with its pump thread on the looping capture
    for ``seconds`` of wall time (``prepare(app)`` first): /status's
    real-time factor, each block's wall time through a sync (percentiles
    past the first three blocks), then a profiler window of 20 blocks
    (device µs, launches and host↔device copies a block, idle share).
    Returns the app (shut down), /status, the walls (ms), the block's
    length and duration (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sdrplusplusbrown_tpu_torch.server.http_server import HttpDebugServer
    app = new_app(root, config, dev, run_pump=True)
    if prepare is not None:
        prepare(app)
    walls = []

    def timed_loop():
        """The pump thread's loop, each block's end synced and timed."""
        t = time.perf_counter()
        for _ in app._pump_iter():
            torch.cuda.synchronize()
            now = time.perf_counter()
            walls.append(now - t)
            t = now
    app._pump_loop = timed_loop
    http = HttpDebugServer(app, port=0)
    http.start()
    base = f"http://127.0.0.1:{http.port}"
    with no_plain_on_card():
        try:
            with settled_heap():
                t0 = time.perf_counter()
                app.start()
                time.sleep(seconds)
                st = http_call(base, "/status")
                blocks, secs = app.blocks_processed, time.perf_counter() - t0
                walls_rt = list(walls)
            block_len = app.pump_block_len
            # then a profiler window of 20 blocks while the pump thread runs
            # (last: the profiler slows the launches of the blocks after it);
            # a window whose trace holds copies but no kernel is taken again
            for window in range(1, 4):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    b0, w0 = app.blocks_processed, time.perf_counter()
                    while app.blocks_processed < b0 + 20:
                        time.sleep(0.005)
                    nb, window_us = app.blocks_processed - b0, (
                        time.perf_counter() - w0) * 1e6
                by_kernel, launches, h2d, d2h = window_stats(prof, nb)
                if launches:
                    break
        finally:
            app.shutdown()
            http.stop()
    busy = sum(by_kernel.values())
    dur_ms = block_len / FS * 1e3
    w = np.array(walls_rt[3:]) * 1e3     # past the first blocks' warm-up
    pct = " / ".join(f"{np.percentile(w, q):.4f}" for q in (50, 10, 90, 99))
    print(f"{label}: threaded pump, {blocks} blocks of {block_len} "
          f"samples ({dur_ms:.0f} ms each) in {secs:.1f} s, "
          f"{blocks * block_len / secs / 1e6:.2f} MS/s; /status "
          f"rtFactor {st['rtFactor']}, secondsBehind {st['secondsBehind']} "
          f"[{card}]")
    print(f"{label}: block wall time through torch.cuda.synchronize() "
          f"median / p10 / p90 / p99 {pct} ms over {len(w)} blocks "
          f"[{card}]")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    if launches:
        print(f"{label}: profiler window {window} of {nb} blocks: device "
              f"{busy:.1f} us a block, idle share "
              f"{1.0 - busy * nb / window_us:.3f}, {launches / nb:.1f} "
              f"kernel launches, {h2d / nb:.1f} host-to-device and "
              f"{d2h / nb:.1f} device-to-host copies a block; us a block "
              f"by kernel: " + ", ".join(f"{k} {v:.1f}" for k, v in top)
              + f" [{card}]")
    else:
        print(f"{label}: device time, launches and copies a block not "
              f"measured (the profiler saw no kernel in {window} windows)")
    return {"app": app, "status": st, "w": w, "block_len": block_len,
            "dur_ms": dur_ms}


# ---- the noise path (phases 22-23) ------------------------------------
NR_FS = 96_000.0              # BASELINE config 3: HF voice at 96 kS/s
NR_OFFSET = 10_000.0          # USB voice at +10 kHz
NR_AF = 48_000.0
NR_OFF_SECONDS = 5.0          # recorded audio with the AF NR off
NR_ON_SECONDS = 4.0           # and with each mode on
NR_MODES = ("logmmse", "omlsa")
NR_BLOCKS = 6                 # phase 23's blocks held against the CPU
NR_MIN_DB = 80.0              # tests/test_torch_noise.py's bound
NR_RT_SECONDS = 10.0          # phase 23's run of the threaded pump


def ssb_voice(t: np.ndarray) -> np.ndarray:
    """Formant-swept tone bursts, 0.25 s on / 0.25 s off, after a 1.5 s
    noise-only lead-in (tests/test_e2e_ssb_nr.py's voice)."""
    sweep = 700.0 + 500.0 * np.sin(2 * np.pi * 0.7 * t)
    carrier = np.sin(2 * np.pi * np.cumsum(sweep) / NR_FS)
    second = 0.5 * np.sin(2 * np.pi * np.cumsum(2.2 * sweep) / NR_FS)
    gate = ((np.floor(t * 2.0) % 2) == 0) & (t > 1.5)
    return (carrier + second) * gate


def ssb_capture(path: str, seconds: float = 12.0,
                snr_db: float = 6.0) -> None:
    """BASELINE config 3's HF capture (tests/test_e2e_ssb_nr.py's
    make_ssb_capture): the voice as an analytic (USB) signal at +10 kHz,
    complex noise at ``snr_db`` under the voice, float32 WAV at 96 kS/s."""
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    rng = np.random.default_rng(21)
    T = int(NR_FS * seconds)
    t = np.arange(T) / NR_FS
    V = np.fft.fft(ssb_voice(t))
    V[T // 2 + 1:] = 0.0
    V[1:T // 2] *= 2.0
    x = 0.5 * np.fft.ifft(V) * np.exp(2j * np.pi * NR_OFFSET * t)
    sig_pow = np.mean(np.abs(x[int(2 * NR_FS):int(2.2 * NR_FS)]) ** 2)
    noise_pow = sig_pow / (10 ** (snr_db / 10.0))
    x = x + np.sqrt(noise_pow / 2) * (rng.standard_normal(T)
                                      + 1j * rng.standard_normal(T))
    write_wav(path, x.astype(np.complex64), NR_FS, bits=32)


def speech_noise_db(path: str) -> tuple:
    """(speech, noise floor) in dB of a recording: p90 and p10 of its
    50 ms speech-band (300-2 700 Hz) energies (tests/test_e2e_ssb_nr.py)."""
    from sdrplusplusbrown_tpu_torch.io.wav import read_wav_iq
    y, rate = read_wav_iq(path)
    if rate != NR_AF:
        fail(f"phase 22: recording at {rate} Hz")
    mono = np.real(y)
    win = 2400
    n = (len(mono) // win) * win
    F = np.fft.rfft(mono[:n].reshape(-1, win), axis=-1)
    freqs = np.fft.rfftfreq(win, 1.0 / NR_AF)
    band = (freqs >= 300) & (freqs <= 2700)
    e = np.mean(np.abs(F[:, band]) ** 2, axis=-1)
    if len(e) <= 20:
        fail(f"phase 22: recording of {len(e)} frames")
    return (10 * np.log10(max(np.percentile(e, 90), 1e-20)),
            10 * np.log10(max(np.percentile(e, 10), 1e-20)))


def drive_noise(dev, card: str, report: dict) -> None:
    """Phases 22-23 on ``dev``; raises on the first failure.  Adds each
    path's K4f, K8, K9, K12, K14 and K15 launches to their entries and
    fills K14's and K15's."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_noise_") as tmp:
        noise_config3(dev, card, report, tmp)
        ifnr_bars(dev, card)
        cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024"
                                ".wav")
        served_capture(cap)
        noise_full_width(dev, card, report, tmp, cap)
        noise_in_real_time(dev, card, tmp, cap)


def noise_config3(dev, card: str, report: dict, tmp: str) -> None:
    """Phase 22: BASELINE config 3 through the served app on the card: the
    HF capture, a USB radio at +10 kHz, a recorder; the AF NR off, then
    ``set_afnr logmmse``, then ``set_afnr omlsa``, each recording held to
    tests/test_e2e_ssb_nr.py's bars; every K8 geometry, K12 and K4f of
    each recording against its plain version at that path's shapes, the
    AF NR's moving average timed."""
    import torch
    from sdrplusplusbrown_tpu_torch.utils.flog import flog
    cap = os.path.join(tmp, "baseband_7100000Hz_09-00-00_02-02-2024.wav")
    ssb_capture(cap)
    config = {"source": {"type": "file", "path": cap, "loop": True},
              "pump": "manual", "fftSize": 4096, "fftRate": 20,
              "modules": {"Radio": {"type": "radio", "demod": "USB",
                                    "offset": NR_OFFSET}}}
    app = new_app(os.path.join(tmp, "p22"), config, dev)
    app.start()
    m = app.modules["Radio"]
    out = [0]
    m.audio_event.bind(lambda blk: out.__setitem__(0, out[0] + blk.shape[-1]))

    def record(seconds: float) -> tuple:
        """Record until the file holds ``seconds`` of audio: (path,
        blocks stepped)."""
        if not app.select_sink("Radio", "recorder"):
            fail("phase 22: cannot attach the recorder")
        path = app.sinks["Radio"].path
        out[0], n = 0, 0
        while out[0] < seconds * NR_AF:
            if app.pump_step(1) != 1:
                fail("phase 22: the pump stopped")
            n += 1
        torch.cuda.synchronize()
        app.select_sink("Radio", "null_audio_sink")
        return path, n

    sp_off, nf_off = speech_noise_db(record(NR_OFF_SECONDS)[0])
    print(f"phase 22: BASELINE config 3 (USB voice at +10 kHz, 6 dB SNR, "
          f"96 kS/s) on {dev}, {app.pump_block_len}-sample blocks: AF NR "
          f"off S/N {sp_off - nf_off:.2f} dB (speech {sp_off:.2f} dB)")
    if sp_off - nf_off <= 3.0:
        fail("phase 22: no speech over the noise with the NR off")
    for mode in NR_MODES:
        r = m.handle_debug_command("set_afnr", mode)
        if r != {"status": "ok", "afnr": mode}:
            fail(f"phase 22: set_afnr {mode}: {r}")
        reset_counts()
        with no_plain_on_card():
            (wav, n), calls = capture(tuple(KERNELS),
                                      lambda: record(NR_ON_SECONDS))
        counts = {t: kernel_count(t) for t in KERNELS}
        tags = ("K4f", "K8", "K12") + (("K14",) if mode == "logmmse"
                                       else ())
        hold_launches(f"phase 22, {mode}, {n} blocks",
                      {t: counts[t] for t in tags}, calls)
        others = {t: c for t, c in counts.items() if c and t not in tags}
        if min(counts[t] for t in tags) < 1 or others:
            fail(f"phase 22: launch pattern {counts}")
        sp, nf = speech_noise_db(wav)
        gain = (sp - nf) - (sp_off - nf_off)
        print(f"phase 22: set_afnr {mode}: S/N {sp - nf:.2f} dB, gain "
              f"{gain:.2f} dB (bound > 5), speech {sp:.2f} dB, "
              f"{sp - sp_off:+.2f} dB against NR off (bound > -6); "
              f"{n} blocks, launches " + ", ".join(
                  f"{t}={counts[t]}" for t in tags) + f" [{card}]")
        if gain <= 5.0 or sp <= sp_off - 6.0:
            fail(f"phase 22: {mode} misses BASELINE config 3's bars")
        label = f"BASELINE config 3 ({mode}, {n} blocks)"
        for t in tags:
            report.setdefault(t, {}).setdefault("launches_by_path", {})[
                label] = counts[t]
        # each kernel against its plain version at the shapes this path
        # gave it: every distinct K8 geometry (VFO, AF resampler, the AF
        # NR's moving average) on its last call with data, K12 on the USB
        # AGC's rows, K4f at fftSize 4096; the moving average is timed
        sma = [c for c in calls["K8"] if c[2].shape == (1, 5)]
        if mode == "logmmse" and not sma:
            fail("phase 22: the AF NR's moving average never ran K8")
        stages = {}
        for call in calls["K8"]:
            if app_stage(call) not in stages or bool(call[0].any()):
                stages[app_stage(call)] = call
        held = [("K8", call, key) for key, call in sorted(stages.items())
                if not sma or key != app_stage(sma[-1])]
        held += [("K12", calls["K12"][-1], "USB AGC"),
                 ("K4f", calls["K4f"][-1], "4096 points")]
        if mode == "logmmse":
            held.append(("K14", calls["K14"][-1], "the AF NR's frames"))
        for tag, call, what in held:
            err = check_app_kernel(tag, call, card, f"config 3, {what}",
                                   timed=False)["max_abs_err"]
            entry = report.setdefault(tag, {})
            entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0), err)
        print(f"phase 22: {mode}: {len(stages)} distinct K8 geometries, K12 "
              f"and K4f" + (" and K14" if mode == "logmmse" else "")
              + " held against their plain versions at config 3's shapes")
        if sma:
            report["K8"]["launches_by_path"][
                f"AF NR moving average ({n} blocks)"] = sum(
                    planned_launches("K8", c) for c in sma)
            err = check_app_kernel("K8", sma[-1], card,
                                   "AF NR moving average, complex rows 2")
            report["K8"]["max_abs_err"] = max(report["K8"]["max_abs_err"],
                                              err["max_abs_err"])
            print(f"phase 22: the AF NR's moving average ran K8 {len(sma)} "
                  f"times in {n} blocks, at {tuple(sma[-1][0].shape)}")
        # from a copy of the radio's state, each call on the state the
        # previous returned (K14 takes the rings it is given)
        nr, box = m.afnr, [state_copy(m.afnr_state)]
        x = torch.complex(*noise_planes(2 * 2400, dev)).reshape(2, 2400)
        x = x[..., :2400 // nr.in_multiple * nr.in_multiple]
        if mode == "omlsa":
            x = x.real.contiguous()

        def one_call():
            _, box[0] = nr.apply(None, box[0], x)
        us, launches = call_profile(one_call)
        print(f"phase 22: {mode} alone on [2, {x.shape[-1]}] audio "
              f"samples (one block's): {us:.1f} us device and {launches} "
              f"launches a call [{card}]")
    final = m.handle_debug_command("get_afnr", "")
    log = flog.dump()
    app.shutdown()
    if final != {"afnr": NR_MODES[-1]} or "afnr error" in log:
        fail(f"phase 22: get_afnr {final}, 'afnr error' in the log: "
             f"{'afnr error' in log}")


def ifnr_bars(dev, card: str) -> None:
    """Phase 22, the IF NR on the card on tests/test_logmmse.py's
    wideband signal (a 10 kHz carrier in complex noise at 96 kS/s, 3 s):
    the carrier's gain 12 ± 1.5 dB (the ×4 makeup), the SNR gain over
    10 dB."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops.logmmse import IFNRLogMMSE
    from sdrplusplusbrown_tpu_torch.runtime.block import to_device
    rng = np.random.default_rng(12345)
    fs = NR_FS
    nr = IFNRLogMMSE(fs)
    core = nr.core
    T = int(fs * 3)
    t = np.arange(T) / fs
    x = (0.5 * np.exp(2j * np.pi * 10000 * t)
         + 0.2 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
         ).astype(np.complex64)
    xd = torch.from_numpy(x).to(dev)
    st = nr.prime(to_device(nr.init_state(()), dev),
                  xd[:core.NOISE_FRAMES * core.Slen])
    B = core.len2 * 20
    outs = []
    for i in range(T // B):
        y, st = nr.apply(None, st, xd[i * B:(i + 1) * B])
        outs.append(y)
    y = torch.cat(outs).cpu().numpy()
    half = slice(T // 2, T)
    rot = np.exp(-2j * np.pi * 10000 * np.arange(T)[half] / fs)

    def cpow(sig):
        return 20 * np.log10(np.abs(np.mean(sig[half] * rot)))

    n_in = 10 * np.log10(np.median(np.abs(np.fft.fft(x[half])) ** 2))
    n_out = 10 * np.log10(np.median(np.abs(np.fft.fft(y[half])) ** 2))
    gain = cpow(y) - cpow(x)
    snr_gain = gain - (n_out - n_in)
    print(f"phase 22: IFNRLogMMSE on {dev} at 96 kS/s (Slen {core.Slen}): "
          f"carrier gain {gain:.2f} dB (bound 12 +- 1.5), SNR gain "
          f"{snr_gain:.2f} dB (bound > 10) [{card}]")
    if not (np.isfinite(y).all() and abs(gain - 12.0) < 1.5
            and snr_gain > 10.0):
        fail("phase 22: the IF NR misses tests/test_logmmse.py's bars")


def noise_session(app, blocks: int, kernels: bool) -> dict:
    """The noise path's session on one served app (manual pump): the IF NR
    from the config, the noise blanker on the WFM radio, the FM IF
    filter on the NFM radio, the real-time guard on a clock that does
    not move, ``blocks`` blocks.  Returns each block's baseband and
    audio, the launch counts and the captured calls (``kernels``)."""
    import torch
    app._clock = lambda: 0.0
    app.start()
    for name, cmd in (("W", "set_nb"), ("N", "set_fmif")):
        r = app.modules[name].handle_debug_command(cmd, "on")
        if r != {"status": "ok", cmd[4:]: True}:
            fail(f"phase 23: {cmd} on {name}: {r}")
    got = {n: [] for n in app.modules}
    for n, m in app.modules.items():
        m.audio_event.bind(lambda blk, n=n: got[n].append(blk))
    bbs = []
    app.baseband_event.bind(bbs.append)
    out = {"bb": [], "audio": [], "primed": []}

    def run():
        for _ in range(blocks):
            if app.pump_step(1) != 1:
                fail("phase 23: the pump stopped")
            out["bb"].append(bbs.pop())
            out["audio"].append({n: np.concatenate(a, axis=-1)
                                 for n, a in got.items()})
            for a in got.values():
                a.clear()
            out["primed"].append(app.ifnr_primed)
        if app.device.type == "cuda":
            torch.cuda.synchronize()

    if kernels:
        reset_counts()
        with no_plain_on_card():
            _, out["calls"] = capture(tuple(KERNELS), run)
        out["counts"] = {t: kernel_count(t) for t in KERNELS}
    else:
        run()
    out["status"] = app.status()
    out["block_len"] = app.pump_block_len
    app.shutdown()
    return out


def noise_full_width(dev, card: str, report: dict, tmp: str,
                     cap: str) -> None:
    """Phase 23: the served capture at 2.4 MS/s with ``ifnr: true``, the
    noise blanker on the WFM radio and the FM IF filter on the NFM radio,
    six blocks on the card against the same on the host CPU, float32
    handoff: baseband and audio to NR_MIN_DB, the tone SNRs beside it."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops import precision
    config = served_config(cap, "manual", squelched=False)
    config["ifnr"] = True
    prev = precision.get_handoff_name()
    precision.set_handoff_dtype("float32")
    try:
        runs = {d: noise_session(new_app(os.path.join(tmp, f"p23_{d}"),
                                         config, torch.device(d)),
                                 NR_BLOCKS, d == "cuda")
                for d in ("cuda", "cpu")}
    finally:
        precision.set_handoff_dtype(prev)
    card_run, host = runs["cuda"], runs["cpu"]
    if card_run["primed"] != host["primed"] or not card_run["primed"][-1]:
        fail(f"phase 23: IF NR primed {card_run['primed']} on the card, "
             f"{host['primed']} on the CPU")
    counts = card_run["counts"]
    tags = ("K4f", "K8", "K9", "K14", "K15")
    hold_launches(f"phase 23, {NR_BLOCKS} blocks", {t: counts[t]
                                                    for t in tags},
                  card_run["calls"])
    others = {t: c for t, c in counts.items() if c and t not in tags}
    if min(counts[t] for t in tags) < 1 or others:
        fail(f"phase 23: launch pattern {counts}")
    path = f"noise path ({NR_BLOCKS} blocks)"
    for t in tags:
        report.setdefault(t, {}).setdefault("launches_by_path", {})[
            path] = counts[t]
    host_path_kernels(card_run["calls"], counts, path, report, card)
    first_nr = card_run["primed"].index(True)

    def agree(want, got) -> float:
        if got.shape != want.shape:
            fail(f"phase 23: shape {got.shape}, the CPU's {want.shape}")
        if np.iscomplexobj(want):
            want = np.stack([want.real, want.imag])
            got = np.stack([got.real, got.imag])
        return snr_db(torch.from_numpy(want), torch.from_numpy(got))

    worst = {}
    for b in range(NR_BLOCKS):
        for what in ("baseband", "W", "N"):
            want, got = ((host["bb"][b], card_run["bb"][b])
                         if what == "baseband" else
                         (host["audio"][b][what], card_run["audio"][b][what]))
            worst[what] = min(worst.get(what, np.inf), agree(want, got))
    aud = card_run["audio"][-1]
    snr, sep = stereo_oracle(aud["W"].astype(np.float64)[None])
    nfm = tone_snr_db(aud["N"][0].astype(np.float64))
    print(f"phase 23: ifnr on, NB on W, FMIF on N, {NR_BLOCKS} blocks of "
          f"{card_run['block_len']} samples, the IF NR primed from block "
          f"{first_nr + 1}: card against the host CPU, worst block "
          + ", ".join(f"{k} {v:.1f} dB" for k, v in worst.items())
          + f" (bound {NR_MIN_DB:.0f}); block {NR_BLOCKS}: WFM tone SNR "
          f"{snr:.1f} dB, L/R separation {sep:.1f} dB, NFM tone SNR "
          f"{nfm:.1f} dB; launches " + ", ".join(f"{t}={counts[t]}"
                                                 for t in tags)
          + f" [{card}]")
    if min(worst.values()) < NR_MIN_DB:
        fail(f"phase 23: the card disagrees with the host CPU: {worst}")


def k15_what(call) -> str:
    """A K15 call's row: its form, rows and type."""
    form = call[3] if len(call) > 3 else "scan"
    what = {"dc": "the DC blocker", "nb": "the noise blanker",
            "scan": "the scan"}[form]
    return (f"{what}, {'complex' if call[1].is_complex() else 'real'} "
            f"{tuple(call[1].shape)}")


def k15_unfused(call, card: str) -> None:
    """A fused K15 call ("dc", "nb") against the unfused route on the card:
    K15's scan form, then the block's torch ops (``dc_route``,
    ``nb_route``).  Bit-identical, or the agreement and the output that
    differs (fails under 130 dB)."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops import recurrence as prec
    a, x, y0, form, gain = call[:5]
    extra = (gain,) if form == "dc" else (gain, call[5])
    route = prec.dc_route if form == "dc" else prec.nb_route
    got = prec.linear_recurrence_kernel(*call)
    want = route(prec.linear_recurrence_kernel, a, x, y0, *extra)
    torch.cuda.synchronize()
    differ = [name for name, g, w in zip(("out", "state"), got, want)
              if not torch.equal(g, w)]
    if not differ:
        print(f"K15 {k15_what(call)}: the fused form bit-identical to the "
              f"unfused route (K15's scan, then the block's torch ops) "
              f"[{card}]")
        return
    sn = min(snr_db(torch.view_as_real(w) if w.is_complex() else w,
                    torch.view_as_real(g) if g.is_complex() else g)
             for g, w in zip(got, want))
    print(f"K15 {k15_what(call)}: the fused form against the unfused route:"
          f" {' and '.join(differ)} differ, {sn:.1f} dB (bound 130) "
          f"[{card}]")
    if sn < 130.0:
        fail(f"K15 {k15_what(call)}: the fused form {sn:.1f} dB from the "
             f"unfused route")


def k14_with_and_without_hand_over(call, card: str) -> None:
    """K14's device µs a call at ``call``'s shapes with the hand-over (each
    call on the state the previous returned: the rings written in place)
    and without it (the rings copied first, as the earlier wrapper did); a
    window of the copies must show ring-sized device-to-device copies,
    which phase 23's window must not."""
    from sdrplusplusbrown_tpu_torch.ops import logmmse as plm
    core, st, sig, hold = call
    kern = plm.logmmse_frames_kernel
    with_us, n = call_profile(k14_chain(kern, (core, state_copy(st), sig,
                                               hold)))
    base = state_copy(st)

    def copied():
        return kern(core, {**base, **{k: base[k].clone()
                                       for k in plm.RINGS}}, sig, hold)
    without_us, n2 = call_profile(copied)
    # three calls in the window: six ring copies
    seen = ring_copies(window_copies(copied, 3)[0], 4 * st["hist"].numel())
    print(f"K14 at nFFT {core.nFFT} x {sig.shape[-2]} frames: {with_us:.1f} "
          f"us device a call with the hand-over ({n} launches), "
          f"{without_us:.1f} us with the rings copied first ({n2} launches; "
          f"a window of three such calls shows {len(seen)} of their 6 "
          f"ring-sized device-to-device copies) [{card}]")
    if len(seen) < 2:
        fail(f"K14: the ring copies' window shows {len(seen)} ring-sized "
             f"copies: the copy check cannot see them")


def host_path_kernels(calls: dict, counts: dict, path: str, report: dict,
                      card: str) -> None:
    """K14 and K15 against their plain versions at the noise path's shapes
    (phase 23's card run): K14 on the IF NR's last block, timed, with and
    without the hand-over; K15 on the last call of each of its forms there
    (the front end's DC blocker, complex rows, and the noise blanker, each
    one launch, timed), each fused form against the unfused route.  Fills their report entries, with this path's
    launches as the main path's."""
    forms = {}
    for call in calls["K15"]:
        forms[(call[3] if len(call) > 3 else "scan",
               call[1].is_complex())] = call
    checks = [("K14", calls["K14"][-1], "the IF NR's frames, nFFT "
               f"{calls['K14'][-1][0].nFFT}", 100.0)]
    for key in sorted(forms, key=lambda k: ("dc", "nb", "scan").index(k[0])):
        checks.append(("K15", forms[key], k15_what(forms[key]),
                       130.0 if key[0] == "nb" else 100.0))
    for tag, call, what, min_db in checks:
        got = check_app_kernel(tag, call, card, what, min_db=min_db)
        entry = report.setdefault(tag, {})
        err = max(entry.get("max_abs_err", 0.0), got.pop("max_abs_err"))
        if tag == "K15" and "ms" in entry:
            got = {}        # the report keeps the first form's timing
        entry.update(got, max_abs_err=err)
        if tag == "K15":
            if len(call) > 3 and call[3] != "scan":
                k15_unfused(call, card)
        else:
            k14_with_and_without_hand_over(call, card)
    for tag in ("K14", "K15"):
        report[tag].update(launches=counts[tag], launches_path=path)


class PausableClock:
    """A clock (the app's ``_clock``, which its real-time guard reads)
    that stands still between ``pause()`` and ``resume()``."""

    def __init__(self, clock):
        self.clock, self.lost, self.paused_at = clock, 0.0, None

    def pause(self) -> None:
        self.paused_at = self.clock()

    def resume(self) -> None:
        self.lost += self.clock() - self.paused_at
        self.paused_at = None

    def __call__(self) -> float:
        now = self.clock() if self.paused_at is None else self.paused_at
        return now - self.lost


def noise_in_real_time(dev, card: str, tmp: str, cap: str) -> None:
    """Phase 23: the app with ``ifnr: true`` (NB on W, FMIF on N) and its
    pump thread on the looping capture for NR_RT_SECONDS: blocks
    processed, rtFactor, each block's wall time through a sync, a
    profiler window of 20 blocks, and the IF NR alone on one block's
    baseband.  Fails if the guard shed the IF NR, read at the end of the
    NR_RT_SECONDS and again after the profiler window; the guard's clock
    stands still from the window's opening to the end of the trace's
    processing, since the profiler's tracing of every torch call, and its
    processing in this thread, which holds the interpreter lock, slow the
    front end that the guard clocks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    config = served_config(cap, "thread", squelched=False)
    config["ifnr"] = True
    app = new_app(os.path.join(tmp, "p23rt"), config, dev, run_pump=True)
    for name, cmd in (("W", "set_nb"), ("N", "set_fmif")):
        app.modules[name].handle_debug_command(cmd, "on")
    walls = []

    def timed_loop():
        t = time.perf_counter()
        for _ in app._pump_iter():
            torch.cuda.synchronize()
            now = time.perf_counter()
            walls.append((now - t, app.ifnr_primed))
            t = now
    app._pump_loop = timed_loop
    guard_clock = PausableClock(app._clock)
    app._clock = guard_clock
    with no_plain_on_card():
        try:
            with settled_heap():
                t0 = time.perf_counter()
                app.start()
                time.sleep(NR_RT_SECONDS)
            st = app.status()
            blocks, seconds = app.blocks_processed, time.perf_counter() - t0
            walls_rt = list(walls)
            block_len = app.pump_block_len
            for window in range(1, 4):
                guard_clock.pause()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    b0, w0 = app.blocks_processed, time.perf_counter()
                    while app.blocks_processed < b0 + 20:
                        time.sleep(0.005)
                    nb, window_us = app.blocks_processed - b0, (
                        time.perf_counter() - w0) * 1e6
                by_kernel, launches, h2d, d2h = window_stats(prof, nb)
                copies, _ = device_copies(prof, tmp)
                guard_clock.resume()
                if launches:
                    break
            # three blocks after the window, on the running clock
            b0, until = app.blocks_processed, time.perf_counter() + 5.0
            while (app.blocks_processed < b0 + 3
                   and time.perf_counter() < until):
                time.sleep(0.005)
            st_end = app.status()
        finally:
            app.shutdown()
    dur_ms = block_len / FS * 1e3
    w = np.array([x for x, primed in walls_rt if primed][3:]) * 1e3
    if not len(w):
        fail("phase 23: the IF NR never primed")
    pct = " / ".join(f"{np.percentile(w, q):.4f}" for q in (50, 10, 90, 99))
    print(f"phase 23: threaded pump with the IF NR, {blocks} blocks of "
          f"{block_len} samples in {seconds:.1f} s, "
          f"{blocks * block_len / seconds / 1e6:.2f} MS/s; rtFactor "
          f"{st['rtFactor']}, secondsBehind {st['secondsBehind']}, "
          f"ifnrEnabled {st['ifnrEnabled']} (after the profiler window, "
          f"the guard's clock paused in it: {st_end['ifnrEnabled']}) "
          f"[{card}]")
    print(f"phase 23: block wall time through torch.cuda.synchronize(), "
          f"IF NR on, median / p10 / p90 / p99 {pct} ms over {len(w)} "
          f"blocks [{card}]")
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    if launches:
        print(f"phase 23: profiler window {window} of {nb} blocks: device "
              f"{busy:.1f} us a block, idle share "
              f"{1.0 - busy * nb / window_us:.3f}, {launches / nb:.1f} "
              f"kernel launches, {h2d / nb:.1f} host-to-device and "
              f"{d2h / nb:.1f} device-to-host copies a block; us a block "
              f"by kernel: " + ", ".join(f"{k} {v:.1f}" for k, v in top)
              + f" [{card}]")
    else:
        print("phase 23: device time, launches and copies a block not "
              f"measured (the profiler saw no kernel in {window} windows)")
    # K14 writes the IF NR's rings in place: no whole-ring copy a block,
    # in the pump's window and in a warmed-up window of the IF NR alone
    nr = app.ifnr
    ring = 4 * nr.core.H * nr.core.nFFT

    def copy_check(copies, what: str) -> None:
        known = [b for b, _ in copies if b is not None]
        print(f"phase 23: {what}: {len(copies)} device-to-device copies, "
              f"the largest " + (f"{max(known)} bytes" if known else
                                 "of unknown size")
              + f"; a ring is {ring} bytes [{card}]")
        if ring_copies(copies, ring):
            fail(f"phase 23: {what} holds copies of a whole ring: "
                 f"{ring_copies(copies, ring)}")
    if launches:
        copy_check(copies, f"the pump's profiler window ({nb} blocks)")
    else:
        print("phase 23: the pump's profiler window's copies not measured "
              "(it saw no kernel)")
    # the IF NR alone on one block's baseband, from a primed state, each
    # call on the state the previous one returned
    from sdrplusplusbrown_tpu_torch.runtime.block import to_device
    bb = torch.complex(*noise_planes(block_len, dev))
    box = [nr.prime(to_device(nr.init_state(()), dev), bb.repeat(
        -(-nr.core.NOISE_FRAMES * nr.core.Slen // block_len)))]

    def one_block():
        _, box[0] = nr.apply(None, box[0], bb)
    copies, kernels = window_copies(one_block, 10)
    if not kernels:
        fail("phase 23: the IF NR's profiler window saw no kernel in 3 "
             "windows: its copies cannot be checked")
    copy_check(copies, f"the IF NR alone, 10 blocks ({kernels} kernels)")
    us, n = call_profile(one_block, reps=10)
    print(f"phase 23: the IF NR alone (Slen {nr.core.Slen}, nFFT "
          f"{nr.core.nFFT}, H {nr.core.H}, {block_len // nr.core.len2} "
          f"frames) on {block_len} samples: {us:.1f} us device and {n} "
          f"launches a block [{card}]")
    for when, s_ in (("in its real-time run", st),
                     ("by the end of the profiler window", st_end)):
        if not s_["ifnrEnabled"]:
            fail(f"phase 23: the guard shed the IF NR {when}: "
                 f"{s_['ifnrStopReason']}")
    if np.percentile(w, 99) >= dur_ms:
        fail(f"phase 23: not real time: p99 block "
             f"{np.percentile(w, 99):.2f} ms of {dur_ms:.0f}")


# ---- RDS and the Radio's forms (phases 24-25) -----------------------------
RDS_PI, RDS_PS, RDS_RT = 0xABCD, "TESTFM  ", "HELLO RADIO TEXT"
RDS_SECONDS = 3.6             # the phase 25 capture
RDS_DECODE_S = 3.0            # each radio decodes within this of its switch-on
RDS_SET_BLOCK = 2             # V's set_rds 1 comes before this block
RDS_RT_SECONDS = 10.0         # phase 25's run of the threaded pump
LOOP_BLOCKS = 4               # phase 24's blocks a radio
RDS_TAGS = ("K4f", "K8", "K9", "K12c", "K13c", "K13m", "K15")


def rds_bits(repeats: int) -> np.ndarray:
    """The PS groups (0A, addresses 0-3) then the RadioText groups (2A) of
    RDS_PI / RDS_PS / RDS_RT, PTY 5, as bits, ``repeats`` times."""
    from sdrplusplusbrown_tpu_torch.models.rds import (rds_encode_group,
                                                       rds_group_bits)
    groups = [rds_encode_group(RDS_PI, 0, False, 5, a, 0,
                               (ord(RDS_PS[2 * a]) << 8)
                               | ord(RDS_PS[2 * a + 1])) for a in range(4)]
    for a in range(4):
        c = RDS_RT[4 * a:4 * a + 4].ljust(4)
        groups.append(rds_encode_group(RDS_PI, 2, False, 5, a,
                                       (ord(c[0]) << 8) | ord(c[1]),
                                       (ord(c[2]) << 8) | ord(c[3])))
    return np.tile(np.concatenate([rds_group_bits(g) for g in groups]),
                   repeats)


def rds_wideband(n: int, offset: float) -> np.ndarray:
    """A stereo FM station at ``offset`` (1 kHz tone in L, the 19 kHz
    pilot) carrying RDS: the differentially encoded biphase at 1 187.5
    bit/s on cos 57 kHz (0.08 of the deviation), plus a little noise."""
    t = np.arange(n) / FS
    bits = rds_bits(int(n / FS * 1187.5) // 832 + 1)
    d = 1.0 - 2.0 * (np.cumsum(bits) % 2)
    pos = t * 1187.5
    bp = d[pos.astype(int)] * np.where(pos - np.floor(pos) < 0.5, 1.0, -1.0)
    tone = np.sin(2 * np.pi * TONE_HZ * t)
    mpx = (0.4 * tone + 0.1 * np.sin(2 * np.pi * 19_000 * t)
           + 0.4 * tone * (-np.cos(2 * np.pi * 38_000 * t))
           + 0.08 * bp * np.cos(2 * np.pi * 57_000 * t))
    x = 0.5 * np.exp(2j * np.pi * (offset * t + np.cumsum(75_000 * mpx)
                                   / FS))
    rng = np.random.default_rng(13)
    x = x + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def flat(tree) -> list:
    """The tensors of a kernel's result (tuples, lists and dicts)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in flat(v)]
    return [tree]


def loop_input(tag: str, call):
    """The input rows of a sequential kernel's call (K16 takes its soft
    bits first, the loops their block second)."""
    return call[0] if tag == "K16" else call[1]


def loop_steps(tag: str, call) -> int:
    """The steps of a row's chain: trellis steps (K16), symbols (K13m,
    K13f), else samples."""
    x = loop_input(tag, call)
    if tag == "K16":
        return x.shape[1] // 2
    if tag in ("K13m", "K13f"):
        return call[0].max_out(x.shape[1])
    return x.shape[1]


def chain_clock_runs(kern, call, steps: int, x,
                     parts: list | None = None) -> tuple:
    """LOOP_RUNS runs of ``kern`` on ``call`` (input rows ``x``) with its
    chain clock: (cycles a step, the SM clock in MHz during the chain)
    each run, from the slowest row.  A kernel with several clocks
    (``clock_slots``: K16's trellis, then its argmin and traceback) counts
    their sum; ``parts``, where given, gets each run's cycles a step of
    each clock, of that row."""
    import torch
    R = x.shape[0]
    slots = getattr(kern, "clock_slots", 1)
    cpi, mhz = [], []
    for _ in range(LOOP_RUNS):
        clk = torch.zeros(R, 2 * slots, dtype=torch.int64, device=x.device)
        kern(*call, clk)
        torch.cuda.synchronize()
        each = clk.cpu().numpy().reshape(R, slots, 2)
        cycles, ns = each.sum(axis=1).T
        r = int(np.argmax(cycles))
        cpi.append(cycles[r] / steps)
        mhz.append(cycles[r] / ns[r] * 1e3)
        if parts is not None:
            parts.append(each[r, :, 0] / steps)
    return np.array(cpi), np.array(mhz)


def host_copy(tree):
    """A kernel call's arguments with every tensor (in tuples, lists and
    dicts) copied to the host CPU."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def check_loop_kernel(tag: str, call, card: str, what: str,
                      timed: bool, plain_calls: int = 2,
                      host: bool = False) -> dict:
    """K13, K16 or K12c against its plain version on ``call``: every returned
    tensor bit-identical (K12c: the output within 100 dB, the state
    exact); with ``timed`` both timed with CUDA events (the kernel over
    LOOP_RUNS runs of 20 calls: median and range; the plain loop, a torch
    launch per operation a sample, over 2 calls), the kernel's device µs
    a launch over the launches the profiler saw, and its chain clocked
    on the kernel (``chain_clock_runs``)
    beside the chain floor: the steps at the fewest cycles a step of any
    run, at the fastest SM clock (see LOOP_RUNS).  ``plain_calls`` 0: the
    plain loop's time is that of the comparison's call (a long loop of
    torch launches).  ``host`` (untimed, K13m and K13f only): the plain
    version runs on a host CPU copy of the call, where a step's dozens of
    torch operations cost a third of what they cost as launches on the
    card; its operations (adds, multiplies, compares, floors, gathers,
    each rounded) give the same bits on either device.  Raises on
    disagreement."""
    import torch
    mod, name = kernel_fn(tag, "")
    kern = getattr(mod, name + "_kernel")
    ref = getattr(*kernel_fn(tag, "_ref"))
    if host and (timed or tag not in ("K13m", "K13f")):
        raise ValueError(f"{tag}: the host's plain version is untimed and "
                         "K13m's or K13f's")
    got = flat(kern(*call))
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    want = flat(ref(*(host_copy(call) if host else call)))
    e1.record()
    torch.cuda.synchronize()
    if host:
        got = [g.cpu() for g in got]
    err, same = 0.0, True
    for g, w in zip(got, want):
        d = g.to(w.dtype) if g.dtype != w.dtype else g
        if w.is_complex():
            d, w = torch.view_as_real(d), torch.view_as_real(w)
        err = max(err, float((d.double() - w.double()).abs().max()))
        same = same and torch.equal(d, w)
    if tag == "K12c":
        sn = snr_db(torch.view_as_real(want[0]), torch.view_as_real(got[0]))
        ok = sn >= 100.0 and all(torch.equal(g, w) for g, w in
                                 zip(got[1:], want[1:]))
        agree = ("bit-identical" if same else
                 f"{sn:.1f} dB SNR (bound 100), state exact")
    else:
        ok, agree = same, ("bit-identical" if same else "NOT bit-identical")
    out = {"name": name, "route": "cuda", "source": KERNELS[tag][2],
           "replaces": KERNELS[tag][3], "max_abs_err": err}
    x = loop_input(tag, call)
    steps = loop_steps(tag, call)
    shape = "x".join(str(d) for d in x.shape)
    if timed:
        runs = np.array([event_ms(lambda: kern(*call))
                         for _ in range(LOOP_RUNS)])
        out["ms"] = float(np.median(runs))
        out["plain_ms"] = event_ms(lambda: ref(*call), plain_calls) \
            if plain_calls else e0.elapsed_time(e1)
        out["bound_ms"], out["bound_by"] = bound(tag, call)
        out["library_ms"] = None
        # µs a launch over the launches the window saw: a launch the
        # profiler drops now and then would lower a per-call mean
        ev, win = {}, {}
        call_profile(lambda: kern(*call), events=ev, window=win)
        launches = [tn for k, tn in ev.items()
                    if not k.startswith(("Memcpy", "Memset"))]
        seen = sum(n for _, n in launches)
        us = (sum(t for t, _ in launches) / seen if seen
              else float("nan"))     # nan: the profiler saw none
        parts = []
        cpi, mhz = chain_clock_runs(kern, call, steps, x, parts)
        top = max(sm_clock_mhz(), float(mhz.max()))
        floor = steps * cpi.min() / top
        out["cycles_a_step"] = float(np.median(cpi))
        # K16: the trellis's and the traceback's share apart
        split = "" if len(parts[0]) < 2 else " (trellis {:.2f}, argmin and " \
            "traceback {:.2f})".format(*np.median(np.array(parts), axis=0))
        print(f"{tag} {name} ({what}, {shape}): kernel {out['ms']:.4f} ms "
              f"(median of {LOOP_RUNS} runs, {runs.min():.4f}-"
              f"{runs.max():.4f}), plain {out['plain_ms']:.4f} ms, library "
              f"none, bound {out['bound_ms']:.6f} ms ({out['bound_by']}), "
              f"max|err| {err:.3e}, {agree}; device {us:.1f} us a launch "
              f"({seen} of {win['calls']} launches seen); chain "
              f"{np.median(cpi):.2f} "
              f"cycles a step{split} "
              f"({cpi.min():.2f}-{cpi.max():.2f}) at an SM clock of "
              f"{np.median(mhz):.0f} MHz ({mhz.min():.0f}-{mhz.max():.0f}) "
              f"over {LOOP_RUNS} runs; chain floor {floor:.1f} us ({steps} "
              f"steps x {cpi.min():.2f} cycles at {top:.0f} MHz), "
              f"{us / floor:.2f}x the floor [{card}]")
    else:
        print(f"{tag} {name} ({what}, {shape}): max|err| {err:.3e}, "
              f"{agree}" + (" (the plain version on the host CPU)"
                            if host else ""))
    if not ok:
        fail(f"{tag} {what}: kernel disagrees with its plain version: "
             f"{agree} (max|err| {err:.3e})")
    return out


def run_radio(radio, x_np, B: int, dev, blocks: int, offset: float):
    """``blocks`` blocks of B samples of ``x_np`` through Radio.apply on
    ``dev``: the list of each block's outputs as host arrays."""
    import torch
    p, st, outs = radio.make_params(offset), radio.init_state(()), []
    for b in range(blocks):
        y, st = radio.apply(p, st, torch.from_numpy(x_np[b * B:(b + 1) * B])
                            .to(dev))
        outs.append([t.cpu() for t in (y if isinstance(y, tuple) else (y,))])
    return outs


def drive_loops(dev, card: str, report: dict) -> None:
    """Phase 24: K13's three forms and K12's complex form against their
    plain versions at the path's shapes, timed; the scan-PLL radio's
    oracles; the Radio's other forms on the card against the host CPU."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import (
        Radio, DEMOD_AM, DEMOD_NFM, DEMOD_RAW, DEMOD_WFM)
    from sdrplusplusbrown_tpu_torch.models.rds import RDSDemod
    from sdrplusplusbrown_tpu_torch.ops.demod import AMDemod
    from sdrplusplusbrown_tpu_torch.runtime.block import to_device
    B = int(FS // 20)             # 50 ms, the served block without RDS
    # the scan PLL: one radio at 2.4 MS/s, 50 ms blocks (6 250 MPX samples)
    scan = Radio(FS, DEMOD_WFM, pll_mode="scan", device=dev)
    x = stereo_wideband(LOOP_BLOCKS * B, [APP_WFM[0]])
    reset_counts()
    with no_plain_on_card():
        outs, cap24 = capture(tuple(KERNELS), lambda: run_radio(
            scan, x, B, dev, LOOP_BLOCKS, APP_WFM[0]))
    torch.cuda.synchronize()
    counts = {t: kernel_count(t) for t in KERNELS}
    if counts["K13p"] != LOOP_BLOCKS or counts["K10"] or counts["K2"]:
        fail(f"phase 24: scan-PLL radio launch pattern {counts}")
    report["K13p"] = check_loop_kernel("K13p", cap24["K13p"][-1], card,
                                       "the scan-PLL radio's MPX block",
                                       timed=True)
    report["K13p"]["launches"] = counts["K13p"]
    report["K13p"]["launches_path"] = \
        f"scan-PLL radio ({LOOP_BLOCKS} blocks)"
    report["K13p"]["launches_by_path"] = {
        "scan-PLL radio": counts["K13p"]}
    aud = outs[-1][0].numpy().astype(np.float64)
    snr, sep = stereo_oracle(aud[None])
    print(f"phase 24: Radio(pll_mode=\"scan\") at {FS / 1e6:.1f} MS/s, "
          f"{B}-sample blocks, K13p {counts['K13p']} launches: tone SNR "
          f"{snr:.1f} dB (bound 35), separation {sep:.1f} dB (bound 25)")
    if snr <= 35.0 or sep <= 25.0:
        fail("phase 24: the scan-PLL radio's audio oracle failed")
    # RDSDemod on a WFM radio's RDS tap: K12c, K13c and K13m at the shapes
    # of phase 25's served block (480 000 samples, the lcm of the
    # spectrum's 120 000-sample interval and the RDS granularity: 1 000
    # RDS samples)
    rb = 480_000
    radio = Radio(FS, DEMOD_WFM, rds=True, device=dev)
    xr = rds_wideband(2 * rb, APP_WFM[0])
    demod = RDSDemod()
    rst = to_device(demod.init_state(()), dev)

    def rds_run():
        nonlocal rst
        for y in run_radio(radio, xr, rb, dev, 2, APP_WFM[0]):
            _, rst = demod.apply(None, rst, y[1].to(dev))
    with no_plain_on_card():
        _, cap_rds = capture(("K12c", "K13c", "K13m"), rds_run)
    for tag in ("K12c", "K13c", "K13m"):
        report[tag] = check_loop_kernel(tag, cap_rds[tag][-1], card,
                                        "RDSDemod, the served block",
                                        timed=True)
    # the Radio's other forms, card against the host CPU, >= 80 dB (the
    # first block after its first 20 ms, the filters' transient)
    xs = stereo_wideband(3 * B, [APP_WFM[0]]) \
        + nfm_wideband(3 * B, APP_NFM, range(len(APP_NFM)))
    forms = [("mono WFM", dict(demod_id=DEMOD_WFM, stereo=False),
              APP_WFM[0]),
             ("RAW", dict(demod_id=DEMOD_RAW), APP_NFM[0]),
             ("NFM, 50 us de-emphasis", dict(demod_id=DEMOD_NFM,
                                             deemphasis="50us"), APP_NFM[0])]
    for label, kw, off in forms:
        got = {d: run_radio(Radio(FS, device=d, **kw), xs, B, d, 3, off)
               for d in ("cpu", dev)}
        worst = min(snr_db(w[0][..., 960 if b == 0 else 0:],
                           g[0][..., 960 if b == 0 else 0:])
                    for b, (w, g) in enumerate(zip(got["cpu"], got[dev])))
        print(f"phase 24: {label} card against host CPU, 3 blocks: "
              f"{worst:.1f} dB (bound 80)")
        if worst < 80.0:
            fail(f"phase 24: {label}: card and CPU disagree ({worst:.1f} dB)")
    # AM with the carrier AGC (K12c on the IF), [4, 2 400] at 15 kS/s
    am = AMDemod(15e3, carrier_agc=True)
    n = np.arange(3 * 2400)
    rng = np.random.default_rng(25)
    aif = np.stack([(0.3 + 0.2 * r) * (1 + 0.5 * np.sin(2 * np.pi * 1e3 * n
                                                        / 15e3))
                    * np.exp(2j * np.pi * 300.0 * n / 15e3)
                    for r in range(4)])
    aif = (aif + 0.01 * (rng.standard_normal(aif.shape)
                         + 1j * rng.standard_normal(aif.shape))
           ).astype(np.complex64)
    res = {}
    for d in ("cpu", dev):
        st, ys = to_device(am.init_state((4,)), d), []
        for b in range(3):
            y, st = am.apply(None, st, torch.from_numpy(
                aif[:, b * 2400:(b + 1) * 2400]).to(d))
            ys.append(y.cpu())
        res[d] = ys
    worst = min(snr_db(w, g) for w, g in zip(res["cpu"], res[dev]))
    print(f"phase 24: AMDemod(carrier_agc=True) [4, 2400] x 3 card against "
          f"host CPU: {worst:.1f} dB (bound 80)")
    if worst < 80.0:
        fail(f"phase 24: the AM carrier AGC: card and CPU disagree")


def rds_config(capture: str, pump: str) -> dict:
    """Phase 25's config.json: the RDS station through a file source,
    fft 65 536 at 20 fps, the DC blocker, two WFM radios on the station,
    W with ``rds: true``; V's RDS goes on over HTTP."""
    return {"source": {"type": "file", "path": capture, "loop": True},
            "fftSize": FFT, "fftRate": 20, "pump": pump, "dcBlocking": True,
            "modules": {"W": {"type": "radio", "demod": "WFM",
                              "offset": APP_WFM[0], "rds": True},
                        "V": {"type": "radio", "demod": "WFM",
                              "offset": APP_WFM[0]}}}


def rds_complete(st: dict) -> bool:
    return (st.get("synced") and st.get("pi") == RDS_PI
            and st.get("ps") == RDS_PS and st.get("radiotext") == RDS_RT)


def drive_rds(dev, card: str, report: dict) -> None:
    """Phase 25: the served app at full width decoding RDS on two radios,
    then the threaded pump with RDS on."""
    import tempfile
    import torch
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    from sdrplusplusbrown_tpu_torch.server.http_server import HttpDebugServer
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rds_") as tmp:
        cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024"
                                ".wav")
        write_wav(cap, rds_wideband(int(FS * RDS_SECONDS), APP_WFM[0]), FS,
                  bits=32)
        app = new_app(os.path.join(tmp, "p25"), rds_config(cap, "manual"),
                      dev)
        http = HttpDebugServer(app, port=0)
        http.start()
        base = f"http://127.0.0.1:{http.port}"
        got = {n: [] for n in app.modules}
        for n, m in app.modules.items():
            m.audio_event.bind(lambda blk, n=n: got[n].append(blk))
        done, on_at, statuses = {}, {"W": 0}, []

        def run():
            app.start()
            b = 0
            while len(done) < 2:
                if b == RDS_SET_BLOCK:
                    r = http_call(base, "/module/V/command",
                                  {"cmd": "set_rds", "args": "1"})
                    if r != {"status": "ok", "rds": True}:
                        fail(f"phase 25: set_rds over HTTP: {r}")
                    on_at["V"] = b
                if app.pump_step(1) != 1:
                    fail("phase 25: the pump stopped")
                b += 1
                st = {n: http_call(base, f"/module/{n}/command",
                                   {"cmd": "get_rds", "args": ""})
                      for n in ("W", "V")}
                statuses.append(st)
                for n in ("W", "V"):
                    if n not in done and rds_complete(st[n]):
                        done[n] = b
                secs = (b - min(on_at.values())) * app.pump_block_len / FS
                if secs > RDS_DECODE_S + 0.2:
                    break
            torch.cuda.synchronize()
        try:
            reset_counts()
            with no_plain_on_card():
                _, cap25 = capture(tuple(KERNELS), run)
            counts = {t: kernel_count(t) for t in KERNELS}
            block_len = app.pump_block_len
        finally:
            app.shutdown()
            http.stop()
        dur = block_len / FS
        for n in ("W", "V"):
            if n not in done:
                fail(f"phase 25: radio {n} did not decode the station: "
                     f"{statuses[-1][n]}")
            s = (done[n] - on_at[n]) * dur
            print(f"phase 25: radio {n} synced with PI {RDS_PI:#06x}, PS "
                  f"{RDS_PS!r}, RT {RDS_RT!r} after {s:.2f} s of signal "
                  f"from its switch-on (bound {RDS_DECODE_S}); "
                  f"{statuses[-1][n]['groups']} groups")
            if s > RDS_DECODE_S:
                fail(f"phase 25: radio {n} took {s:.2f} s to decode")
        nb = len(statuses)
        hold_launches(f"phase 25, served app with RDS, {nb} blocks",
                      {t: counts[t] for t in RDS_TAGS}, cap25)
        others = {t: c for t, c in counts.items() if c and t not in RDS_TAGS}
        if min(counts[t] for t in RDS_TAGS) < 1 or others:
            fail(f"phase 25: launch pattern {counts}")
        for t in RDS_TAGS:
            report.setdefault(t, {}).setdefault("launches_by_path", {})[
                "served app with RDS"] = counts[t]
        for t in ("K12c", "K13c", "K13m"):
            report[t]["launches"] = counts[t]
            report[t]["launches_path"] = f"served app with RDS ({nb} blocks)"
        for t in ("K12c", "K13c", "K13m"):
            err = check_loop_kernel(t, cap25[t][-1], card,
                                    "served app with RDS",
                                    timed=False)["max_abs_err"]
            report[t]["max_abs_err"] = max(report[t]["max_abs_err"], err)
        # K15 at the served RDS block's DC blocker: 480 000 samples
        k15 = cap25["K15"][-1]
        err = check_app_kernel("K15", k15, card, k15_what(k15) + ", the "
                               "served RDS block", min_db=100.0)
        report["K15"]["max_abs_err"] = max(report["K15"]["max_abs_err"],
                                           err["max_abs_err"])
        k15_unfused(k15, card)
        print(f"phase 25: served app on {dev} ({block_len}-sample blocks, "
              f"the RDS granularity; fft {FFT}, DC blocker on), two WFM "
              f"radios with RDS, {nb} blocks: launches "
              + ", ".join(f"{t}={counts[t]}" for t in RDS_TAGS)
              + ", every other kernel 0")
        for n in ("W", "V"):
            aud = np.concatenate(got[n][-3:], axis=-1).astype(np.float64)
            snr, sep = stereo_oracle(aud[None])
            print(f"phase 25: radio {n} audio, last 3 blocks: tone SNR "
                  f"{snr:.1f} dB (bound 35), separation {sep:.1f} dB "
                  f"(bound 25)")
            if snr <= 35.0 or sep <= 25.0:
                fail(f"phase 25: radio {n}'s audio oracle failed")
        run = pump_in_real_time(
            dev, card, os.path.join(tmp, "p25rt"), rds_config(cap, "thread"),
            "phase 25", RDS_RT_SECONDS, prepare=lambda a: a.modules["V"]
            .handle_debug_command("set_rds", "1"))
        # the served block is 50 ms without RDS; held to that, not to
        # the RDS granularity's longer block
        real_time_bar("phase 25", run, 50.0)


# ---- the network path (phase 26) -------------------------------------
NET_BLOCKS = 6                # the client app's manual blocks a mode
SERVED_BLOCK = 120_000        # the served app's block (50 ms)
NET_RT_SECONDS = 5.0          # the int8 client's threaded pump
NET_EFFT_FRAMES = 40          # EFFT frames the client takes
NET_EFFT_WFM_BAR = 30.0       # the WFM tone SNR bar over EFFT (dB; a
                              # CPU rehearsal at 1 MS/s gave 39.7)
NET_TAGS = ("K4f", "K8", "K9", "K15")
EFFT_DEV_FRAMES = 32          # the device EFFT: 32 frames of 65 536
FEED_FS = 96_000.0            # tests/test_efft_device.py's feed signal


def net_client_config(port: int, mode: str, pump: str) -> dict:
    """Phase 19's app (its WFM, NFM and squelched NFM radios, the DC
    blocker, fft 65 536 at 20 fps) on an ``sdrpp_server`` source."""
    conf = served_config("", pump)
    conf["source"] = {"type": "sdrpp_server", "host": "127.0.0.1",
                      "port": port, "compression": mode}
    return conf


class NetServer:
    """A fresh in-process StreamServer on a port app with the capture as
    its file source (so its stream starts at the capture's sample 0); the
    time each broadcast takes on the host, and the EFFT compressor's
    frames, samples and seconds."""

    def __init__(self, root: str, cap: str, dev):
        from sdrplusplusbrown_tpu_torch.ops.efft import EFFTCompressor
        from sdrplusplusbrown_tpu_torch.server import stream_server
        self.app = new_app(root, {"source": {"type": "file", "path": cap,
                                             "loop": True}}, dev)
        self.srv = stream_server.StreamServer(self.app, port=0,
                                              host="127.0.0.1")
        self.bcast, self.efft = [], {"s": 0.0, "n": 0, "zero": []}
        orig, efft = self.srv.broadcast_baseband, self.efft

        def timed(blk):
            t = time.perf_counter()
            orig(blk)
            self.bcast.append((time.perf_counter() - t, len(blk)))
        self.srv.broadcast_baseband = timed

        class Timed(EFFTCompressor):
            def process(self, x):
                t = time.perf_counter()
                out = super().process(x)
                efft["s"] += time.perf_counter() - t
                efft["n"] += len(x)
                efft["zero"] += [float(np.mean(f == 0)) for f in out]
                return out
        self._module, self._orig = stream_server, EFFTCompressor
        stream_server.EFFTCompressor = Timed
        self.srv.start()
        self.port = self.srv.port

    def close(self):
        self._module.EFFTCompressor = self._orig
        self.srv.stop()
        self.app.shutdown()


class NetServerProcess:
    """The stream server as a process of its own, as a client meets it
    in use: ``python -m sdrplusplusbrown_tpu_torch --server`` on the host
    CPU with the capture as its file source and no radio, so that its
    compression does not share the client's interpreter."""

    def __init__(self, root: str, cap: str):
        import socket
        os.makedirs(root)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump({"source": {"type": "file", "path": cap,
                                  "loop": True}, "modules": {}}, f)
        ports = []
        for _ in range(2):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                ports.append(s.getsockname()[1])
        http, self.port = ports
        self.base = f"http://127.0.0.1:{http}"
        self.log = open(os.path.join(root, "server.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "sdrplusplusbrown_tpu_torch", "--root",
             root, "--http", str(http), "--server", "--port",
             str(self.port), "--device", "cpu"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=self.log,
            stderr=subprocess.STDOUT)
        deadline = time.time() + 180
        while True:
            if self.proc.poll() is not None or time.time() > deadline:
                self.close()
                fail("phase 26 (b): the stream server did not come up")
            try:
                http_call(self.base, "/status", timeout=1)
                break
            except OSError:
                time.sleep(0.2)

    def close(self):
        try:
            if self.proc.poll() is None:
                http_call(self.base, "/exit", timeout=10)
                self.proc.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=10)
            self.log.close()


def run_net_app(app, blocks: int, sync) -> dict:
    """``blocks`` manual pump steps: each radio's audio a block."""
    got = {n: [] for n in app.modules}
    for n, m in app.modules.items():
        m.audio_event.bind(lambda blk, n=n: got[n].append(blk))
    app.modules["Q"].handle_debug_command("set_squelch", f"{SQUELCH_DB}")
    app.start()
    out = {n: [] for n in app.modules}
    for _ in range(blocks):
        if app.pump_step(1) != 1:
            fail("phase 26: the pump stopped")
        for n in app.modules:
            out[n].append(np.concatenate(got[n], axis=-1))
            got[n].clear()
    sync()
    return out


def net_oracles(label: str, out: dict, blocks, card: str) -> None:
    """Phase 19's audio oracles on ``blocks``: WFM tone SNR > 35 dB and
    separation > 25 dB, NFM tone SNR > 40 dB, the squelched radio
    exactly zero in every block."""
    for b in blocks:
        snr, sep = stereo_oracle(out["W"][b].astype(np.float64)[None])
        nfm = tone_snr_db(out["N"][b][0].astype(np.float64))
        print(f"{label} block {b + 1}: WFM tone SNR {snr:.1f} dB (bound "
              f"35), separation {sep:.1f} dB (bound 25), NFM tone SNR "
              f"{nfm:.1f} dB (bound 40) [{card}]")
        if snr <= 35.0 or sep <= 25.0 or nfm <= 40.0:
            fail(f"{label} block {b + 1}: audio oracle failed")
    if any(q.any() for q in out["Q"]):
        fail(f"{label}: the squelched radio is not exactly silent")


def drive_network(dev, card: str, report: dict) -> None:
    """Phase 26: the network path.  (a) ``python -m
    sdrplusplusbrown_tpu_torch --server --rigctl`` as a subprocess; (b)
    the app on an ``sdrpp_server`` source on the card, none / int8 /
    int8 threaded / efft; (c) the device EFFT and the device feed on the
    card against the host CPU.  No profiler window: CUDA events and the
    wall clock."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_net_") as tmp:
        cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024"
                                ".wav")
        served_capture(cap)
        net_entry_point(card, tmp, cap)
        t1 = time.perf_counter()
        net_client_app(dev, card, report, tmp, cap)
    t2 = time.perf_counter()
    efft_on_card(dev, card)
    t3 = time.perf_counter()
    print(f"phase 26: {t3 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}"
          f", (c) {t3 - t2:.1f}) [{card}]")


def net_entry_point(card: str, tmp: str, cap: str) -> None:
    """(a): the entry point with the stream server and rigctl on the
    capture: /status, a handshake and three int8 blocks, rigctl F, f, M
    and m, then /exit and exit code 0."""
    import socket
    from sdrplusplusbrown_tpu_torch.server.rigctl_client import RigctlClient
    from sdrplusplusbrown_tpu_torch.server.stream_client import StreamClient
    root = os.path.join(tmp, "p26a")
    os.makedirs(root)
    conf = served_config(cap, "manual", squelched=False)
    conf["modules"] = {"Radio": conf["modules"]["W"],
                       "N": conf["modules"]["N"]}
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(conf, f)
    ports = []
    for _ in range(3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    http, stream, rig = ports
    base = f"http://127.0.0.1:{http}"
    log_path = os.path.join(tmp, "p26a.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sdrplusplusbrown_tpu_torch", "--root",
             root, "--http", str(http), "--autostart", "--server", "--port",
             str(stream), "--rigctl", str(rig)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
            stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 180
        while True:
            if proc.poll() is not None or time.time() > deadline:
                fail("phase 26 (a): the app did not come up")
            try:
                if http_call(base, "/status", timeout=1)["mainLoopStarted"]:
                    break
            except OSError:
                time.sleep(0.2)
        up = time.perf_counter() - t0
        cli = StreamClient("127.0.0.1", stream, compression="int8")
        try:
            got = []
            for blk in cli.blocks(timeout=30):
                got.append(blk)
                if len(got) == 3:
                    break
        finally:
            cli.close()
        rc_cli = RigctlClient("127.0.0.1", rig, timeout=30)
        try:
            rig_out = [rc_cli.set_frequency(101_300_000),
                       rc_cli.get_frequency(), rc_cli.set_mode("FM", 12500),
                       rc_cli.get_mode()]
        finally:
            rc_cli.close()
        if (cli.samplerate != FS or len(got) != 3
                or any(b.shape != (int(FS / 200),) for b in got)
                or rig_out != [True, 101_300_000.0, True, ("FM", 12500)]):
            fail(f"phase 26 (a): samplerate {cli.samplerate}, blocks "
                 f"{[b.shape for b in got]}, rigctl {rig_out}")
        http_call(base, "/exit")
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    if rc != 0:
        with open(log_path) as f:
            fail(f"phase 26 (a): exit code {rc}; log tail:\n"
                 f"{f.read()[-3000:]}")
    print(f"phase 26 (a): python -m sdrplusplusbrown_tpu_torch --server "
          f"--rigctl served /status {up:.1f} s after the start; a client's "
          f"handshake at {cli.samplerate:.0f} S/s and 3 int8 blocks of "
          f"{got[0].shape[0]}; rigctl F, f {rig_out[1]:.0f}, M FM, m "
          f"{rig_out[3]}; exit code {rc} [{card}]")


def net_client_app(dev, card: str, report: dict, tmp: str,
                   cap: str) -> None:
    """(b): the app on the card fed from an in-process server, a fresh
    server a mode (the threaded run's server is a process of its own)."""
    import torch
    sync = torch.cuda.synchronize
    # the reference: the same app fed from the file
    ref = run_net_app(new_app(os.path.join(tmp, "p26file"),
                              served_config(cap, "manual"), dev),
                      NET_BLOCKS, sync)
    runs = {}
    for mode in ("none", "int8"):
        srv = NetServer(os.path.join(tmp, f"p26srv_{mode}"), cap, dev)
        try:
            app = new_app(os.path.join(tmp, f"p26{mode}"),
                          net_client_config(srv.port, mode, "manual"), dev)
            try:
                if mode == "none":
                    reset_counts()
                    with no_plain_on_card():
                        runs[mode], cap26 = capture(tuple(KERNELS), lambda: (
                            run_net_app(app, NET_BLOCKS, sync)))
                    counts = {t: kernel_count(t) for t in KERNELS}
                else:
                    runs[mode] = run_net_app(app, NET_BLOCKS, sync)
            finally:
                app.shutdown()
            bc = np.array(srv.bcast)
        finally:
            srv.close()
        if mode == "int8":
            print(f"phase 26 (b) int8: the server's host compression "
                  f"{bc[:, 0].mean() * 1e3:.3f} ms a {int(bc[0, 1])}-sample "
                  f"source block (median {np.median(bc[:, 0]) * 1e3:.3f}), "
                  f"{bc[:, 0].sum() / bc[:, 1].sum() * SERVED_BLOCK * 1e3:.3f}"
                  f" ms a {SERVED_BLOCK}-sample block [{card}]")
    for n in ref:
        for b in range(NET_BLOCKS):
            if not np.array_equal(runs["none"][n][b], ref[n][b]):
                fail(f"phase 26 (b) none: radio {n} block {b + 1} differs "
                     f"from the app fed from the file")
    hold_launches(f"phase 26 (b), network client, {NET_BLOCKS} blocks",
                  {t: counts[t] for t in NET_TAGS}, cap26)
    others = {t: c for t, c in counts.items() if c and t not in NET_TAGS}
    if min(counts[t] for t in NET_TAGS) < 1 or others:
        fail(f"phase 26 (b): launch pattern {counts}")
    for t in NET_TAGS:
        report.setdefault(t, {}).setdefault("launches_by_path", {})[
            "network client"] = counts[t]
    print(f"phase 26 (b) none: {NET_BLOCKS} blocks, every radio's audio "
          f"bit-identical to the app fed from the file on {dev}; launches "
          + ", ".join(f"{t}={counts[t]}" for t in NET_TAGS)
          + f", every other kernel 0 [{card}]")
    net_oracles("phase 26 (b) int8", runs["int8"], (2, 5), card)
    net_threaded(dev, card, tmp, cap)
    net_efft(dev, card, tmp, cap)


def net_threaded(dev, card: str, tmp: str, cap: str,
                 in_process: bool = False) -> None:
    """(b) int8 with the pump thread for NET_RT_SECONDS, the server a
    process of its own (``NetServerProcess``; ``in_process``: a
    ``NetServer`` in this interpreter, as scripts/net_rt_ab.py compares):
    each block's wall time from the arrival of its last samples to its
    end through a sync (the stream is paced to real time, so the time
    between blocks is the block's duration), /status's secondsBehind,
    the received rate."""
    import tempfile
    import threading
    import torch
    threads = threading.active_count()     # before the server and app
    sub = tempfile.mkdtemp(prefix="p26rt_", dir=tmp)
    srv = (NetServer(os.path.join(sub, "srv"), cap, dev) if in_process
           else NetServerProcess(os.path.join(sub, "srv"), cap))
    where = "in this process" if in_process else "a process of its own"
    try:
        # settled before the client connects: the stream runs from the
        # connection on, and a collection over the script's heap after it
        # would queue a backlog of samples for the pump's first blocks
        with settled_heap():
            app = new_app(os.path.join(sub, "app"),
                          net_client_config(srv.port, "int8", "thread"),
                          dev, run_pump=True)
            try:
                app.modules["Q"].handle_debug_command("set_squelch",
                                                      f"{SQUELCH_DB}")
                walls, last = [], [0.0]
                src_iter = app._source_iter

                def arrivals():
                    for blk in src_iter():
                        last[0] = time.perf_counter()
                        yield blk

                def timed_loop():
                    for _ in app._pump_iter():
                        torch.cuda.synchronize()
                        walls.append(time.perf_counter() - last[0])
                app._source_iter = arrivals
                app._pump_loop = timed_loop
                queued = app.source._q.qsize()
                t0 = time.perf_counter()
                app.start()
                time.sleep(NET_RT_SECONDS)
                st, blocks = app.status(), app.blocks_processed
                secs = time.perf_counter() - t0
                block_len = app.pump_block_len
            finally:
                app.shutdown()
    finally:
        srv.close()
    w = np.array(walls[3:]) * 1e3
    worst = np.argsort(w)[::-1][:3]
    dur = block_len / FS * 1e3
    p = [float(np.percentile(w, q)) for q in (50, 90, 99)]
    print(f"phase 26 (b) int8, threaded pump, the server {where}: "
          f"{blocks} blocks of "
          f"{block_len} in {secs:.1f} s, {blocks * block_len / secs / 1e6:.4f}"
          f" MS/s received; from the last samples' arrival to the block's "
          f"end through a sync p50 / p90 / p99 {p[0]:.4f} / {p[1]:.4f} / "
          f"{p[2]:.4f} ms (bound {dur:.0f}), the worst three "
          + " / ".join(f"{w[i]:.4f} (block {i + 3})" for i in worst)
          + f" ms; secondsBehind "
          f"{st['secondsBehind']}, rtFactor {st['rtFactor']}; {queued} "
          f"source blocks queued at the start, {threads} threads in this "
          f"process before it [{card}]")
    if st["secondsBehind"] != 0 or p[2] >= dur or blocks < 5:
        fail("phase 26 (b) int8: not real time")


def net_efft(dev, card: str, tmp: str, cap: str) -> None:
    """(b) efft: NET_EFFT_FRAMES frames into the client app (manual pump),
    not paced: the server's host EFFT rate, the share of zeroed bins, the
    WFM tone SNR of the last three blocks.  The share is printed, not
    held: on this crowded band (four carriers, each frame's unwindowed
    leakage above the windowed floor) the compressor zeroes ~4 % of the
    bins (ops/efft.py on the host, as the JAX package's); the thinning
    on a quiet band is held in (c)."""
    import torch
    srv = NetServer(os.path.join(tmp, "p26srv_efft"), cap, dev)
    try:
        app = new_app(os.path.join(tmp, "p26efft"),
                      net_client_config(srv.port, "efft", "manual"), dev)
        try:
            n_fft = 1 << int(np.floor(np.log2(FS * 0.05)))
            blocks = -(-NET_EFFT_FRAMES * n_fft // SERVED_BLOCK)
            t0 = time.perf_counter()
            out = run_net_app(app, blocks, torch.cuda.synchronize)
            secs = time.perf_counter() - t0
            if app.pump_block_len != SERVED_BLOCK:
                fail(f"phase 26 (b) efft: {app.pump_block_len}-sample "
                     f"blocks")
        finally:
            app.shutdown()
        e = dict(srv.efft)
    finally:
        srv.close()
    zero = float(np.mean(e["zero"]))
    frame_ms = e["s"] / max(len(e["zero"]), 1) * 1e3
    snr, sep = stereo_oracle(np.concatenate(out["W"][-3:], axis=-1)
                             .astype(np.float64)[None])
    print(f"phase 26 (b) efft: {len(e['zero'])} frames of {n_fft} emitted, "
          f"{blocks} client blocks in {secs:.2f} s; zeroed bins "
          f"{zero:.3f} of a frame; the server's host EFFT "
          f"{e['n'] / e['s'] / 1e6:.3f} MS/s ({frame_ms:.1f} ms a frame; "
          f"the feed is {FS / 1e6:.1f} MS/s); WFM "
          f"tone SNR {snr:.1f} dB (bound {NET_EFFT_WFM_BAR:.0f}), "
          f"separation {sep:.1f} dB [{card}]")
    if len(e["zero"]) < NET_EFFT_FRAMES or snr <= NET_EFFT_WFM_BAR:
        fail("phase 26 (b) efft failed")


def graph_node_kinds(dot: str) -> list:
    """Each node's kind ("kernel", "memset", "memcpy" or "other") in a
    CUDA graph's dot dump (``cudaGraphDebugDotPrint``): split at each
    node's definition, the kind the first word of its label names."""
    nodes = re.split(r'\n\s*"[^"\n]*node[^"\n]*"\s*\[', "\n" + dot)[1:]
    return [next((k.lower() for k in ("KERNEL", "MEMSET", "MEMCPY")
                  if re.search(rf"\b{k}\b", c)), "other") for c in nodes]


def cuda_graph_kernels(fn, card: str) -> int | None:
    """CUDA kernel launches of one call of ``fn``: the kernel nodes of a
    CUDA graph captured around it (None when the call cannot be
    captured)."""
    import torch
    g = torch.cuda.CUDAGraph(keep_graph=True)     # kept for the dump
    g.enable_debug_mode()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(s):
            fn()                                  # warm the allocator
        torch.cuda.current_stream().wait_stream(s)
        with torch.cuda.graph(g):
            fn()
    except RuntimeError as e:
        print(f"phase 26 (c): graph capture failed: {e}"[:300])
        return None
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".dot") as f:
        g.debug_dump(f.name)
        with open(f.name) as h:
            dot = h.read()
    kinds = graph_node_kinds(dot)
    print(f"phase 26 (c): the captured call's graph: {len(kinds)} nodes, "
          + ", ".join(f"{k} {kinds.count(k)}" for k in sorted(set(kinds)))
          + f" [{card}]")
    return kinds.count("kernel")


def np_snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    """Agreement of ``got`` with ``ref`` in dB (numpy, complex too)."""
    ref = ref.astype(np.complex128)
    err = got.astype(np.complex128) - ref
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2)
                               / max(np.mean(np.abs(err) ** 2), 1e-300)))


def feed_signal(T: int) -> np.ndarray:
    """tests/test_efft_device.py's signal at FEED_FS: light noise, a
    0.05 line at 8 kHz and a 0.02 line at −15 kHz."""
    rng = np.random.default_rng(12345)
    t = np.arange(T) / FEED_FS
    return (0.001 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
            + 0.05 * np.exp(2j * np.pi * 8_000 * t)
            + 0.02 * np.exp(2j * np.pi * -15_000 * t)).astype(np.complex64)


def quiet_band(T: int) -> np.ndarray:
    """The EFFT's design case at FS: light noise and two carriers (0.05
    at FS / 13, 0.02 at −FS / 6), tests/test_torch_cuda.py's signal."""
    rng = np.random.default_rng(3)
    t = np.arange(T) / FS
    return (0.001 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
            + 0.05 * np.exp(2j * np.pi * FS / 13 * t)
            + 0.02 * np.exp(2j * np.pi * -FS / 6 * t)).astype(np.complex64)


def efft_two_calls(blk: dict, x) -> dict:
    """Each device's block on two calls of ``x``; the second call's
    (emits on the host, readys, state)."""
    out = {}
    for d, b in blk.items():
        (_, _), s1 = b.apply(None, b.init_state(), x)
        (e, r), s2 = b.apply(None, s1, x)
        out[d] = (e.cpu().numpy(), r.cpu(), int(s2["count"]))
    return out


def efft_on_card(dev, card: str) -> None:
    """(c): EFFTCompressorDevice at 2.4 MS/s (32 frames of 65 536) on the
    card against the host CPU, the second of two calls (every frame
    ready): on the quiet band held (masks, readys and count equal, emits
    >= 60 dB); on phase 19's crowded band printed, not held (there a
    last-bit difference of the FFT moves a few per cent of the mask: the
    15th-percentile cuts and the hole fills that follow them turn it
    into a different floor), and timed: CUDA events a call and the
    kernel launches of a captured call.  Then DeviceFeed in its three
    modes on the card against the host CPU, with
    tests/test_efft_device.py's bars."""
    import torch
    from sdrplusplusbrown_tpu_torch.io.feed import DeviceFeed
    from sdrplusplusbrown_tpu_torch.ops.efft_device import (
        EFFTCompressorDevice)
    blk = {d: EFFTCompressorDevice(FS, device=d) for d in ("cpu", dev)}
    n = blk["cpu"].fft_size
    T = EFFT_DEV_FRAMES * n
    crowded = stereo_wideband(T, APP_WFM) + nfm_wideband(
        T, APP_NFM, range(len(APP_NFM)))
    for what, x in (("quiet band", quiet_band(T)),
                    ("phase 19's band", crowded.astype(np.complex64))):
        out = efft_two_calls(blk, torch.from_numpy(x))
        (ec, rc, cc), (eg, rg, cg) = out["cpu"], out[dev]
        flips = int(np.sum((eg != 0) != (ec != 0)))
        agree = np_snr_db(ec, eg)
        same = torch.equal(rg, rc) and cg == cc
        print(f"phase 26 (c): EFFTCompressorDevice, {what}, at "
              f"{FS / 1e6:.1f} MS/s, {EFFT_DEV_FRAMES} frames of {n}: card "
              f"against the host CPU {flips} of {eg.size} mask bins differ, "
              f"emits {agree:.1f} dB, readys and count "
              f"{'equal' if same else 'DIFFER'}; zeroed "
              f"{np.mean(eg == 0):.3f} [{card}]")
        if what == "quiet band" and (flips or agree < 60.0 or not same):
            fail("phase 26 (c): the device EFFT disagrees with the host CPU")
    xg = torch.from_numpy(crowded.astype(np.complex64)).to(dev)
    (_, _), s1g = blk[dev].apply(None, blk[dev].init_state(), xg)
    ms = event_ms(lambda: blk[dev].apply(None, s1g, xg), reps=10)
    launches = cuda_graph_kernels(lambda: blk[dev].apply(None, s1g, xg),
                                  card)
    print(f"phase 26 (c): EFFTCompressorDevice {ms:.4f} ms a call (CUDA "
          f"events, 10 calls) for {T} samples ({T / FS * 1e3:.1f} ms of "
          f"signal, {n / FS * 1e3:.1f} ms a frame), "
          f"{launches if launches is not None else 'not measured'} kernel "
          f"launches a call (a CUDA graph captured around one) [{card}]")
    # the device feed, tests/test_efft_device.py's run on the card and the
    # host CPU
    xf = feed_signal(1 << 17)
    for mode in ("none", "int8", "efft"):
        res = {}
        for d in ("cpu", dev):
            feed = DeviceFeed(mode, samplerate=FEED_FS, device=d)
            got = [feed.push(xf[i:i + (1 << 14)])
                   for i in range(0, len(xf), 1 << 14)]
            res[d] = (torch.cat([g.cpu() for g in got if g is not None])
                      .numpy(), feed.stats())
        (yc, sc_), (yg, sg_) = res["cpu"], res[dev]
        same = np.array_equal(yg, yc) if mode != "efft" else \
            np_snr_db(yc, yg) >= 60.0
        if mode == "none":
            ok, what = sg_["ratio"] == 1.0 and np.array_equal(yg, xf), \
                "ratio 1, exact"
        elif mode == "int8":
            snr = 10 * np.log10(np.mean(np.abs(xf) ** 2)
                                / np.mean(np.abs(yg - xf) ** 2))
            ok = sg_["ratio"] < 0.26 and snr > 25.0
            what = f"ratio {sg_['ratio']:.4f} (bound 0.26), SNR {snr:.1f} dB" \
                   f" (bound 25)"
        else:
            t = np.arange(len(yg)) / FEED_FS
            power = np.abs(np.vdot(np.exp(2j * np.pi * 8_000 * t), yg)) \
                / len(yg)
            ok = sg_["ratio"] < 0.15 and power > 0.03
            what = f"ratio {sg_['ratio']:.4f} (bound 0.15), 8 kHz line " \
                   f"{power:.4f} (bound 0.03)"
        print(f"phase 26 (c): DeviceFeed {mode} on the card: {what}; "
              f"against the host CPU {'equal' if same else 'DIFFERENT'}, "
              f"stats {'equal' if sg_ == sc_ else 'DIFFERENT'} [{card}]")
        if not (ok and same and sg_ == sc_):
            fail(f"phase 26 (c): DeviceFeed {mode}")


# ---- phase 27: every demod through the channelized bank ---------------------
MODES_C = 16                  # VFOs a group: CHANNELIZE_MIN_C, "auto" takes it
MODES_STEPS = 5
#: (name, first offset, spacing) of phase 27 (b)'s groups at 2.4 MS/s
MODES_GROUPS = (("am", -1.15e6, 25e3), ("usb", 100e3, 10e3),
                ("cw", 700e3, 10e3))
MODES_MARGIN_DB = 3.0         # the card's tone SNR may sit this far under
MODES_MIN_DB = 15.0           # the CPU's, and never under this (multimode8's)
MODES_SILENT_DB = 40.0        # a silent VFO's tone this far under its group's
MODES_NFM_FS = 96_000.0       # phase 27 (c): BASELINE config 3's rate
MODES_NFM_OFFSETS = (-30e3, -10e3, 12e3, 33e3)
MODES_NFM_TONES = (0, 2)
MODES_NFM_STEPS = 4
MODES_TAGS = ("K5", "K6", "K8", "K12")


def modes_vfos() -> list:
    """Phase 27 (b)'s bank: MODES_C AM, USB and CW VFOs each (MODES_GROUPS,
    317 Hz off the grid); the even VFOs of each group carry a tone."""
    from sdrplusplusbrown_tpu_torch.models.radio import (DEMOD_AM, DEMOD_CW,
                                                         DEMOD_USB)
    from sdrplusplusbrown_tpu_torch.models.radio_bank import VFOSpec
    ids = {"am": DEMOD_AM, "usb": DEMOD_USB, "cw": DEMOD_CW}
    return [VFOSpec(f"{name}{i}", ids[name], f0 + df * i + 317.0)
            for name, f0, df in MODES_GROUPS for i in range(MODES_C)]


def modes_tone_hz(demod_id: int) -> float:
    """The audio tone a carrying VFO of ``demod_id`` gives: 1 kHz, or the
    CW demod's 800 Hz note."""
    from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_CW
    return 800.0 if demod_id == DEMOD_CW else TONE_HZ


def modes_wideband(n: int, fs: float, vfos, seed: int = 19) -> np.ndarray:
    """Each even VFO's carrier in its mode: AM a 1 kHz tone at 30 % depth,
    USB a carrier 400 Hz under the offset (1 kHz above the suppressed
    carrier, the offset being the passband's centre), CW a carrier on the
    offset; plus complex noise at 1e-3."""
    from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_AM, DEMOD_USB
    t = np.arange(n) / fs
    tone = np.sin(2 * np.pi * TONE_HZ * t)
    rng = np.random.default_rng(seed)
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for v in vfos:
        if int(re.sub(r"\D", "", v.name)) % 2:
            continue
        f = v.offset_hz
        if v.demod_id == DEMOD_AM:
            x = x + 0.2 * (1 + 0.3 * tone) * np.exp(2j * np.pi * f * t)
        elif v.demod_id == DEMOD_USB:
            x = x + 0.1 * np.exp(2j * np.pi * (f - 400.0) * t)
        else:
            x = x + 0.1 * np.exp(2j * np.pi * f * t)
    return x.astype(np.complex64)


class torch_calls:
    """Within: the calls of ``torch.<name>`` for each of ``names`` that
    code of ``module`` makes, counted in ``counts`` (the module's global
    ``torch`` swapped for a counting stand-in)."""

    def __init__(self, module, names):
        self.module, self.names = module, names

    def __enter__(self):
        import torch
        counts = self.counts = {n: 0 for n in self.names}

        class Counting:
            def __getattr__(self, attr):
                fn = getattr(torch, attr)
                if attr not in counts:
                    return fn

                def call(*a, **k):
                    counts[attr] += 1
                    return fn(*a, **k)
                return call
        self.module.torch = Counting()
        return self

    def __exit__(self, *exc):
        import torch
        self.module.torch = torch
        return False


def k5_input_ops(bank, params, x) -> dict:
    """The ``torch.cat`` and ``torch.zeros`` calls made inside K5's
    launches (``channelizer_kernel._launch_pfb``: its input's layout)
    over one step of ``bank`` (whose K5 matrices are built already)."""
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    calls = {"cat": 0, "zeros": 0}
    orig = ck._launch_pfb

    def counted(*a, **k):
        with torch_calls(ck, tuple(calls)) as tc:
            out = orig(*a, **k)
        for name in calls:
            calls[name] += tc.counts[name]
        return out
    ck._launch_pfb = counted
    try:
        bank.apply(params, bank.init_state(), x, mono_out=True)
    finally:
        ck._launch_pfb = orig
    return calls


class no_plain_on_card:
    """Within: the plain versions of K5, K6, K8, K9, K12 (and K12c), K13
    (its PLL, Costas — K13b's among them —, M&M and FD forms), K14, K15
    and K16, and LogMMSE's plain history (``LogMMSE._push_history``), fail
    the run when given a CUDA tensor (a wrapper, or ``LogMMSE.prime``,
    that fell back to one on the card).  A call in another thread (the
    app's pump) is recorded and fails the run at the end of the block."""

    SITES = (("channelizer_kernel", "pfb_bins_ref"),
             ("chan_frontend", "chan_post_ref"),
             ("fir_kernel", "fir_rows_ref"), ("fir_kernel", "fir_cplx_ref"),
             ("agc", "agc_rows_ref"),
             ("pll", "pll_rows_ref"), ("costas", "costas_rows_ref"),
             ("clock_recovery", "mm_rows_ref"),
             ("clock_recovery", "fd_rows_ref"),
             ("recurrence", "linear_recurrence_ref"),
             ("logmmse", "logmmse_frames_ref"),
             ("logmmse", "LogMMSE._push_history"),
             ("fec", "viterbi_rows_ref"))

    def __enter__(self):
        import importlib
        import torch
        self.saved, self.hits = [], []
        for mod_name, name in self.SITES:
            owner = importlib.import_module("sdrplusplusbrown_tpu_torch.ops."
                                            + mod_name)
            *path, attr = name.split(".")
            for part in path:
                owner = getattr(owner, part)
            orig = getattr(owner, attr)

            def guard(*a, _orig=orig, _name=name):
                if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                    self.hits.append(_name)
                    fail(f"{_name} ran on the card")
                return _orig(*a)
            self.saved.append((owner, attr, orig))
            setattr(owner, attr, guard)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in self.saved:
            setattr(owner, attr, orig)
        if self.hits and exc[0] is None:
            fail(f"plain versions ran on the card: {sorted(set(self.hits))}")
        return False


def drive_modes(dev, card: str, report: dict) -> None:
    """Phase 27 on ``dev``; raises on the first failure.  (a) K5 at
    M = 100, 160 and 800 (the SSB, DSB, AM and CW banks' PFBs, the
    large-M kernel) and K5c at M = 128 against their plain versions in
    both handoffs, K6 at each bandwidth FIR; (b) a 2.4 MS/s bank of 16 AM,
    16 USB and 16 CW VFOs, every group channelized by "auto"; (c) a
    96 kS/s bank of 4 NFM VFOs on the shared bank without predecimation;
    (d) phase 19's app with the scanner, frequency manager, recorder and
    scheduler modules over HTTP.  Adds the paths' launches to the K5, K6,
    K7, K8 and K12 entries."""
    import tempfile
    t0 = time.perf_counter()
    modes_kernels(dev, card)
    t1 = time.perf_counter()
    modes_bank(dev, card, report)
    t2 = time.perf_counter()
    modes_nfm_shared(dev, card, report)
    t3 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_modes_") as tmp:
        cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024"
                                ".wav")
        served_capture(cap)
        modes_app(dev, card, tmp, cap)
    t4 = time.perf_counter()
    print(f"phase 27: {t4 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}"
          f", (c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}) [{card}]")


def modes_block(fs: float, granule: int) -> int:
    """BANK_SECONDS of samples at ``fs``, rounded up to ``granule``."""
    return -(-int(fs * BANK_SECONDS) // granule) * granule


def modes_kernels(dev, card: str) -> None:
    """(a): one step of each channelized group (phase 27 (b)'s AM, USB and
    CW, and a DSB group of MODES_C on the same band) captured in each
    handoff: K5 (the large-M kernel on the groups' gathered rows, on the
    T/h valid frames: float32 bins >= 100 dB, bf16 >= 60 dB, as phases 6
    and 8) and K6 (80 / 45 dB, its squelch sums within rtol 1e-5, its
    launches its plan's) against their plain versions, timed in bf16 with
    the design's cost (``k5_as_written``), K5's two yardsticks
    (``k5_yardsticks``) and, for K6, the conv1d yardstick; K5c at M = 128
    (10 MS/s, T = 2^21, every row) the same way as phase 16 (100 /
    45 dB), with its yardsticks."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_DSB, Radio
    from sdrplusplusbrown_tpu_torch.ops import precision
    from sdrplusplusbrown_tpu_torch.ops.channelizer import \
        PolyphaseChannelizer
    vfos = modes_vfos()
    bank = rb.RadioBank(FS, vfos, device=dev)
    T = modes_block(FS, bank.in_multiple)
    x = modes_wideband(T, FS, vfos)
    xd = (torch.from_numpy(x.real.copy()).to(dev),
          torch.from_numpy(x.imag.copy()).to(dev))
    dsb = Radio(FS, DEMOD_DSB, device=dev)
    dsb_offs = np.linspace(-1.1e6, 1.1e6, MODES_C) + 317.0

    def one_step():
        bank.apply(bank.make_params(), bank.init_state(), xd, mono_out=True)
        dsb.apply_channelized(dsb.make_params_channelized(dsb_offs),
                              dsb.init_state_channelized(MODES_C), xd,
                              mono_out=True)
        torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for handoff in ("float32", "bf16"):
        precision.set_handoff_dtype(handoff)
        f32 = handoff == "float32"
        _, cap = capture(("K5", "K6"), one_step)
        for call in cap["K5"]:
            pipe = call[0]
            what = (f"M = {pipe.M}, tpp = {pipe.tpp}, T = "
                    f"{call[1].shape[0]}, W = {call[5]}, {handoff} handoff")
            rows = call[8] if len(call) > 8 else None
            what += f", {2 * pipe.M if rows is None else len(rows)} rows"
            e = check_scanner_kernel("K5", call, card, 100.0 if f32 else 60.0,
                                     timed=not f32, what=what)
            if not f32:
                print(k5_as_written(pipe, call[5], call[6], e["bound_ms"],
                                    e["bound_by"], rows, call[1].shape[0]))
                k5_yardsticks(call, e["dev_us"], card)
        for call in cap["K6"]:
            pipe = call[0]
            what = (f"M = {pipe.M}, d2 {len(pipe.taps[0])} / FIR "
                    f"{len(pipe.taps[1])} taps, C = {call[3].shape[0]}, "
                    f"Tb = {call[8]}, {handoff} handoff")
            check_scanner_kernel("K6", call, card, 80.0 if f32 else 45.0,
                                 timed=not f32, what=what)
            tails_exact("K6", call, what)
            call_launches("K6", call, what)
            if not f32:
                k6_yardstick(call, card)
    ch = PolyphaseChannelizer(CHZ_FS, 128, device=dev)
    xr, xi = (torch.from_numpy(a).to(dev) for a in channelizer64_noise())
    for handoff in ("float32", "bf16"):
        precision.set_handoff_dtype(handoff)
        f32 = handoff == "float32"
        _, cap = capture(("K5c",), lambda: ch.apply_planes(ch.init_state(),
                                                           (xr, xi)))
        call = cap["K5c"][-1]
        e = check_app_kernel(
            "K5c", call, card, f"M = 128, tpp = {ch.pfb().tpp}, T = "
            f"{CHZ_T}, W = {call[5]}, {handoff} bins", timed=not f32,
            min_db=100.0 if f32 else BF16_DB)
        if not f32:
            print(k5_as_written(ch.pfb(), call[5], call[6],
                                *bound("K5c", call)))
            kern = getattr(*kernel_fn("K5c", "_kernel"))
            k5_yardsticks(call, device_us(lambda: kern(*call)), card)


def modes_bank(dev, card: str, report: dict) -> None:
    """(b): MODES_STEPS steps of the bank in the bf16 handoff, every group
    channelized by "auto" (K5, K6, the demods' K12 and K8), with K5's,
    K6's, K8's and K12's plain versions barred from the card; launches
    held to their plans; each tone VFO's tone SNR in the last step within
    MODES_MARGIN_DB of the same steps on the host CPU and >= MODES_MIN_DB,
    each silent VFO's tone (the AGC leaves noise alone quiet) at least
    MODES_SILENT_DB under the weakest of its group's tone VFOs, on both;
    no ``torch.cat`` or ``torch.zeros`` inside K5's launches
    (``k5_input_ops``); then the step's rate."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    from sdrplusplusbrown_tpu_torch.ops import precision
    vfos = modes_vfos()
    bank = rb.RadioBank(FS, vfos, device=dev)
    label = (f"channelized modes @ {FS / 1e6:g} MS/s ("
             + ", ".join(f"{len(g)} {bank.radios[d].demod_name}"
                         for d, g in bank.groups.items()) + ")")
    if not all(bank.channelized.values()):
        fail(f"{label}: groups channelized {bank.channelized}")
    T = modes_block(FS, bank.in_multiple)
    x = modes_wideband(MODES_STEPS * T, FS, vfos)
    xs = [(torch.from_numpy(x[b * T:(b + 1) * T].real.copy()),
           torch.from_numpy(x[b * T:(b + 1) * T].imag.copy()))
          for b in range(MODES_STEPS)]

    def run(device):
        bk = bank if device != "cpu" else rb.RadioBank(FS, vfos,
                                                       device="cpu")
        params, st, outs = bk.make_params(), bk.init_state(), []
        for xb in xs:
            audio, st = bk.apply(params, st, tuple(t.to(device) for t in xb),
                                 mono_out=True)
            outs.append(audio)
        if device != "cpu":
            torch.cuda.synchronize()
        return outs
    precision.set_handoff_dtype("bf16")
    reset_counts()
    with no_plain_on_card():
        outs, cap = capture(MODES_TAGS, lambda: run(dev))
    others = ("K1", "K7", "K11", "K5c", "K2", "K3")
    n = {t: kernel_count(t) for t in MODES_TAGS + others}
    hold_launches(f"{label}, {MODES_STEPS} steps", n, cap)
    groups = len(bank.groups)
    if n["K5"] != groups * MODES_STEPS or min(n["K8"], n["K12"]) < 1 or \
            any(n[t] for t in others):
        fail(f"{label}: launch pattern {n}")
    for t in MODES_TAGS:
        report.setdefault(t, {}).setdefault("launches_by_path", {})[
            f"{label} ({MODES_STEPS} steps)"] = n[t]
    cpu = run("cpu")[-1]
    rows = []
    for d, y in outs[-1].items():
        hz = modes_tone_hz(d)
        if y.shape != (MODES_C, T // 50) or not torch.isfinite(y).all():
            fail(f"{label}: group {d} audio {tuple(y.shape)} or non-finite")
        rows_d = [(y[i].double().cpu().numpy(), cpu[d][i].double().numpy())
                  for i in range(MODES_C)]
        top = min(min(tone_level_db(a, hz), tone_level_db(c, hz))
                  for a, c in rows_d[::2])
        for i, v in enumerate(bank.groups[d]):
            a, c = rows_d[i]
            if i % 2:
                lv = max(tone_level_db(a, hz), tone_level_db(c, hz))
                rows.append(f"{v.name} silent: tone {lv - top:.1f} dB under "
                            f"the group's")
                if lv > top - MODES_SILENT_DB:
                    fail(f"{label}: silent {v.name} shows a tone "
                         f"{lv - top:.1f} dB under its group's")
                continue
            got, ref = tone_snr_db(a, hz), tone_snr_db(c, hz)
            bar = max(ref - MODES_MARGIN_DB, MODES_MIN_DB)
            rows.append(f"{v.name} {got:.1f} (CPU {ref:.1f}, bar {bar:.1f})")
            if got < bar:
                fail(f"{label}: {v.name} tone SNR {got:.1f} dB, bar "
                     f"{bar:.1f}")
    print(f"{label} step {MODES_STEPS}: tone SNR dB (AM and USB 1 kHz, CW "
          f"800 Hz), card against the port's plain path on the host CPU: "
          + "; ".join(rows))
    params = bank.make_params()
    xd = tuple(t.to(dev) for t in xs[0])
    n = k5_input_ops(bank, params, xd)
    print(f"{label}: K5's launches made {n['cat']} torch.cat and "
          f"{n['zeros']} torch.zeros calls in a step (the earlier design's "
          f"CW route laid [history | x | 0] out with two and one; the "
          f"large-M kernel reads it by index)")
    if any(n.values()):
        fail(f"{label}: K5's input laid out by torch ops {n}")
    step_rate(f"{label}, bf16 handoff",
              lambda st: bank.apply(params, st, xd, mono_out=True)[1],
              bank.init_state(), T, card)


def modes_nfm_shared(dev, card: str, report: dict) -> None:
    """(c): 4 NFM VFOs at 96 kS/s (an NFM chain there is the polyphase
    resampler alone: the shared bank's "xlate" route, then K8 a stage and
    K7), MODES_NFM_STEPS steps: in the float32 handoff the card's audio
    >= 80 dB to the host CPU's a step, the tone VFOs' tone SNR > 40 dB
    (phase 19's NFM oracle) in the last step; in the bf16 handoff the
    launches held to their plans (K8 and K7; no K1, K11, K5 or K6)."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_NFM
    from sdrplusplusbrown_tpu_torch.ops import precision
    fs = MODES_NFM_FS
    vfos = [rb.VFOSpec(f"n{i}", DEMOD_NFM, o)
            for i, o in enumerate(MODES_NFM_OFFSETS)]
    bank = rb.RadioBank(fs, vfos, device=dev)
    route = bank.radios[DEMOD_NFM]._build_vfo_shared().route
    label = f"NFM x {len(vfos)} @ {fs / 1e3:g} kS/s ({route} route)"
    if route != "xlate" or bank.channelized[DEMOD_NFM]:
        fail(f"{label}: not the shared bank without predecimation")
    T = modes_block(fs, bank.in_multiple)
    n = MODES_NFM_STEPS * T
    t = np.arange(n) / fs
    fm = 2 * np.pi * 2000.0 * np.cumsum(np.sin(2 * np.pi * TONE_HZ * t)) / fs
    rng = np.random.default_rng(23)
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for k in MODES_NFM_TONES:
        x = x + 0.2 * np.exp(1j * (2 * np.pi * MODES_NFM_OFFSETS[k] * t + fm))
    x = x.astype(np.complex64)
    xs = [torch.from_numpy(x[b * T:(b + 1) * T]) for b in range(
        MODES_NFM_STEPS)]

    def run(device):
        bk = bank if device != "cpu" else rb.RadioBank(fs, vfos,
                                                       device="cpu")
        params, st, outs = bk.make_params(), bk.init_state(), []
        for xb in xs:
            audio, st = bk.apply(params, st, xb.to(device), mono_out=True)
            outs.append(audio[DEMOD_NFM])
        if device != "cpu":
            torch.cuda.synchronize()
        return outs
    precision.set_handoff_dtype("float32")
    card_out, cpu_out = run(dev), run("cpu")
    agree = [snr_db(c, g.cpu()) for c, g in zip(cpu_out, card_out)]
    tones = [tone_snr_db(card_out[-1][k].double().cpu().numpy())
             for k in MODES_NFM_TONES]
    print(f"{label}: card against the host CPU, audio "
          + ", ".join(f"{a:.1f}" for a in agree) + " dB a step (bound 80); "
          f"tone SNR " + ", ".join(f"{v:.1f}" for v in tones)
          + f" dB (bound 40) [{card}]")
    if min(agree) < 80.0 or min(tones) <= 40.0:
        fail(f"{label}: card against CPU or tone oracle failed")
    precision.set_handoff_dtype("bf16")
    reset_counts()
    with no_plain_on_card():
        _, cap = capture(("K7", "K8"), lambda: run(dev))
    others = ("K1", "K11", "K5", "K6")
    cnt = {t: kernel_count(t) for t in ("K7", "K8") + others}
    hold_launches(f"{label}, {MODES_NFM_STEPS} steps, bf16", cnt, cap)
    if min(cnt["K7"], cnt["K8"]) < 1 or any(cnt[t] for t in others):
        fail(f"{label}: launch pattern {cnt}")
    for tag in ("K7", "K8"):
        report[tag].setdefault("launches_by_path", {})[
            f"{label} ({MODES_NFM_STEPS} steps)"] = cnt[tag]


def modes_app(dev, card: str, tmp: str, cap: str) -> None:
    """(d): phase 19's app (manual pump, the WFM and NFM radios) on the
    card with a third NFM radio "S" and the scanner, frequency manager,
    recorder and scheduler modules, its HTTP control plane in process,
    every module command over HTTP (/module/<name>/command): the
    recorder on N's audio for 8 blocks (its WAV's 1 kHz tone > 40 dB,
    phase 19's NFM oracle); the scanner on S across +100 kHz to +1.1 MHz
    (its level 30 dB over the line's floor) reports ``receiving`` within
    1 kHz of the NFM carrier at APP_NFM[0]; a bookmark 700 kHz up in AM
    applied to S moves its offset and demod; a ``set_demod USB`` on S
    scheduled 0.2 s ahead fires; shutdown leaves no new thread alive."""
    import threading
    from sdrplusplusbrown_tpu_torch.io.wav import read_wav_iq
    from sdrplusplusbrown_tpu_torch.server.http_server import HttpDebugServer
    conf = served_config(cap, "manual", squelched=False)
    conf["modules"].update({
        "S": {"type": "radio", "demod": "NFM", "offset": 0.0},
        "Scan": {"type": "scanner", "vfo": "S", "start_freq": 100e3,
                 "stop_freq": 1.1e6, "interval": 25e3},
        "FM": {"type": "frequency_manager"}, "Rec": {"type": "recorder"},
        "Sched": {"type": "scheduler"}})
    before = set(threading.enumerate())
    app = new_app(os.path.join(tmp, "p27d"), conf, dev)
    http = HttpDebugServer(app, port=0)
    http.start()
    base = f"http://127.0.0.1:{http.port}"

    def cmd(name: str, c: str, args: str = "") -> dict:
        return http_call(base, f"/module/{name}/command",
                         {"cmd": c, "args": args})

    def until(pred, what: str, timeout: float = 20.0) -> None:
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                fail(f"phase 27 (d): {what}")
            time.sleep(0.05)
    try:
        app.start()
        r = cmd("Rec", "start", "N,audio")
        if r.get("status") != "ok":
            fail(f"phase 27 (d): recorder start {r}")
        path = r["path"]
        http_call(base, "/pump/step", {"blocks": 4})
        level = float(np.percentile(app.last_spectrum, 2)) + 30.0
        r = [cmd("Scan", "configure", f"level={level:.1f}"),
             cmd("Scan", "start")]
        until(lambda: cmd("Scan", "status")["receiving"],
              "the scanner reported no signal")
        scan = cmd("Scan", "status")
        r.append(cmd("Scan", "stop"))
        if abs(scan["current"] - APP_NFM[0]) > 1e3 or any(
                x.get("status") != "ok" for x in r):
            fail(f"phase 27 (d): scanner {scan}, replies {r}")
        http_call(base, "/pump/step", {"blocks": 4})
        r = cmd("Rec", "stop")
        s = app.modules["S"]
        bm = f"Hi|{app.frequency + 700e3:.0f}|10000|AM|S"
        r = [r, cmd("FM", "add_bookmark", bm),
             cmd("FM", "apply_bookmark", "Hi")]
        if any(x.get("status") != "ok" for x in r) or \
                (s.offset_hz, s.demod_id) != (700e3, 2):
            fail(f"phase 27 (d): bookmark: replies {r}, S at "
                 f"{s.offset_hz} Hz, demod {s.demod_id}")
        r = cmd("Sched", "add", json.dumps({"in": 0.2, "module": "S",
                                           "cmd": "set_demod",
                                           "args": "USB"}))
        until(lambda: s.demod_id == 4 and s.radio.demod_name == "USB",
              f"the scheduled set_demod did not fire ({r})")
        tasks = cmd("Sched", "list")["tasks"]
        http_call(base, "/pump/step", {"blocks": 1})
    finally:
        http.stop()
        app.shutdown()
    until(lambda: not [t for t in threading.enumerate()
                       if t not in before and t.is_alive()],
          "threads left after shutdown: "
          + ", ".join(t.name for t in threading.enumerate()
                      if t not in before), timeout=10.0)
    iq, rate = read_wav_iq(path)
    nfm = tone_snr_db(iq.real[int(0.02 * rate):].astype(np.float64))
    print(f"phase 27 (d): app on {dev} over HTTP: scanner receiving at "
          f"{scan['current']:.0f} Hz (carrier {APP_NFM[0]:.0f}, level "
          f"{level:.1f} dB), bookmark moved S to {s.offset_hz:.0f} Hz AM, "
          f"the scheduled set_demod fired (tasks left {len(tasks)}), the "
          f"recording of N ({iq.shape[0]} frames at {rate:.0f} Hz) tone SNR "
          f"{nfm:.1f} dB (bound 40), no thread left [{card}]")
    if nfm <= 40.0 or rate != 48_000 or tasks:
        fail("phase 27 (d): recorder, rate or scheduler")


# ---- phase 28: the sources, the sinks and the transmitter -------------------
RTL_GAIN_INDEX = 7            # the gain index phase 28 (b) sets
RTL_RT_SECONDS = 5.0          # phase 28 (b)'s run of the threaded pump
RTL_BEHIND_S = 1.0            # its secondsBehind bar
HL2_FS = 384_000              # the Hermes Lite 2's top RX rate
HL2_OFFSET = 50e3             # the NFM carrier in its RX frames
HL2_LOOP = 8064               # lcm(126, 384): the RX loop, continuous
HL2_FREQ = 7_100_000.0
HL2_RX_SECONDS = 1.5          # RX audio before the TX session
HL2_BURST = 16                # the fake HL2's most packets at one wakeup
TX_WIRE_FS = 6000.0
TX_BLOCK = 1200               # a 200 ms wire block
TX_SECONDS = 2.0              # the client's TX tone
TX_BAR_DB = 40.0
TX_MARGIN_DB = 0.5            # the card's TX tone SNR within this of the CPU's
SINK_BLOCKS = 8
SINK_MARGIN_DB = 1.0          # each sink's tone level within this of the WAV's
TX_TAGS = ("K8", "K9", "K12")


def u8_quantize(x: np.ndarray) -> np.ndarray:
    """Complex IQ as rtl_tcp sends it: interleaved uint8, 128 + 128·x
    rounded and clipped."""
    flat = np.empty(2 * x.shape[0], np.float64)
    flat[0::2], flat[1::2] = x.real, x.imag
    return np.clip(np.round(128.0 + 128.0 * flat), 0, 255).astype(np.uint8)


class FakeRtlTcp:
    """An rtl_tcp server on 127.0.0.1 (the protocol of the reference's
    rtl_tcp_client.cpp).  Each connection gets the ``RTL0`` banner (tuner
    type 5, 29 gains), then ``data`` (interleaved uint8) from its start,
    looped, in SR/200-sample chunks paced at ``rate`` samples a second
    (unpaced when None), ``limit`` samples at most; the 5-byte commands
    a connection sends are logged, in order, in ``commands``."""

    def __init__(self, data: np.ndarray, rate, limit=None):
        import socket
        import threading
        self.data = np.ascontiguousarray(data, np.uint8).tobytes()
        self.rate, self.limit = rate, limit
        self.commands: list = []
        self._stop = threading.Event()
        self._conns, self._threads = [], []
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self._spawn(self._accept_loop)

    def _spawn(self, fn, *args):
        import threading
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        import socket
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            cmds: list = []
            self.commands.append(cmds)
            self._conns.append(conn)
            self._spawn(self._read, conn, cmds)
            self._spawn(self._feed, conn)

    def _read(self, conn, cmds):
        import select
        import struct
        buf = b""
        while not self._stop.is_set():
            try:
                ready, _, _ = select.select([conn], [], [], 0.2)
                if not ready:
                    continue
                part = conn.recv(64)
            except (OSError, ValueError):
                return
            if not part:
                return
            buf += part
            while len(buf) >= 5:
                cmds.append(struct.unpack(">BI", buf[:5]))
                buf = buf[5:]

    def _feed(self, conn):
        import struct
        n = max(int((self.rate or FS) // 200), 256)
        data, pos, sent = self.data, 0, 0
        t0 = time.monotonic()
        try:
            conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
            while not self._stop.is_set() and (
                    self.limit is None or sent < self.limit):
                k = n if self.limit is None else min(n, self.limit - sent)
                piece = bytearray()
                while len(piece) < 2 * k:
                    take = min(2 * k - len(piece), len(data) - pos)
                    piece += data[pos:pos + take]
                    pos = (pos + take) % len(data)
                if self.rate:
                    wait = t0 + sent / self.rate - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)
                conn.sendall(bytes(piece))
                sent += k
        except OSError:
            return

    def close(self):
        import socket
        self._stop.set()
        for c in [self.sock] + self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        for t in self._threads:
            t.join(timeout=5)


def ep6_packets(iq: np.ndarray) -> np.ndarray:
    """EP6 packets (Metis header, two 512-byte frames of 63 samples: the
    HL2's RX frames at one receiver, 24-bit big-endian I/Q, zero mic and
    control) of ``iq``, a whole number of packets: [n, 1032] uint8, the
    sequence numbers left 0."""
    from sdrplusplusbrown_tpu_torch.io import hl2_source as hl2
    nf = iq.shape[0] // hl2.SAMPLES_PER_FRAME
    fr = np.zeros((nf, hl2.FRAME_BYTES), np.uint8)
    fr[:, :3] = hl2.SYNC
    body = fr[:, 8:8 + 8 * hl2.SAMPLES_PER_FRAME].reshape(
        nf, hl2.SAMPLES_PER_FRAME, 8)
    z = iq[:nf * hl2.SAMPLES_PER_FRAME].reshape(nf, -1)
    for j, part in enumerate((z.real, z.imag)):
        v = np.round(part * hl2.FULL_SCALE_24).astype(np.int64) & 0xFFFFFF
        body[..., 3 * j] = v >> 16
        body[..., 3 * j + 1] = (v >> 8) & 0xFF
        body[..., 3 * j + 2] = v & 0xFF
    pk = np.zeros((nf // 2, 8 + 2 * hl2.FRAME_BYTES), np.uint8)
    pk[:, :4] = (0xEF, 0xFE, 0x01, 6)
    pk[:, 8:] = fr[:nf // 2 * 2].reshape(nf // 2, -1)
    return pk


class FakeHL2:
    """A Hermes Lite 2 on UDP 127.0.0.1 (openHPSDR protocol 1 as
    ``io/hl2_source.py`` codes it).  It answers discovery; on the Metis
    start command it streams ``iq`` (looped, a whole number of packets)
    in EP6 packets paced at ``rate`` samples a second, and stops on the
    stop command; it answers a RQST'd RX frequency with an ACK in the
    control bytes of the next packet's first frame (the IQ stream runs
    on unbroken); it records every EP2 frame's C0 (``frames``,
    ``mox_frames``), the registers written, and the TX IQ of the MOX
    frames that carry samples (16-bit, in order: ``tx_iq``)."""

    def __init__(self, iq: np.ndarray, rate: float):
        import socket
        import threading
        self.packets = ep6_packets(iq)
        self.rate = float(rate)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.1)
        self.port = self.sock.getsockname()[1]
        self.peer = None
        self.started = threading.Event()
        self.stopped = threading.Event()
        self.lock = threading.Lock()
        self.registers: dict = {}
        self.frames = self.mox_frames = 0
        self.tx_iq: list = []
        self.acked: list = []
        self.max_lag = 0.0            # packets the stream fell behind
        self._ack = None
        self._run = True
        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (self._recv_loop, self._stream_loop)]
        for t in self._threads:
            t.start()

    def _ep2_frame(self, frame):
        import struct
        from sdrplusplusbrown_tpu_torch.io import hl2_source as hl2
        if not (frame[:3] == hl2.SYNC).all():
            return
        c0 = int(frame[3])
        rqst = bool(c0 & 0x80)
        reg = (c0 >> 1) & (0x1F if rqst else 0x3F)
        value = struct.unpack(">I", bytes(frame[4:8]))[0]
        with self.lock:
            self.frames += 1
            self.registers[reg] = value
            if c0 & 1:
                self.mox_frames += 1
                iq = ep2_iq(frame[8:8 + 8 * hl2.SAMPLES_PER_FRAME])
                if iq.any():              # a frame without queued TX IQ
                    self.tx_iq.append(iq)
            if rqst and reg == hl2.REG_RX_FREQ:
                ack = np.zeros(5, np.uint8)
                ack[0] = 0x80 | (hl2.REG_RX_FREQ << 1)
                ack[1:] = np.frombuffer(struct.pack(">I", value), np.uint8)
                self._ack = ack
                self.acked.append(value)

    def _recv_loop(self):
        import socket
        while self._run:
            try:
                raw, addr = self.sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                return
            if len(raw) < 4 or raw[0] != 0xEF or raw[1] != 0xFE:
                continue
            self.peer = addr
            if raw[2] == 0x04:
                if raw[3] & 1:
                    self.stopped.clear()
                    self.started.set()
                else:
                    self.started.clear()
                    self.stopped.set()
            elif raw[2] == 0x01 and raw[3] == 0x02 and len(raw) >= 1032:
                buf = np.frombuffer(raw, np.uint8)
                self._ep2_frame(buf[8:520])
                self._ep2_frame(buf[520:1032])
            elif raw[2] == 0x02:          # discovery: an HL2, gateware 73
                resp = bytearray(60)
                resp[0:3] = b"\xef\xfe\x02"
                resp[3:9] = bytes.fromhex("02aabbccddee")
                resp[9], resp[10], resp[0x13] = 73, 6, 4
                self.sock.sendto(bytes(resp), addr)

    def _stream_loop(self):
        import struct
        per = 2 * 63 / self.rate          # seconds a packet
        n_pk = self.packets.shape[0]
        while self._run:
            if not self.started.wait(0.1):
                continue
            t0, k = time.monotonic(), 0
            while self._run and self.started.is_set():
                # late packets go out at most HL2_BURST at a time, as a
                # device's steady stream would, not in one burst that
                # overruns the host's socket buffer
                due = min(int((time.monotonic() - t0) / per) + 1,
                          k + HL2_BURST)
                self.max_lag = max(self.max_lag, (time.monotonic() - t0)
                                   / per - k)
                while k < due:
                    pk = self.packets[k % n_pk].copy()
                    pk[4:8] = np.frombuffer(struct.pack(">I", k & 0xFFFFFFFF),
                                            np.uint8)
                    with self.lock:
                        ack, self._ack = self._ack, None
                    if ack is not None:
                        pk[11:16] = ack
                    try:
                        self.sock.sendto(pk.tobytes(), self.peer)
                    except OSError:
                        return
                    k += 1
                time.sleep(0.002)

    def results(self) -> dict:
        with self.lock:
            tx = np.concatenate(self.tx_iq) if self.tx_iq else \
                np.zeros(0, np.complex64)
            return {"tx_iq": tx, "frames": self.frames,
                    "mox_frames": self.mox_frames,
                    "registers": dict(self.registers),
                    "acked": list(self.acked),
                    "max_lag": float(self.max_lag),
                    "stopped": self.stopped.is_set()}

    def close(self):
        self._run = False
        for t in self._threads:
            t.join(timeout=5)
        self.sock.close()


def fake_peer_main() -> None:
    """A fake peer as a process of its own: ``python3 -c "import
    chip_smoke; chip_smoke.fake_peer_main()" KIND DATA RATE OUT``, KIND
    ``rtl_tcp`` (DATA: a file of interleaved uint8) or ``hl2`` (DATA: a
    .npy of complex IQ), paced at RATE samples a second.  It prints its
    port, serves until its standard input closes, then writes what it
    logged (the rtl_tcp commands a connection; the HL2's results) to OUT
    as JSON with the TX IQ beside it in OUT.npy."""
    kind, data, rate, out = sys.argv[1:5]
    if kind == "rtl_tcp":
        peer = FakeRtlTcp(np.fromfile(data, np.uint8), float(rate))
    else:
        peer = FakeHL2(np.load(data), float(rate))
    print(peer.port, flush=True)
    sys.stdin.read()
    if kind == "rtl_tcp":
        res = {"commands": [list(map(list, c)) for c in peer.commands]}
    else:
        res = peer.results()
        np.save(out + ".npy", res.pop("tx_iq"))
        res["registers"] = {str(k): v for k, v in res["registers"].items()}
    peer.close()
    with open(out, "w") as f:
        json.dump(res, f)


class FakePeerProcess:
    """``fake_peer_main`` in a subprocess: ``port``, and ``finish()``,
    which closes its input, waits for it and returns what it logged."""

    def __init__(self, kind: str, data: str, rate: float, out: str):
        self.out = out
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             "chip_smoke.fake_peer_main()", kind, data, str(rate), out],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line.strip().isdigit():
            self.finish()
            fail(f"phase 28: the fake {kind} did not start")
        self.port = int(line)

    def finish(self) -> dict:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.proc.stdout.close()
        with open(self.out) as f:
            res = json.load(f)
        if os.path.exists(self.out + ".npy"):
            res["tx_iq"] = np.load(self.out + ".npy")
        return res


def ctone_snr_db(iq: np.ndarray, hz: float, fs: float) -> float:
    """SNR of the complex tone e^{j2π·hz·t} in ``iq`` (a complex fit with
    a DC term), dB."""
    n = iq.shape[0]
    A = np.stack([np.exp(2j * np.pi * hz * np.arange(n) / fs),
                  np.ones(n)], 1)
    coef, *_ = np.linalg.lstsq(A, iq.astype(np.complex128), rcond=None)
    r = iq - A @ coef
    return float(10 * np.log10(np.abs(coef[0]) ** 2
                               / np.mean(np.abs(r) ** 2)))


def hl2_wideband() -> np.ndarray:
    """HL2_LOOP samples at HL2_FS: an NFM carrier at HL2_OFFSET (1 kHz
    tone, 2.5 kHz peak deviation, 0.5 amplitude) in complex noise of
    1e-3; its phase and tone close on whole cycles, so it loops without
    a seam."""
    n = np.arange(HL2_LOOP)
    tone = np.sin(2 * np.pi * TONE_HZ * n / HL2_FS)
    dev = 2500.0 * np.cumsum(tone) / HL2_FS
    dev -= dev.mean()
    rng = np.random.default_rng(29)
    x = 0.5 * np.exp(2j * np.pi * (HL2_OFFSET * n / HL2_FS + dev)) + 1e-3 * (
        rng.standard_normal(HL2_LOOP) + 1j * rng.standard_normal(HL2_LOOP))
    return x.astype(np.complex64)


def tx_wire() -> np.ndarray:
    """TX_SECONDS of a 1 kHz complex tone (0.5) at the 6 kHz wire rate in
    TX_BLOCK blocks."""
    n = int(TX_SECONDS * TX_WIRE_FS)
    t = np.arange(n) / TX_WIRE_FS
    return (0.5 * np.exp(2j * np.pi * TONE_HZ * t)).astype(
        np.complex64).reshape(-1, TX_BLOCK)


def ep2_iq(body: np.ndarray) -> np.ndarray:
    """The TX IQ of an EP2 frame's sample groups (8 bytes a sample,
    16-bit big-endian I and Q at bytes 4..7), as the device decodes it."""
    b = body.reshape(-1, 8).astype(np.int32)
    re = ((b[:, 4] << 8) | b[:, 5]).astype(np.uint16).astype(np.int16)
    im = ((b[:, 6] << 8) | b[:, 7]).astype(np.uint16).astype(np.int16)
    return (re / 32767.0 + 1j * (im / 32767.0)).astype(np.complex64)


def i16_round_trip(iq: np.ndarray) -> np.ndarray:
    """TX IQ through the HL2's 16-bit frame codec at full power
    (``encode_tx_samples``, then the device's decode)."""
    from sdrplusplusbrown_tpu_torch.io import hl2_source as hl2
    k = hl2.SAMPLES_PER_FRAME
    buf = np.zeros(8 * k, np.uint8)
    out = []
    for i in range(0, iq.shape[0] // k * k, k):
        hl2.encode_tx_samples(buf, iq[i:i + k], 1.0)
        out.append(ep2_iq(buf))
    return np.concatenate(out) if out else np.zeros(0, np.complex64)


def open_sockets() -> int:
    """Sockets this process holds open (its /proc/self/fd)."""
    n = 0
    for fd in os.listdir("/proc/self/fd"):
        try:
            n += os.readlink(f"/proc/self/fd/{fd}").startswith("socket:")
        except OSError:
            pass
    return n


def drive_trx(dev, card: str, report: dict) -> None:
    """Phase 28: the sources, the sinks and the transmitter.  (a) K8, K9
    and K12 at the TX path's shapes against their plain versions, and the
    TX path with the counts zeroed; (b) phase 19's app on an rtl_tcp
    source (a fake server process); (c) the app on a Hermes Lite 2 (a
    fake on UDP, a process of its own): RX, then TX from a stream
    client's backchannel after rigctl ``T 1``; (d) the network and MPEG
    sinks; (e) no thread or socket left."""
    import tempfile
    import threading
    t0 = time.perf_counter()
    threads, socks = set(threading.enumerate()), open_sockets()
    tx_kernels(dev, card, report)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trx_") as tmp:
        cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024"
                                ".wav")
        served_capture(cap)
        rtl_tcp_app(dev, card, tmp, cap)
        t2 = time.perf_counter()
        hl2_app(dev, card, tmp)
        t3 = time.perf_counter()
        sinks_app(dev, card, tmp, cap)
    t4 = time.perf_counter()
    deadline = time.monotonic() + 15
    while True:
        left = [t for t in threading.enumerate()
                if t not in threads and t.is_alive()]
        n_socks = open_sockets()
        if (not left and n_socks <= socks) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    print(f"phase 28 (e): after every app's shutdown {len(left)} new "
          f"threads, {n_socks} sockets open (before (a): {socks})")
    if left or n_socks > socks:
        fail("phase 28 (e): left behind: " + ", ".join(
            t.name for t in left) + f"; sockets {n_socks} > {socks}")
    print(f"phase 28: {t4 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}"
          f", (c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}) [{card}]")


def tx_kernels(dev, card: str, report: dict) -> None:
    """(a): the TX path on the card, the counts zeroed just before:
    ``TxChain`` USB (K12, then ``SSBMod``'s 651 complex taps on K9) and
    FM (K12) on 1 s of audio at 48 kHz, then ``ServerTxPath`` on ten
    200 ms wire blocks (K8 a block); every other kernel not launched; the
    USB output single-sideband (the upper half >= 30 dB over the lower,
    tests/test_tx.py's oracle), the FM output on the unit circle, the
    ServerTxPath packets against the same path on the host CPU.  Then K8
    at the resampler's 200 ms block, K9 at SSBMod's 48 000 samples and
    K12 at TxChain's 48 000-sample AGC against their plain versions on
    the captured inputs, each timed (device µs a call) beside its bound
    and conv1d's time (K12's plain loop, ~13 s a call on the card, timed
    by its one comparison call)."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import trx
    from sdrplusplusbrown_tpu_torch.runtime.block import to_device
    fs = 48_000.0
    t = np.arange(int(fs)) / fs
    audio = (0.3 * np.sin(2 * np.pi * TONE_HZ * t)
             + 0.1 * np.sin(2 * np.pi * 1900.0 * t)).astype(np.float32)
    wire = np.concatenate([tx_wire()] * 3)[:10]

    def tx_path(device) -> np.ndarray:
        lb = trx.LoopbackTransmitter()
        path = trx.ServerTxPath(lb, device=device)
        for blk in wire:
            path.push_wire_block(blk)
        return np.concatenate(lb.blocks)

    def run():
        out = {}
        for mode in ("USB", "FM"):
            ch = trx.TxChain(mode)
            st = to_device(ch.init_state(()), dev)
            y, _ = ch.apply(None, st, torch.from_numpy(audio).to(dev))
            out[mode] = y.cpu().numpy()
        out["tx"] = tx_path(dev)
        return out
    reset_counts()
    with no_plain_on_card():
        got, caps = capture(TX_TAGS, run)
    torch.cuda.synchronize()
    n = {tg: kernel_count(tg) for tg in KERNELS}
    hold_launches("phase 28 (a), TX path", {tg: n[tg] for tg in TX_TAGS},
                  caps)
    want = {"K8": len(wire), "K9": 1, "K12": 2}
    if any(n[tg] != want.get(tg, 0) for tg in KERNELS):
        fail(f"phase 28 (a): TX path launch pattern "
             f"{ {tg: c for tg, c in n.items() if c} }, want {want}")
    path_label = (f"TX path (TxChain USB + FM on 1 s, ServerTxPath "
                  f"{len(wire)} wire blocks)")
    for tg in TX_TAGS:
        report.setdefault(tg, {}).setdefault("launches_by_path", {})[
            path_label] = n[tg]
    agree = np_snr_db(tx_path("cpu"), got["tx"])
    spec = np.abs(np.fft.fft(got["USB"][len(audio) // 2:])) ** 2
    side = 10 * np.log10(spec[1:len(spec) // 2].sum()
                         / spec[len(spec) // 2 + 1:].sum())
    unit = float(np.abs(np.abs(got["FM"]) - 1.0).max())
    print(f"phase 28 (a): TX path on the card: USB upper sideband {side:.1f}"
          f" dB over the lower (bound 30), FM ||y| - 1| <= {unit:.2e}, "
          f"ServerTxPath's packets {agree:.1f} dB to the host CPU's (bound "
          f"80); launches K8 {n['K8']}, K9 {n['K9']}, K12 {n['K12']} "
          f"[{card}]")
    if side < 30.0 or unit > 1e-5 or agree < 80.0:
        fail("phase 28 (a): the TX path's oracles")
    shapes = (("K8", caps["K8"][0], f"ServerTxPath 6 k -> 48 k, a "
               f"{TX_BLOCK}-sample wire block"),
              ("K9", caps["K9"][0], "SSBMod, 651 complex taps on 48 000 "
               "samples"),
              ("K12", caps["K12"][0], "TxChain's AGC on 48 000 samples"))
    for tg, call, what in shapes:
        r = check_app_kernel(tg, call, card, f"phase 28 (a), {what}",
                             plain_reps=0 if tg == "K12" else 20)
        entry = report.setdefault(tg, {})
        entry["max_abs_err"] = max(entry.get("max_abs_err", 0.0),
                                   r["max_abs_err"])
        if tg == "K12":
            k12_floor(call, what, card)


def rtl_tcp_app(dev, card: str, tmp: str, cap: str) -> None:
    """(b): phase 19's capture quantized to uint8 and served by a fake
    rtl_tcp process paced at 2.4 MS/s.  Manual pump: the app on the
    ``rtl_tcp`` source, SERVED_BLOCKS blocks, every radio's audio and
    every spectrum line bit-identical to the same app on a file of the
    quantized samples; the commands the server logged: sample rate,
    frequency, gain mode and gain index.  Then the threaded pump for
    RTL_RT_SECONDS on a new connection: block p50 / p99 and
    secondsBehind (< RTL_BEHIND_S)."""
    import torch
    from sdrplusplusbrown_tpu_torch.io.network_source import (RtlTcpSource,
                                                              _u8_iq)
    from sdrplusplusbrown_tpu_torch.io.wav import read_wav_iq, write_wav
    x, _ = read_wav_iq(cap)
    u8 = u8_quantize(x)
    raw = os.path.join(tmp, "capture.u8")
    u8.tofile(raw)
    qcap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024_u8"
                             ".wav")
    write_wav(qcap, _u8_iq(u8.tobytes()), FS, bits=32)
    peer = FakePeerProcess("rtl_tcp", raw, FS, os.path.join(tmp, "rtl.json"))
    try:
        def run(conf, gains: bool):
            app = new_app(os.path.join(tmp, f"p28b_{len(runs)}"), conf, dev)
            if gains:
                app.source.set_gain_mode(True)
                app.source.set_gain_index(RTL_GAIN_INDEX)
            got = {n: [] for n in app.modules}
            for nm, m in app.modules.items():
                m.audio_event.bind(lambda b, nm=nm: got[nm].append(b))
            lines = []
            app.spectrum_event.bind(lambda s: lines.append(s.copy()))
            app.modules["Q"].handle_debug_command("set_squelch",
                                                  f"{SQUELCH_DB}")
            app.start()
            try:
                for _ in range(SERVED_BLOCKS):
                    if app.pump_step(1) != 1:
                        fail("phase 28 (b): the pump stopped")
                torch.cuda.synchronize()
            finally:
                app.shutdown()
            return {n: np.concatenate(v, axis=-1) for n, v in got.items()}, \
                np.stack(lines)
        runs: list = []
        conf = served_config(qcap, "manual")
        runs.append(run(conf, False))
        conf["source"] = {"type": "rtl_tcp", "host": "127.0.0.1",
                          "port": peer.port, "samplerate": FS}
        runs.append(run(conf, True))
        same = all(np.array_equal(runs[0][0][n], runs[1][0][n])
                   for n in runs[0][0]) and np.array_equal(runs[0][1],
                                                           runs[1][1])
        lens = ", ".join(f"{n} {v.shape[-1]}" for n, v in runs[1][0].items())
        print(f"phase 28 (b): app on rtl_tcp (uint8 at {FS / 1e6:g} MS/s, "
              f"paced), {SERVED_BLOCKS} blocks: every radio's audio "
              f"({lens} samples) and {runs[1][1].shape[0]} spectrum lines "
              + ("bit-identical" if same else "DIFFERENT")
              + f" to the file-fed app on the quantized samples [{card}]")
        if not same:
            fail("phase 28 (b): the rtl_tcp app differs from the file-fed "
                 "app")
        run_rt = pump_in_real_time(dev, card, os.path.join(tmp, "p28b_rt"),
                                   {**conf, "pump": "thread"},
                                   "phase 28 (b), rtl_tcp",
                                   RTL_RT_SECONDS)
        w = run_rt["w"]
        behind = run_rt["status"]["secondsBehind"]
        print(f"phase 28 (b): threaded pump on rtl_tcp, block p50 "
              f"{np.percentile(w, 50):.4f} ms, p99 {np.percentile(w, 99):.4f}"
              f" ms (paced by the source: a block waits for its samples), "
              f"secondsBehind {behind} (bound {RTL_BEHIND_S}) [{card}]")
        if behind >= RTL_BEHIND_S:
            fail("phase 28 (b): secondsBehind over its bound")
    finally:
        log = peer.finish()
    C = RtlTcpSource
    want = [[C.CMD_SAMPLERATE, int(FS)], [C.CMD_FREQ, 100_000_000],
            [C.CMD_GAIN_MODE, 1], [C.CMD_GAIN_INDEX, RTL_GAIN_INDEX]]
    cmds = log["commands"]
    print(f"phase 28 (b): the server logged {len(cmds)} connections, the "
          f"manual app's commands {cmds[0] if cmds else None}")
    if len(cmds) != 2 or cmds[0] != want or cmds[1] != want[:2]:
        fail(f"phase 28 (b): commands {cmds}, want {want} then {want[:2]}")


def hl2_app(dev, card: str, tmp: str) -> None:
    """(c): the app on a Hermes Lite 2 (a fake on UDP, a process of its
    own) at HL2_FS with the pump thread, an NFM radio on the carrier in
    its RX frames (tone SNR > 40 dB); with the stream server and rigctl
    in process: rigctl ``T 1``, a stream client sends TX_SECONDS of a
    1 kHz tone at the 6 kHz wire rate in 200 ms blocks, paced; the fake
    receives the TX IQ at 48 kHz in its MOX frames: tone SNR > TX_BAR_DB
    and within TX_MARGIN_DB of the host CPU's TX path on the same wire
    blocks (through the same 16-bit codec); ``t`` answers 1."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import trx
    from sdrplusplusbrown_tpu_torch.server.rigctl import RigctlServer
    from sdrplusplusbrown_tpu_torch.server.rigctl_client import RigctlClient
    from sdrplusplusbrown_tpu_torch.server.stream_client import StreamClient
    from sdrplusplusbrown_tpu_torch.server.stream_server import StreamServer
    data = os.path.join(tmp, "hl2.npy")
    np.save(data, hl2_wideband())
    peer = FakePeerProcess("hl2", data, HL2_FS, os.path.join(tmp, "hl2.json"))
    conf = {"source": {"type": "hl2", "host": "127.0.0.1",
                       "port": peer.port, "samplerate": HL2_FS},
            "frequency": HL2_FREQ, "fftSize": 8192, "fftRate": 20,
            "modules": {"N": {"type": "radio", "demod": "NFM",
                              "offset": HL2_OFFSET}}}
    audio, wire_in = [], []
    ptt = None
    try:
        app = new_app(os.path.join(tmp, "p28c"), conf, dev, run_pump=True)
        srv = rig = cli = rc = None
        try:
            if app.transmitter is not app.source:
                fail("phase 28 (c): the HL2 source is not the transmitter")
            app.modules["N"].audio_event.bind(audio.append)
            srv = StreamServer(app, port=0, host="127.0.0.1")
            orig = srv.tx_path.push_wire_block

            def recorded(iq):
                wire_in.append(np.array(iq))
                orig(iq)
            srv.tx_path.push_wire_block = recorded
            srv.start()
            rig = RigctlServer(app, port=0)
            rig.start()
            with settled_heap():      # no collection pause drops RX frames
                app.start()
                time.sleep(HL2_RX_SECONDS)
                torch.cuda.synchronize()
                n_rx = sum(a.shape[-1] for a in audio)
                rc = RigctlClient("127.0.0.1", rig.port)
                if not rc.set_ptt(True):
                    fail("phase 28 (c): rigctl T 1 refused")
                cli = StreamClient("127.0.0.1", srv.port)
                t0 = time.monotonic()
                for i, blk in enumerate(tx_wire()):
                    cli.transmit(blk)
                    wait = t0 + (i + 1) * TX_BLOCK / TX_WIRE_FS \
                        - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)
                time.sleep(1.0)   # the prebuffer, then the pacer drains
                ptt = rc.get_ptt()
                rc.set_ptt(False)
        finally:
            for c in (cli, rc):
                if c is not None:
                    c.close()
            for s in (rig, srv):
                if s is not None:
                    s.stop()
            app.shutdown()
    finally:
        res = peer.finish()
    rx = np.concatenate(audio, axis=-1)
    rx_snr = tone_snr_db(rx[0, n_rx - 24_000:n_rx].astype(np.float64)) \
        if n_rx > 48_000 else -1.0
    lb = trx.LoopbackTransmitter()
    path = trx.ServerTxPath(lb, device="cpu")
    for blk in wire_in:
        path.push_wire_block(blk)
    cpu_tx = i16_round_trip(np.concatenate(lb.blocks))
    got = res["tx_iq"]
    skip = 4800                        # the resampler's onset, 100 ms
    n = min(len(got), len(cpu_tx))
    snr = ctone_snr_db(got[skip:n], TONE_HZ, 48_000.0) if n > 2 * skip \
        else -1.0
    ref = ctone_snr_db(cpu_tx[skip:n], TONE_HZ, 48_000.0) if n > 2 * skip \
        else -1.0
    agree = np_snr_db(cpu_tx[:n], got[:n]) if n else -1.0
    print(f"phase 28 (c): app on the HL2 at {HL2_FS} S/s, pump thread: "
          f"{n_rx} samples of NFM audio in {HL2_RX_SECONDS} s, tone SNR "
          f"{rx_snr:.1f} dB (bound 40) [{card}]")
    print(f"phase 28 (c): TX: {len(wire_in)} wire blocks through the "
          f"server's ServerTxPath (K8 on {dev}), the fake received "
          f"{len(got)} samples at 48 kHz in {res['mox_frames']} MOX frames "
          f"of {res['frames']}; tone SNR {snr:.1f} dB (bound {TX_BAR_DB:g}), "
          f"the host CPU's path {ref:.1f} dB (margin {TX_MARGIN_DB}), the "
          f"two streams agree to {agree:.1f} dB; rigctl t answered {ptt}; "
          f"RQST'd frequencies acked {res['acked'][:3]} [{card}]")
    if rx_snr <= 40.0:
        fail("phase 28 (c): the HL2 RX tone")
    if len(wire_in) != len(tx_wire()) or snr <= TX_BAR_DB or \
            abs(snr - ref) > TX_MARGIN_DB or not res["mox_frames"] or \
            ptt is not True or not res["stopped"]:
        fail("phase 28 (c): the TX path through the HL2")


def sinks_app(dev, card: str, tmp: str, cap: str) -> None:
    """(d): phase 19's capture, manual pump, three NFM radios on the 1
    kHz carrier: "R" to the recorder, "U" to the network sink (UDP int16
    to a local listener), "M" to the MPEG sink (TCP to a local
    listener).  The network sink's tone level within SINK_MARGIN_DB of
    the recording's; the MPEG stream byte-identical to M's audio
    encoded on the host, and its tone, decoded with the sink's own Layer
    I parser and synthesis bank, within SINK_MARGIN_DB of the recording
    through the same encoder and decoder (the Layer I codec, not the
    transport, sets its level and noise)."""
    import socket
    import threading
    from sdrplusplusbrown_tpu_torch.io import mpeg_sink
    from sdrplusplusbrown_tpu_torch.io.wav import read_wav_iq
    mods = {k: {"type": "radio", "demod": "NFM", "offset": APP_NFM[0]}
            for k in ("R", "U", "M")}
    conf = {"source": {"type": "file", "path": cap, "loop": True},
            "fftSize": FFT, "fftRate": 20, "pump": "manual",
            "modules": mods}
    udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    udp.bind(("127.0.0.1", 0))
    udp.settimeout(0.5)
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    lst.settimeout(10)
    got_udp, got_tcp = [], bytearray()

    def tcp_rx():
        try:
            conn, _ = lst.accept()
        except OSError:
            return
        conn.settimeout(10)
        with conn:
            while True:
                try:
                    b = conn.recv(65536)
                except OSError:
                    return
                if not b:
                    return
                got_tcp.extend(b)
    th = threading.Thread(target=tcp_rx, daemon=True)
    th.start()
    app = new_app(os.path.join(tmp, "p28d"), conf, dev)
    m_audio = []
    app.modules["M"].audio_event.bind(m_audio.append)
    try:
        ok = [app.select_sink("R", "recorder"),
              app.select_sink("U", "network", host="127.0.0.1",
                              port=udp.getsockname()[1], protocol="udp"),
              app.select_sink("M", "mpeg", host="127.0.0.1",
                              port=lst.getsockname()[1])]
        if not all(ok):
            fail(f"phase 28 (d): select_sink {ok}")
        app.start()
        for _ in range(SINK_BLOCKS):
            if app.pump_step(1) != 1:
                fail("phase 28 (d): the pump stopped")
        sent = app.sinks["U"].samples_sent
        while sum(len(p) for p in got_udp) < 2 * sent:
            try:
                got_udp.append(udp.recv(65536))
            except socket.timeout:
                break
        wav = app.sinks["R"].path
    finally:
        app.shutdown()
        th.join(timeout=10)
        udp.close()
        lst.close()
    iq, rate = read_wav_iq(wav)
    skip = int(0.02 * rate)
    rec = iq.real.astype(np.float64)
    net = np.frombuffer(b"".join(got_udp), "<i2") / 32768.0

    def decode(data: bytes) -> np.ndarray:
        fb = mpeg_sink.MpegL1Encoder(48_000, 288).frame_bytes
        syn, out = mpeg_sink._Synthesis(), [np.zeros(0)]
        for f in range(len(data) // fb):
            out.append(syn.push(mpeg_sink.mpeg_l1_decode_frame(
                data[f * fb:(f + 1) * fb], fb)[1]))
        return np.concatenate(out)
    m_mono = np.concatenate(m_audio, axis=-1).mean(axis=0)
    exact = bytes(got_tcp) == mpeg_sink.MpegL1Encoder(48_000, 288).encode(
        m_mono)
    rows = {"recorder": rec, "network": net, "mpeg": decode(bytes(got_tcp)),
            "recorder via Layer I": decode(mpeg_sink.MpegL1Encoder(
                48_000, 288).encode(rec.astype(np.float32)))}
    lv = {k: tone_level_db(v[skip:]) for k, v in rows.items()}
    sn = {k: tone_snr_db(v[skip:]) for k, v in rows.items()}
    print(f"phase 28 (d): {SINK_BLOCKS} blocks; samples "
          + ", ".join(f"{k} {v.shape[0]}" for k, v in rows.items())
          + f"; the MPEG stream ({len(got_tcp)} bytes) "
          + ("byte-identical" if exact else "DIFFERENT")
          + " to M's audio encoded on the host; tone level dB "
          + ", ".join(f"{k} {v:.2f}" for k, v in lv.items())
          + "; tone SNR dB " + ", ".join(f"{k} {v:.1f}" for k, v in
                                         sn.items()) + f" [{card}]")
    if rate != 48_000 or min(net.shape[0], rows["mpeg"].shape[0]) < \
            0.2 * rate or not exact or \
            abs(lv["network"] - lv["recorder"]) > SINK_MARGIN_DB or \
            abs(lv["mpeg"] - lv["recorder via Layer I"]) > SINK_MARGIN_DB:
        fail("phase 28 (d): a sink's tone is not the recording's")



# ---- phase 29: the digital decoders -----------------------------------------
M17_DST, M17_SRC = "SP5WWP", "N0CALL"
M17_FRAMES = 14               # stream frames after the preamble
KG_PAYLOADS = (b"\x07" * 6, b"\xa5" * 6)
RYFI_PACKETS = (b"hello ryfi over the air", bytes(range(256)) * 3)


def _shaped(symbols: np.ndarray, baud: float, fs: float, beta: float,
            taps: int) -> np.ndarray:
    """``symbols`` (one a symbol) through the port's RRCInterpolator on the
    host CPU: complex64 at ``fs``."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops.mod import RRCInterpolator
    sh = RRCInterpolator(baud, fs, beta=beta, tap_count=taps)
    g = sh.in_multiple
    n = -(-len(symbols) // g) * g
    x = np.zeros(n, np.complex64)
    x[:len(symbols)] = symbols
    y, _ = sh.apply(None, sh.init_state(()), torch.from_numpy(x))
    return y.numpy()


def m17_signal(fs: float, frames: int = M17_FRAMES) -> tuple:
    """tests/test_m17.py's station at ``fs``: a preamble of outer-level
    toggles, ``frames`` stream frames (frame n's payload 16 bytes of n)
    with the LSF (M17_DST, M17_SRC) in their LICH, a tail; 4FSK RRC
    frequency pulses (β 0.5) into the FM modulator (2 400 Hz), at phase
    0.7.  (iq, payloads {fn: bytes}).  The demod settles over the first
    two frames (their magnitude bits), in the JAX package as in the
    port: frames 2 on decode (tests/test_m17.py holds 12 of 14)."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import m17 as M
    from sdrplusplusbrown_tpu_torch.ops.mod import QuadratureMod
    segs = M.build_lich(M.encode_lsf(M17_DST, M17_SRC, type_word=0b101))
    bits, payloads = [np.tile([0, 1], 600)], {}
    for fn in range(frames):
        payloads[fn] = bytes([fn] * 16)
        bits.append(M.build_stream_frame(segs[fn % 6], fn, payloads[fn]))
    bits.append(np.tile([0, 1], 400))
    sym = M.bits_to_symbols(np.concatenate(bits))
    shaped = _shaped(sym.astype(np.complex64), M.M17_BAUDRATE, fs, 0.5, 31)
    fm = QuadratureMod(M.M17_DEVIATION, fs)
    iq, _ = fm.apply(None, fm.init_state(()),
                     torch.from_numpy(shaped.real.copy()))
    return (iq.numpy() * np.exp(1j * 0.7)).astype(np.complex64), payloads


def kg_sstv_signal(fs: float, rng) -> np.ndarray:
    """tests/test_dab_kgsstv.py's KG-SSTV burst at ``fs``: random symbols,
    then each of KG_PAYLOADS's frames after 40 random symbols, 300 more;
    rectangular NRZ into FM at ±300 Hz, at phase 0.3."""
    from sdrplusplusbrown_tpu_torch.models import kg_sstv as K
    stream = np.concatenate(
        [np.concatenate([2.0 * rng.integers(0, 2, 40).astype(np.float32)
                         - 1.0, K.build_frame_symbols(p)])
         for p in KG_PAYLOADS]
        + [2.0 * rng.integers(0, 2, 300).astype(np.float32) - 1.0])
    sps = fs / K.KGSSTV_BAUD
    n_out = int(len(stream) * sps)
    sidx = np.minimum((np.arange(n_out) / sps).astype(np.int64),
                      len(stream) - 1)
    phase = 2 * np.pi * np.cumsum(stream[sidx].astype(np.float64)) \
        * K.KGSSTV_DEVIATION / fs
    return np.exp(1j * (phase + 0.3)).astype(np.complex64)


def ryfi_signal(baud: float, fs: float, packets, rng,
                idle: int = 3000) -> np.ndarray:
    """tests/test_ryfi.py's link at ``fs``: idle noise symbols, the
    packets' frames (``transmit_packets``), idle; RRC β 0.6 (31 taps), 80 Hz
    off at phase 0.5."""
    from sdrplusplusbrown_tpu_torch.models import ryfi as R
    pad = (rng.standard_normal(idle) + 1j * rng.standard_normal(idle)) \
        * 0.05
    sym = np.concatenate([pad, R.transmit_packets(list(packets)), pad])
    tx = _shaped(sym.astype(np.complex64), baud, fs, 0.6, 31)
    n = np.arange(len(tx))
    return (tx * np.exp(1j * (2 * np.pi * 80.0 * n / fs + 0.5))
            ).astype(np.complex64)


def meteor_symbols(kind: str, n: int, rng) -> np.ndarray:
    """``n`` Meteor symbols: QPSK (on the ±45° grid; ``oqpsk`` the same
    symbols), or on the "broken" modulator's four phases."""
    from sdrplusplusbrown_tpu_torch.models.meteor import BROKEN_PHASES
    if kind == "broken":
        return np.exp(1j * np.asarray(BROKEN_PHASES)[rng.integers(0, 4, n)]
                      ).astype(np.complex64)
    return np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n))
                  ).astype(np.complex64)


def meteor_signal(kind: str, fs: float, sym: np.ndarray) -> np.ndarray:
    """tests/test_decoders_wave1.py's Meteor carrier at ``fs`` (72 k
    sym/s, RRC β 0.6, 33 taps, half amplitude, 40 Hz off at phase 0.3);
    ``oqpsk``: I and Q shaped apart, Q one output sample late."""
    if kind == "oqpsk":
        ii = _shaped(sym.real.astype(np.complex64), 72_000.0, fs, 0.6,
                     33).real
        qq = _shaped(sym.imag.astype(np.complex64), 72_000.0, fs, 0.6,
                     33).real
        return ((ii[:-1] + 1j * qq[1:]) * 0.5).astype(np.complex64)
    iq = _shaped(sym, 72_000.0, fs, 0.6, 33) * 0.5
    n = np.arange(len(iq))
    return (iq * np.exp(1j * (2 * np.pi * 40.0 * n / fs + 0.3))
            ).astype(np.complex64)


def qpsk_decisions(soft: np.ndarray, sent: np.ndarray, skip: int,
                   min_len: int = 1000) -> tuple:
    """(symbols compared, errors) of QPSK decisions of ``soft`` past its
    first ``skip`` symbols against the ``sent`` symbols, at the rotation
    (of four) and the lag (within ±80 symbols) with the fewest errors a
    symbol over at least ``min_len`` symbols; (0, 0) where none is that
    long."""
    def dibit(s):
        return (np.real(s) < 0).astype(int) * 2 + (np.imag(s) < 0)
    tail, best = soft[skip:], (0, 0)
    for k in range(4):
        got = dibit(tail * np.exp(1j * np.pi / 2 * k))
        for lag in range(max(-80, -skip), 81):
            want = dibit(sent[skip + lag:skip + lag + len(got)])
            m = min(len(want), len(got))
            if m < min_len:
                continue
            err = int((got[:m] != want[:m]).sum())
            if best[0] == 0 or err / m < best[1] / best[0]:
                best = (m, err)
    return best


def broken_deviation_deg(soft: np.ndarray, skip: int) -> float:
    """The median distance, in degrees, of ``soft`` past ``skip`` from the
    nearest of the broken modulator's four phases (the JAX test's bar: 25;
    an unlocked loop sits near 41)."""
    from sdrplusplusbrown_tpu_torch.models.meteor import BROKEN_PHASES
    ang = np.angle(soft[skip:])
    dev = np.min(np.abs(((ang[:, None] - np.asarray(BROKEN_PHASES)[None]
                          + np.pi) % (2 * np.pi)) - np.pi), axis=1)
    return float(np.rad2deg(np.median(dev)))



DEC_FS = FS                   # the served capture's rate
DEC_SECONDS = 0.8             # its length
DEC_NOISE = 0.005
DEC_M17 = -200e3              # the carriers' offsets
DEC_KG = 100e3
DEC_RYFI = 600e3
DEC_RYFI_AT = 0.0             # the RyFi burst's start, s: with the capture,
                              # as a link that is up (after 0.3 s of noise
                              # alone the Costas loop has wandered off and
                              # the burst is not acquired: the JAX loop's
                              # behaviour too)
DEC_METEOR = {"Meteor": (-800e3, "qpsk"), "MeteorB": (-500e3, "broken")}
DEC_METEOR_SYMS = 7200        # 0.1 s at 72 k sym/s
DEC_METEOR_SKIP = 3000        # symbols to lock (tests/test_decoders_wave1)
DEC_TAGS = ("K4f", "K8", "K12c", "K13b", "K13c", "K13m", "K16")
DEC_CPU_BLOCKS = 2            # the Meteor modules' blocks on the host CPU
DEC_METEOR_T = 15_000         # a Meteor module's 0.1 s block at 150 kS/s
DEC_RYFI_T = 72_000           # RyFi's 0.1 s block at its 720 kS/s channel
RYFI_FULL = (720_000.0, 1_500_000.0)   # (c): the module's defaults
RYFI_FULL_SECONDS = 2.1
RYFI_FULL_PACKET = 1000       # bytes a packet


def drive_decoders(dev, card: str, report: dict) -> None:
    """Phase 29: (a) the decoders' kernels against their plain versions
    and the digital demods' blocks on the card; (b) the served app
    decoding M17, KG-SSTV, RyFi and Meteor; (c) RyFi at its default
    rate."""
    import tempfile
    t0 = time.perf_counter()
    decoder_kernels(dev, card, report)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dec_") as tmp:
        decoders_app(dev, card, report, tmp)
    t2 = time.perf_counter()
    ryfi_full_rate(dev, card)
    t3 = time.perf_counter()
    print(f"phase 29: {t3 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}"
          f", (c) {t3 - t2:.1f}) [{card}]")


def viterbi_frames(R: int, N: int, code, hard: bool, seed: int):
    """R frames of N trellis steps as K16 takes them: random data encoded,
    flipped 5 % (hard) or in noise (soft, σ 0.3), clipped to [0, 1]."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops import fec
    g1, g2, k = code
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(R):
        c = fec.conv_encode(rng.integers(0, 2, N - (k - 1)), g1, g2,
                            k).astype(np.float32)
        if hard:
            idx = rng.choice(len(c), len(c) // 20, replace=False)
            c[idx] = 1.0 - c[idx]
        else:
            c = np.clip(c + 0.3 * rng.standard_normal(len(c)), 0.0, 1.0)
        rows.append(c.astype(np.float32))
    return torch.from_numpy(np.stack(rows))


def decoder_kernels(dev, card: str, report: dict) -> None:
    """(a): K16 at its callers' frames (and K = 3 and K = 9 frames: both
    of its forms) and K13f at 20 000 samples, each against its plain
    version (bit-identical), timed (K13b is timed in (b),
    on the served block); then ``FDClockRecovery``, ``FourFSKDemod`` and ``Pi4DQPSKDemod`` on
    the card, the counts zeroed before each, two blocks each: K13f (FD),
    K8, K12c and K13m launched, nothing else; their outputs finite."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import kg_sstv, m17, ryfi
    from sdrplusplusbrown_tpu_torch.ops import clock_recovery, fec
    from sdrplusplusbrown_tpu_torch.ops.demod_digital import (
        FourFSKDemod, Pi4DQPSKDemod)
    from sdrplusplusbrown_tpu_torch.runtime.block import to_device
    m17c = (m17.CONV_G1, m17.CONV_G2, m17.CONV_K)
    kgc = (kg_sstv.CONV_G1, kg_sstv.CONV_G2, kg_sstv.CONV_K)
    ryc = (ryfi.CONV_G1, ryfi.CONV_G2, ryfi.CONV_K)
    # beside the callers' frames, a D-STAR header (K = 3, the warp form's
    # fewest states) and a K = 9 frame (the block form), so that both of
    # K16's forms are held on every run
    cases = (("M17 LSF", 1, 244, m17c), ("M17 stream", 1, 148, m17c),
             ("KG-SSTV frame", 1, 54, kgc),
             ("RyFi, 9 frames", 9, ryfi.FRAME_SYMS, ryc),
             ("D-STAR header (K = 3)", 1, 330, (0b111, 0b101, 3)),
             ("K = 9, 3 frames", 3, 300, (0o561, 0o753, 9)))
    for label, R, N, code in cases:
        for hard in (True, False):
            soft = viterbi_frames(R, N, code, hard, N + hard).to(dev)
            out = check_loop_kernel(
                "K16", (soft, *code), card,
                f"{label}, {'hard' if hard else 'soft'}", timed=not hard,
                plain_calls=0)
            if label.startswith("RyFi") and not hard:
                report["K16"] = out
            elif "K16" in report:
                report["K16"]["max_abs_err"] = max(
                    report["K16"]["max_abs_err"], out["max_abs_err"])
    rng = np.random.default_rng(29)
    # K13f: FDClockRecovery on 20 000 samples of BPSK at 10 a symbol
    fd = clock_recovery.FDClockRecovery(10.0)
    bits = 1.0 - 2.0 * rng.integers(0, 2, 2100)
    y = (_shaped(bits.astype(np.complex64), 4800.0, 48_000.0, 0.35,
                 31).real[:20_000]
         + 0.02 * rng.standard_normal(20_000)).astype(np.float32)
    st = to_device(fd.init_state((1,)), dev)
    report["K13f"] = check_loop_kernel(
        "K13f", (fd, torch.from_numpy(y)[None].to(dev), st), card,
        "FDClockRecovery, 20 000 samples", timed=True, plain_calls=0)
    # the demods' blocks with the counts zeroed (K13f's launches: FD's)
    blocks = (
        ("FDClockRecovery(10)", fd, torch.from_numpy(y[:10_000]).to(dev),
         {"K13f": 2}),
        ("FourFSKDemod(4800, 48 kS/s)", FourFSKDemod(4800.0, 48_000.0,
                                                    2400.0),
         torch.from_numpy(fsk4_signal(9600, rng)).to(dev),
         {"K8": 2, "K13m": 2}),
        ("Pi4DQPSKDemod(18 k, 72 kS/s)", Pi4DQPSKDemod(18_000.0, 72_000.0),
         torch.from_numpy(pi4_signal(14_400, rng)).to(dev),
         {"K8": 2, "K12c": 2, "K13m": 2}))
    for label, dem, xb, want in blocks:
        st = to_device(dem.init_state(()), dev)
        half = xb.shape[-1] // 2
        reset_counts()
        with no_plain_on_card():
            outs = []
            for b in range(2):
                out, st = dem.apply(None, st, xb[b * half:(b + 1) * half])
                outs.append(out)
            torch.cuda.synchronize()
        counts = {t: kernel_count(t) for t in KERNELS if kernel_count(t)}
        ok = all(torch.isfinite(o[0]).all() for o in outs)
        nsym = sum(int(o[-1].sum()) for o in outs)
        print(f"phase 29 (a): {label} on {dev}, 2 blocks of {half} samples:"
              f" {nsym} symbols, launches " + ", ".join(
                  f"{t}={n}" for t, n in counts.items()))
        if counts != want or not ok or nsym < 100:
            fail(f"phase 29 (a): {label}: launches {counts} (want {want}),"
                 f" finite {ok}, {nsym} symbols")
        if "K13f" in want:
            report["K13f"]["launches"] = counts["K13f"]
            report["K13f"]["launches_path"] = f"{label}, 2 blocks"


def fsk4_signal(n: int, rng) -> np.ndarray:
    """4FSK at 4 800 Bd on 48 kS/s (±2 400 Hz outer), in noise."""
    sps = 10
    lv = np.array([-1.0, -1 / 3, 1 / 3, 1.0])[rng.integers(0, 4,
                                                         n // sps + 1)]
    f = np.repeat(lv, sps)[:n]
    ph = 2 * np.pi * 2400.0 * np.cumsum(f) / 48_000.0
    return (np.exp(1j * ph) + 0.02 * (rng.standard_normal(n) + 1j
                                      * rng.standard_normal(n))
            ).astype(np.complex64)


def pi4_signal(n: int, rng) -> np.ndarray:
    """π/4-DQPSK at 18 k symbols/s on 72 kS/s, 300 Hz off, in noise."""
    ph = np.cumsum(rng.integers(0, 4, n // 4 + 1) * (np.pi / 2) + np.pi / 4)
    k = np.arange(n)
    return (np.repeat(np.exp(1j * ph), 4)[:n]
            * np.exp(2j * np.pi * 300.0 * k / 72_000.0)
            + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def decoders_capture(path: str) -> dict:
    """(b)'s capture: DEC_SECONDS at 2.4 MS/s holding the M17 station, the
    KG-SSTV burst, the RyFi burst (from DEC_RYFI_AT) and the two Meteor
    carriers (from 0), each at its offset, in noise; returns what was
    sent: the M17 payloads and the Meteor symbols."""
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    rng = np.random.default_rng(290)
    n = int(DEC_FS * DEC_SECONDS)
    x = np.zeros(n, np.complex128)
    k = np.arange(n)

    def add(sig, offset, at, amp):
        i = int(at * DEC_FS)
        m = min(len(sig), n - i)
        x[i:i + m] += amp * sig[:m] * np.exp(2j * np.pi * offset
                                             * k[i:i + m] / DEC_FS)
    m17_iq, payloads = m17_signal(DEC_FS)
    add(m17_iq, DEC_M17, 0.0, 0.2)
    add(kg_sstv_signal(DEC_FS, rng), DEC_KG, 0.05, 0.2)
    add(ryfi_signal(240_000.0, DEC_FS, RYFI_PACKETS, rng), DEC_RYFI,
        DEC_RYFI_AT, 0.3)
    sent = {"m17": payloads}
    for name, (off, kind) in DEC_METEOR.items():
        sym = meteor_symbols(kind, DEC_METEOR_SYMS, rng)
        add(meteor_signal(kind, DEC_FS, sym), off, 0.0, 0.5)
        sent[name] = sym
    x += DEC_NOISE * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    write_wav(path, x.astype(np.complex64), DEC_FS, bits=32)
    return sent


def decoders_config(capture: str, meteor_only: bool = False) -> dict:
    """(b)'s config.json: the capture through a file source, fft 65 536 at
    20 fps, manual pump, the decoder modules (each Meteor module records
    into a directory of its own beside the capture: the file names carry
    the second they start)."""
    mods = {n: {"type": "meteor_demodulator", "offset": off,
                "broken": kind == "broken",
                "directory": os.path.join(os.path.dirname(capture),
                                          f"rec_{n}_{int(meteor_only)}")}
            for n, (off, kind) in DEC_METEOR.items()}
    if not meteor_only:
        mods.update({
            "M17": {"type": "m17_decoder", "offset": DEC_M17},
            "KG": {"type": "kg_sstv_decoder", "offset": DEC_KG},
            "RyFi": {"type": "ryfi_decoder", "offset": DEC_RYFI,
                     "baudrate": 240_000.0, "channel_sr": 720_000.0}})
    return {"source": {"type": "file", "path": capture, "loop": False},
            "fftSize": FFT, "fftRate": 20, "pump": "manual",
            "modules": mods}


def meteor_recordings(app, blocks: int, per_module: dict | None = None,
                      wrappers: dict | None = None):
    """Start each Meteor module's recording, pump ``blocks`` blocks (each
    module's baseband handler counted into ``per_module``: launches by
    kernel, read from ``wrappers``, and calls), stop; {module: its int8
    stream}."""
    paths = {n: app.modules[n].handle_debug_command("start_record", "")[
        "path"] for n in DEC_METEOR}
    if per_module is not None:
        ev = app.baseband_event
        ev._handlers = [counted_handler(h, per_module, wrappers)
                        for h in ev._handlers]
    app.start()
    if app.pump_step(blocks) != blocks:
        fail("phase 29: the pump stopped")
    out = {}
    for n, path in paths.items():
        app.modules[n].handle_debug_command("stop_record", "")
        with open(path, "rb") as f:
            out[n] = np.frombuffer(f.read(), np.int8)
    return out


def counted_handler(h, per_module: dict, wrappers: dict):
    """A module's baseband handler that adds the kernel launches each of
    its calls makes (the counts of ``wrappers``, {tag: the wrapper}: under
    ``capture`` the module's names hold recorders) and its wall seconds
    to ``per_module[name]``."""
    name = getattr(getattr(h, "__self__", None), "name", "?")
    entry = per_module.setdefault(name, {"calls": 0, "launches": {},
                                         "wall": 0.0})

    def handler(iq):
        n0 = {t: w.launches for t, w in wrappers.items()}
        t0 = time.perf_counter()
        h(iq)
        entry["wall"] += time.perf_counter() - t0
        entry["calls"] += 1
        for t, w in wrappers.items():
            d = w.launches - n0[t]
            if d:
                entry["launches"][t] = entry["launches"].get(t, 0) + d
    return handler


def decoders_app(dev, card: str, report: dict, tmp: str) -> None:
    """(b): the served app on the decoders' capture, on the card, then its
    Meteor modules on the host CPU."""
    import torch
    cap = os.path.join(tmp, "baseband_100000000Hz_10-00-00_01-01-2024.wav")
    sent = decoders_capture(cap)
    app = new_app(os.path.join(tmp, "p29"), decoders_config(cap), dev)
    per_module: dict = {}
    try:
        blocks = int(DEC_SECONDS * 20)            # 50 ms blocks
        wrappers = {t: getattr(*kernel_fn(t, "_kernel")) for t in KERNELS}
        reset_counts()
        with no_plain_on_card():
            recs, cap29 = capture(tuple(KERNELS), lambda: meteor_recordings(
                app, blocks, per_module, wrappers))
            torch.cuda.synchronize()
        counts = {t: kernel_count(t) for t in KERNELS}
        block_len = app.pump_block_len
        replies = {n: {c: app.modules[n].handle_debug_command(c, a)
                       for c, a in cmds} for n, cmds in (
            ("M17", (("get_lsf", ""), ("get_stream", ""))),
            ("KG", (("status", ""), ("get_frames", ""))),
            ("RyFi", (("status", ""), ("get_packets", "16"))))}
        # device µs a module's 0.1 s block, after the run (its state goes
        # on; the Meteor recordings are closed)
        chunk = read_capture_block(cap, 0, int(DEC_FS // 10))
        dev_us = {}
        for n, m in app.modules.items():
            by = {}
            us, _ = call_profile(lambda m=m: m._on_baseband(chunk), 3,
                                 by_kernel=by)
            dev_us[n] = (us, by)
    finally:
        app.shutdown()
    hold_launches(f"phase 29 (b), served decoders, {blocks} blocks",
                  {t: counts[t] for t in DEC_TAGS}, cap29)
    others = {t: c for t, c in counts.items() if c and t not in DEC_TAGS}
    if min(counts[t] for t in DEC_TAGS) < 1 or others:
        fail(f"phase 29 (b): launch pattern {counts}")
    # K13b timed on MeteorB's last served block, the served calls that
    # span K13m's tiles held bit for bit (K12c: 100 dB, its state exact)
    # to the plain versions: a Meteor module's last AGC, Costas and clock
    # recovery (15 000 samples, 4 tiles) and RyFi's last clock recovery
    # (72 000, 18 tiles), and K16 at the last served frames
    report["K13b"] = check_loop_kernel(
        "K13b", cap29["K13b"][-1], card,
        "Meteor's broken-modulation Costas, the served 0.1 s block",
        timed=True, plain_calls=0)
    for t in DEC_TAGS:
        report.setdefault(t, {}).setdefault("launches_by_path", {})[
            "served decoders"] = counts[t]
    checks = [(t, DEC_METEOR_T) for t in ("K12c", "K13c", "K13m")] + [
        ("K13m", DEC_RYFI_T)]
    for t, T in checks:
        calls = [c for c in cap29.get(t, ())
                 if loop_input(t, c).shape[-1] == T]
        if not calls:
            fail(f"phase 29 (b): no served {t} call of {T} samples")
        err = check_loop_kernel(t, calls[-1], card, f"served, {T} samples",
                                timed=False, host=t == "K13m")["max_abs_err"]
        report[t]["max_abs_err"] = max(report[t]["max_abs_err"], err)
    err = check_loop_kernel("K16", cap29["K16"][-1], card,
                            "served decoders", timed=False)["max_abs_err"]
    report["K16"]["max_abs_err"] = max(report["K16"]["max_abs_err"], err)
    for t in ("K16", "K13b"):
        report[t]["launches"] = counts[t]
        report[t]["launches_path"] = f"served decoders ({blocks} blocks)"
    print(f"phase 29 (b): served app on {dev} ({block_len}-sample blocks, "
          f"fft {FFT}), {blocks} blocks of the {DEC_SECONDS} s capture: "
          "launches " + ", ".join(f"{t}={counts[t]}" for t in DEC_TAGS)
          + ", every other kernel 0")
    for n, e in per_module.items():
        us, by = dev_us.get(n, (float("nan"), {}))
        print(f"phase 29 (b): module {n}: {e['calls']} baseband calls, "
              "launches " + ", ".join(f"{t}={c}" for t, c in
                                      e["launches"].items())
              + f"; device {us:.1f} us a 0.1 s block ("
              + ", ".join(f"{k} {v:.1f}" for k, v in by.items())
              + f") [{card}]")
    # the products
    lsf, stream = replies["M17"]["get_lsf"], replies["M17"]["get_stream"]
    frames = stream["frames"]
    exact = all(bytes.fromhex(f["payload"]) == sent["m17"].get(f["fn"])
                for f in frames)
    print(f"phase 29 (b): M17 LSF {lsf}; {stream['total']} stream frames "
          f"(fn {[f['fn'] for f in frames]}), payloads exact {exact}")
    if not (lsf.get("valid") and (lsf["dst"], lsf["src"]) == (M17_DST,
                                                              M17_SRC)):
        fail(f"phase 29 (b): M17 LSF {lsf}")
    if not exact or sorted(f["fn"] for f in frames) != sorted(sent["m17"]):
        fail(f"phase 29 (b): M17 stream {stream}")
    kg = replies["KG"]["get_frames"]["frames"]
    print(f"phase 29 (b): KG-SSTV frames {kg}")
    if kg != [p.hex() for p in KG_PAYLOADS]:
        fail(f"phase 29 (b): KG-SSTV frames {kg}")
    ry, pk = replies["RyFi"]["status"], replies["RyFi"]["get_packets"]
    print(f"phase 29 (b): RyFi {ry}")
    if pk["packets"] != [p.hex() for p in RYFI_PACKETS] or ry["bad_frames"]:
        fail(f"phase 29 (b): RyFi packets {ry}")
    for n, (off, kind) in DEC_METEOR.items():
        soft = ((recs[n][0::2] + 1j * recs[n][1::2].astype(np.float64))
                / 84.0)[:DEC_METEOR_SYMS]
        if kind == "broken":
            dev_deg = broken_deviation_deg(soft, DEC_METEOR_SKIP)
            print(f"phase 29 (b): {n} (broken, {len(soft)} symbols "
                  f"recorded): median {dev_deg:.1f} deg from its phases "
                  "(bar 25)")
            if not dev_deg < 25.0:
                fail(f"phase 29 (b): {n} did not lock")
        else:
            m, err = qpsk_decisions(soft, sent[n], DEC_METEOR_SKIP)
            print(f"phase 29 (b): {n} (QPSK, {len(soft)} symbols recorded):"
                  f" {err} decision errors in {m} symbols after lock")
            if m < 2000 or err:
                fail(f"phase 29 (b): {n}: {err} errors in {m}")
    # the Meteor modules on the host CPU: the same capture's first blocks
    cpu = new_app(os.path.join(tmp, "p29cpu"),
                  decoders_config(cap, meteor_only=True), "cpu")
    try:
        want = meteor_recordings(cpu, DEC_CPU_BLOCKS)
    finally:
        cpu.shutdown()
    for n in DEC_METEOR:
        w = want[n].astype(np.int64)
        g = recs[n][:len(w)].astype(np.int64)
        share = float(np.mean(np.abs(g - w) <= 1)) if len(w) else 0.0
        sn = np_snr_db(w.astype(np.float64), g.astype(np.float64))
        print(f"phase 29 (b): {n}'s int8 stream, card against host CPU, "
              f"first {len(w)} values ({DEC_CPU_BLOCKS} blocks): "
              f"{100 * share:.2f} % within one step (bar 100), {sn:.1f} dB "
              "(bar 60)")
        if len(w) < 2000 or share < 1.0 or sn < 60.0:
            fail(f"phase 29 (b): {n}: the card's int8 stream is not the "
                 "host CPU's")


def read_capture_block(path: str, start: int, n: int) -> np.ndarray:
    """``n`` complex64 samples of a capture from ``start``."""
    from sdrplusplusbrown_tpu_torch.io.wav import read_wav_iq
    return np.ascontiguousarray(read_wav_iq(path)[0][start:start + n],
                                np.complex64)


def ryfi_full_rate(dev, card: str) -> None:
    """(c): RyFi at 720 kBd on 1.5 MS/s (the module's defaults), 2 s of
    packets through ``RyfiReceiver`` on the card in 0.1 s blocks under
    the profiler: every packet exact, no bad frame; wall seconds a second
    of signal split into the demod (to its symbols' copy to the host),
    the deframer, the Viterbi and the RS/reassembly, and device µs by
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sdrplusplusbrown_tpu_torch.models import ryfi as R
    baud, fs = RYFI_FULL
    rng = np.random.default_rng(291)
    n_frames = int(RYFI_FULL_SECONDS * baud / (R.FRAME_SYMS + R.SYNC_SYMS))
    n_pk = n_frames * R.FRAME_DATA_SIZE // (RYFI_FULL_PACKET + 2) - 1
    packets = [bytes(rng.integers(0, 256, RYFI_FULL_PACKET).tolist())
               for _ in range(n_pk)]
    t0 = time.perf_counter()
    iq = ryfi_signal(baud, fs, packets, rng, idle=2000)
    iq = (iq + 0.01 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))
          ).astype(np.complex64)
    blk = int(fs // 10)
    iq = np.concatenate([iq, np.zeros((-len(iq)) % blk, np.complex64)])
    t_gen = time.perf_counter() - t0
    rx = R.RyfiReceiver(baud, fs, device=dev)
    got = []
    reset_counts()
    with no_plain_on_card(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in range(len(iq) // blk):
            got.extend(rx.process(iq[b * blk:(b + 1) * blk]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    secs = len(iq) / fs
    by = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and not e.key.startswith(("aten::", "cuda",
                                            "ProfilerStep")):
            k = short_kernel(e.key)
            by[k] = by.get(k, 0.0) + us
    dev_s = sum(by.values()) / 1e6
    counts = {t: kernel_count(t) for t in KERNELS if kernel_count(t)}
    tm = rx.timing
    print(f"phase 29 (c): RyFi at {baud / 1e3:.0f} kBd on {fs / 1e6:.1f} "
          f"MS/s, {secs:.2f} s of signal ({n_frames} frames, {n_pk} packets "
          f"of {RYFI_FULL_PACKET} bytes; made in {t_gen:.1f} s on the host): "
          f"{len(got)} packets, {rx.frames_decoded} frames, "
          f"{rx.frames_bad} bad; launches "
          + ", ".join(f"{t}={n}" for t, n in counts.items()))
    print(f"phase 29 (c): wall {wall / secs:.3f} s a second of signal "
          f"(under the profiler): demod {tm['demod'] / secs:.3f} (to the "
          f"symbols' host copy), deframer {tm['deframe'] / secs:.3f}, "
          f"Viterbi {tm['viterbi'] / secs:.3f}, RS and reassembly "
          f"{tm['rs'] / secs:.3f}; device {dev_s / secs:.4f} s a second "
          "of signal (" + ", ".join(f"{k} {v / 1e3 / secs:.1f} ms"
                                    for k, v in sorted(
                                        by.items(), key=lambda kv: -kv[1]))
          + f" a second) [{card}]")
    if got != packets or rx.frames_bad:
        fail(f"phase 29 (c): {len(got)} of {len(packets)} packets, "
             f"{rx.frames_bad} bad frames")


# ---- phase 30: the wideband decoders ---------------------------------

WB_VOR_AZ = (0.0, 137.0, 289.5)   # tests/test_decoders_wave1.py's azimuths
WB_VOR_SECONDS = 6.0
WB_VOR_NOISE_SECONDS = 4.0
WB_PREFIX = 3000              # samples a block of the K13p / K12c prefixes
WB_MM_PREFIX = 5000           # and of the K13m prefixes
WB_FALCON_FRAMES_S = 0.12     # (c): seconds of back-to-back Falcon frames
WB_SEED = 12345               # the JAX tests' ``rng`` (tests/conftest.py)
#: (c)'s served apps: label → (module, module type, source rate, offset,
#: the reference fault that keeps the product from its bars there, or
#: None), each capture at a rate its users run: an Airspy Mini class
#: L-band receiver (HRPT, 6 MS/s; Falcon 9's channel rate, 6 MS/s), an
#: Airspy R2 behind an S-band downconverter (Falcon 9, 10 MS/s), a HackRF
#: on an amateur-TV band (ATV, 20 MS/s), an RTL-SDR in Band III (DAB at
#: 2.4 MS/s, and at 2.048 MS/s, the rate DAB receivers set it to), an
#: airband receiver (VOR, 250 kS/s)
WB_SERVED = {
    "HRPT": ("HRPT", "weather_sat_decoder", 6_000_000.0, 100e3, None),
    "Falcon9": ("Falcon9", "falcon9_decoder", 10_000_000.0, 0.0,
                "the JAX module's 4 MHz RxVFO bandwidth cuts the FSK's "
                "+-2 MHz tones: the JAX app decodes no frame of this "
                "capture either (ROADMAP queue 3)"),
    "Falcon9 6 MS/s": ("Falcon9", "falcon9_decoder", 6_000_000.0, 0.0,
                       None),
    "ATV": ("ATV", "atv_decoder", 20_000_000.0, 1e6, None),
    "DAB": ("DAB", "dab_decoder", 2_400_000.0, 200e3,
            "the reference FrameFreqSync's CFO correlation diverges when "
            "the symbols' timing is fractional, as the RxVFO's 64/75 "
            "resampler makes it: the JAX package's front end does the "
            "same on this capture (ROADMAP queue 3)"),
    "DAB 2.048 MS/s": ("DAB", "dab_decoder", 2_048_000.0, 0.0, None),
    "VOR": ("VOR", "vor_receiver", 250_000.0, 30e3, None)}
#: the kernels each served app launches (its spectrum K4f, its RxVFO's
#: and filters' K8, its loops); every other kernel stays at 0
WB_TAGS = {"HRPT": ("K4f", "K8", "K12c", "K13p", "K13m"),
           "Falcon9": ("K4f", "K8", "K13m"),
           "Falcon9 6 MS/s": ("K4f", "K8", "K13m"),
           "ATV": ("K4f", "K8", "K12c"), "DAB": ("K4f", "K8"),
           "DAB 2.048 MS/s": ("K4f",), "VOR": ("K4f", "K8")}
#: the kernels phase 30's paths report in ``launches_by_path``
WB_REPORT_TAGS = ("K8", "K9", "K12c", "K13p", "K13m")


def hrpt_channel(rng, fs: float) -> tuple:
    """tests/test_hrpt.py's RF loopback at ``fs``: two HRPT frames (a
    ramp image with TIP words, a random one) behind 15 000 random bits,
    PM at 1.17 rad, 150 Hz off, noise 0.02; (iq, [av1, av2], tip)."""
    from sdrplusplusbrown_tpu_torch.models import hrpt as H
    av1 = np.stack([(np.arange(2048) * k + 7) % 1024 for k in range(1, 6)])
    av2 = rng.integers(0, 1024, (5, 2048))
    tip = rng.integers(0, 1024, 520)
    bits = H.frames_signal(rng, [H.build_frame(av1, tip),
                                 H.build_frame(av2)])
    iq = H.pm_modulate(bits, samplerate=fs)
    n = np.arange(len(iq))
    iq = iq * np.exp(1j * (2 * np.pi * 150.0 * n / fs + 0.4))
    iq = iq + 0.02 * (rng.standard_normal(len(iq))
                      + 1j * rng.standard_normal(len(iq)))
    return iq.astype(np.complex64), [av1, av2], tip


def falcon_frames(rng, n_frames: int, fs: float, noise: float) -> tuple:
    """``n_frames`` back-to-back Falcon 9 frames (frame k carrying one
    packet, counter k + 1) behind 4 000 random bits at ``fs``; (iq,
    packets)."""
    from sdrplusplusbrown_tpu_torch.models import falcon9 as F
    pkts, bits = [], [rng.integers(0, 2, 4000).astype(np.uint8)]
    for k in range(n_frames):
        pk = F.make_packet(b"\x00" * 8 + f"falcon frame {k}".encode()
                           + bytes(rng.integers(0, 256, 64).tolist()))
        wire = F.falcon_rs_encode(F.build_frame_payload(k + 1, pk, 0))
        bits += [F.ASM_BITS, np.unpackbits(wire)]
        pkts.append(pk)
    bits.append(rng.integers(0, 2, 2000).astype(np.uint8))
    return F.falcon_signal(np.concatenate(bits), noise, 0.2, rng, fs), pkts


def atv_channel(rng) -> tuple:
    """tests/test_atv.py's RF loopback at 14.765625 MS/s: a sine pattern
    on 2 352 lines (12 frames of 90-line fields), negative AM, noise
    0.004; (iq, pattern)."""
    from sdrplusplusbrown_tpu_torch.models import atv as A
    pattern = (0.5 + 0.4 * np.sin(2 * np.pi * np.arange(A.VISIBLE_W)
                                  / 128.0)).astype(np.float32)
    sig = A.video_signal(pattern, n_normal=90, reps=12)
    iq = ((0.8 - 0.45 * sig) * np.exp(1j * 0.3)).astype(np.complex64)
    iq = iq + 0.004 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))
    return iq.astype(np.complex64), pattern


def dab_channel(rng) -> tuple:
    """tests/test_dab_kgsstv.py's signal at 2.048 MS/s: 30 frames of 10
    data symbols, 350 Hz off, noise 0.005; (iq, each frame's dibits)."""
    from sdrplusplusbrown_tpu_torch.models import dab as D
    frames, dibits = [], []
    for _ in range(30):
        iq, dib = D.build_frame(10, rng)
        frames.append(iq)
        dibits.append(dib)
    sig = np.concatenate(frames)
    n = np.arange(len(sig))
    sig = sig * np.exp(2j * np.pi * 350.0 * n / D.DAB_SR)
    sig = sig + 0.005 * (rng.standard_normal(len(sig))
                         + 1j * rng.standard_normal(len(sig)))
    return sig.astype(np.complex64), dibits


def at_rate(x: np.ndarray, fs_in: float, fs: float, offset: float,
            block: int, granule: int = 1) -> np.ndarray:
    """``x`` at ``fs_in`` resampled to ``fs`` (a rational resampler),
    moved to ``offset`` and padded with zeros to whole ``granule``s (a
    module's block), then to whole ``block``s (the app's)."""
    from fractions import Fraction
    from scipy.signal import resample_poly
    r = Fraction(int(fs), int(fs_in))
    y = x if r == 1 else resample_poly(x, r.numerator, r.denominator)
    y = y * np.exp(2j * np.pi * offset * np.arange(len(y)) / fs)
    n = -(-len(y) // granule) * granule
    n = -(-n // block) * block
    return np.concatenate([y, np.zeros(n - len(y))]).astype(np.complex64)


# -- the products, each held to the JAX package's slow tests' bars ------
def hrpt_product(framer, avs, tip) -> str:
    ok = (framer.frames >= 2 and len(framer.avhrr_lines) >= 2
          and all(np.array_equal(framer.avhrr_lines[i], a)
                  for i, a in enumerate(avs))
          and np.array_equal(framer.tip[0], tip))
    return (f"{framer.frames} frames, both frames' 5 x 2048 pixels and the "
            f"TIP words exact: {ok}"), ok


def falcon_product(mod, pkts) -> tuple:
    got = mod.pkt_sync.packets
    ok = got == pkts and mod.frames_bad == 0
    return (f"{mod.frames_ok} frames, {mod.frames_bad} bad, {len(got)} of "
            f"{len(pkts)} packets exact: {ok}"), ok


def atv_product(mod, pattern) -> tuple:
    img = mod.assembler.image
    rows = img[img.max(axis=1) > 40]
    c = float(np.corrcoef(rows[len(rows) // 2].astype(float), pattern)[
        0, 1]) if len(rows) > 50 else float("nan")
    ok = (mod.linesync.locked > 750 and mod.assembler.frames >= 1
          and 0.1 < mod.assembler.gain < 10.0 and c > 0.9)
    return (f"locked {mod.linesync.locked} (bar > 750), "
            f"{mod.assembler.frames} frames (bar >= 1), gain "
            f"{mod.assembler.gain:.3f}, mid-row correlation {c:.4f} (bar "
            f"> 0.9)"), ok


def dab_product(mod, dibits, cfo: float) -> tuple:
    """DAB's bars; the frames counted are those ``dab_frames_within``
    saw inside the signal (the zeros that pad it to whole blocks are
    null symbols to the front end)."""
    ff = mod.ffsync
    dm = ff.demap_time_differential()
    accs = [float((dm[i] == dibits[-1][i]).mean())
            for i in range(min(len(dm), len(dibits[-1])))]
    acc = float(np.mean(accs)) if accs else 0.0
    frames = mod.frames_within["frames"]
    ok = (frames >= 25 and abs(ff.last_cfo_hz - cfo) < 60.0
          and len(accs) >= 8 and acc > 0.85
          and len(ff.constellations[-1]) == 1534)
    return (f"{frames} frames (bar >= 25), CFO {ff.last_cfo_hz:.1f} Hz "
            f"(want {cfo:.0f} +- 60), the last frame's dibits "
            f"{100 * acc:.2f} % (bar 85) over {len(accs)} symbols"), ok


def dab_frames_within(mod, n_sig: int) -> None:
    """Count on ``mod.frames_within["frames"]`` the frames the module's
    front end has seen by its last symbol inside the first ``n_sig``
    channel samples."""
    from sdrplusplusbrown_tpu_torch.models.dab import TU
    ff, box = mod.ffsync, {"frames": 0}
    orig = ff.push_symbol

    def push(s, pos=None):
        orig(s, pos=pos)
        if pos is not None and pos + TU <= n_sig:
            box["frames"] = ff.frames_seen
    ff.push_symbol = push
    mod.frames_within = box


def drive_wideband(dev, card: str, report: dict) -> None:
    """Phase 30: (b) each wideband decoder's RF loopback on the card
    through its module at its channel rate, the loop kernels' calls
    captured; (a) K13p, K12c and K13m at those callers' shapes against
    their plain versions on two-block prefixes and clocked at the full
    shape; (c) each module served by the app in manual pump on a capture
    at its users' source rate."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wb_") as tmp:
        calls = wideband_loopbacks(dev, card, tmp)
        t1 = time.perf_counter()
        wideband_kernels(calls, card, report)
        t2 = time.perf_counter()
        for label in WB_SERVED:
            wideband_served(label, dev, card, report, tmp)
    t3 = time.perf_counter()
    print(f"phase 30: {t3 - t0:.1f} s ((b) {t1 - t0:.1f}, (a) {t2 - t1:.1f}"
          f", (c) {t3 - t2:.1f}) [{card}]")


def channel_app(tmp: str, name: str, mtype: str, sr: float, dev):
    """An app at the channel rate ``sr`` (no source: the module is fed
    by hand) holding one module ``name`` of ``mtype``."""
    return new_app(os.path.join(tmp, f"p30b_{name}"), {
        "source": {"type": "none", "samplerate": sr}, "fftSize": 4096,
        "modules": {name: {"type": mtype}}}, dev)


def loopback_run(label: str, want: dict, run) -> dict:
    """``run()`` on the card inside ``no_plain_on_card`` with the counts
    zeroed before and K12c's, K13p's and K13m's calls captured; fails
    unless exactly the kernels of ``want`` launched, each at least once;
    returns the captured calls."""
    import torch
    reset_counts()
    with no_plain_on_card():
        _, cap = capture(("K12c", "K13p", "K13m"), run)
        torch.cuda.synchronize()
    counts = {t: kernel_count(t) for t in KERNELS if kernel_count(t)}
    print(f"phase 30 (b): {label}: launches " + (", ".join(
        f"{t}={n}" for t, n in counts.items()) or "none (host only)"))
    if set(counts) != set(want):
        fail(f"phase 30 (b): {label}: launches {counts}, want {want}")
    return cap


def wideband_loopbacks(dev, card: str, tmp: str) -> dict:
    """(b): the JAX package's slow tests' loopbacks through each module on
    an app on the card at the channel rate; returns the captured loop
    kernel calls by caller."""
    from sdrplusplusbrown_tpu_torch.models import atv as A
    from sdrplusplusbrown_tpu_torch.models import dab as D
    from sdrplusplusbrown_tpu_torch.models import falcon9 as F
    from sdrplusplusbrown_tpu_torch.models import hrpt as H
    from sdrplusplusbrown_tpu_torch.models import vor as V
    calls = {}
    # each signal from a fresh generator of the JAX tests' seed: the JAX
    # package's slow tests' signals, sample for sample
    # HRPT at 3 MS/s
    iq, avs, tip = hrpt_channel(np.random.default_rng(WB_SEED),
                                H.HRPT_VFO_SR)
    app = channel_app(tmp, "Sat", "weather_sat_decoder", H.HRPT_VFO_SR, dev)
    try:
        mod = app.modules["Sat"]
        x = np.concatenate([iq, np.zeros((-len(iq)) % mod.rc.out_len,
                                         np.complex64)])
        cap = loopback_run(f"HRPT, {len(iq)} samples at 3 MS/s in blocks "
                           f"of {mod.rc.out_len}",
                           ("K8", "K12c", "K13p", "K13m"),
                           lambda: mod.process_iq(x))
        calls["HRPT"] = cap
        msg, ok = hrpt_product(mod.framer, avs, tip)
    finally:
        app.shutdown()
    print(f"phase 30 (b): HRPT: {msg}")
    if not ok:
        fail("phase 30 (b): HRPT's frames are not the sent ones")
    # Falcon 9 at 6 MS/s: tests/test_falcon9.py's frame, noise 0.05
    pkts = [F.make_packet(b"\x00" * 8 + b"telemetry hello world")]
    wire = F.falcon_rs_encode(F.build_frame_payload(1, b"".join(pkts), 0))
    rng = np.random.default_rng(WB_SEED)
    iq = F.falcon_signal(F.frame_bits(wire, rng), 0.05, 0.2, rng)
    app = channel_app(tmp, "F9", "falcon9_decoder", F.FALCON_SR, dev)
    try:
        mod = app.modules["F9"]
        x = np.concatenate([iq, np.zeros((-len(iq)) % mod.rc.out_len,
                                         np.complex64)])
        calls["Falcon9"] = loopback_run(
            f"Falcon 9, {len(iq)} samples at 6 MS/s in a block of "
            f"{mod.rc.out_len}", ("K8", "K13m"), lambda: mod.process_iq(x))
        msg, ok = falcon_product(mod, pkts)
    finally:
        app.shutdown()
    print(f"phase 30 (b): Falcon 9: {msg}")
    if not ok:
        fail("phase 30 (b): Falcon 9's packet is not the sent one")
    # VOR at 25 kHz: three azimuths, then noise, a window at a time
    app = new_app(os.path.join(tmp, "p30b_vor"), {
        "source": {"type": "none", "samplerate": V.VOR_IN_SR},
        "fftSize": 4096, "modules": {
            f"V{i}": {"type": "vor_receiver"} for i in range(4)}}, dev)
    try:
        def vor_windows(mod, x):
            out = []
            blk = mod.rc.out_len
            for i in range(0, len(x) - blk + 1, blk):
                mod._on_baseband(x[i:i + blk])
                out.append(mod.handle_debug_command("get_bearing", ""))
            return out
        got = {}

        def run():
            for i, az in enumerate(WB_VOR_AZ):
                got[az] = vor_windows(app.modules[f"V{i}"], V.synthesize_vor(
                    np.deg2rad(az), WB_VOR_SECONDS, noise=0.05))
            T = int(WB_VOR_NOISE_SECONDS * V.VOR_IN_SR)
            rng = np.random.default_rng(7)      # the JAX test's
            got["noise"] = vor_windows(app.modules["V3"], (0.3 * (
                rng.standard_normal(T) + 1j * rng.standard_normal(T))
            ).astype(np.complex64))
        loopback_run("VOR, 3 azimuths x 6 s and 4 s of noise at 25 kHz in "
                     "1 s blocks", ("K8",), run)
    finally:
        app.shutdown()
    for az in WB_VOR_AZ:
        last = got[az][-2:]
        err = [abs(((w["bearing"] - az + 180.0) % 360.0) - 180.0)
               for w in last]
        print(f"phase 30 (b): VOR at {az} deg: the last two windows "
              f"{[w['bearing'] for w in last]} deg (error bar 2), quality "
              f"{[w['quality'] for w in last]} % (bar 90)")
        if max(err) >= 2.0 or min(w["quality"] for w in last) <= 90.0:
            fail(f"phase 30 (b): VOR at {az} deg: {got[az]}")
    qn = [w["quality"] for w in got["noise"][-2:]]
    print(f"phase 30 (b): VOR on noise: quality {qn} % (bar < 50)")
    if max(qn) >= 50.0:
        fail(f"phase 30 (b): VOR's quality on noise {qn}")
    # ATV at 14.765625 MS/s
    iq, pattern = atv_channel(np.random.default_rng(WB_SEED))
    app = channel_app(tmp, "ATV", "atv_decoder", A.SAMPLE_RATE, dev)
    try:
        mod = app.modules["ATV"]
        x = np.concatenate([iq, np.zeros((-len(iq)) % mod.rc.out_len,
                                         np.complex64)])
        calls["ATV"] = loopback_run(
            f"ATV, {len(iq)} samples at 14.77 MS/s in blocks of "
            f"{mod.rc.out_len}", ("K12c",), lambda: mod.process_iq(x))
        msg, ok = atv_product(mod, pattern)
    finally:
        app.shutdown()
    print(f"phase 30 (b): ATV: {msg}")
    if not ok:
        fail("phase 30 (b): ATV's picture fails its bars")
    # DAB at 2.048 MS/s: host numpy only (the JAX module's too)
    iq, dibits = dab_channel(np.random.default_rng(WB_SEED))
    app = channel_app(tmp, "DAB", "dab_decoder", D.DAB_SR, dev)
    try:
        mod = app.modules["DAB"]
        dab_frames_within(mod, len(iq))
        x = np.concatenate([iq, np.zeros((-len(iq)) % mod.rc.out_len,
                                         np.complex64)])
        loopback_run(f"DAB, {len(iq)} samples at 2.048 MS/s", (),
                     lambda: mod.process_iq(x))
        msg, ok = dab_product(mod, dibits, -350.0)
    finally:
        app.shutdown()
    print(f"phase 30 (b): DAB: {msg}")
    if not ok:
        fail("phase 30 (b): DAB fails its bars")
    return calls


def wideband_kernels(calls: dict, card: str, report: dict) -> None:
    """(a): each loop kernel at its caller's shape: its last served call
    of (b) (a locked block) clocked at the full shape, and against its
    plain version on a prefix of that call in two blocks, the second
    from the state the kernel returned for the first (both blocks' every
    output and state bit for bit; K12c's output 100 dB, its state exact;
    K13m's plain version on a host CPU copy)."""
    cases = (("K13p", "HRPT", "HRPT's carrier PLL", WB_PREFIX),
             ("K12c", "HRPT", "HRPT's AGC", WB_PREFIX),
             ("K12c", "ATV", "ATV's AGC", WB_PREFIX),
             ("K13m", "HRPT", "HRPT's clock recovery (2.254 a symbol)",
              WB_MM_PREFIX),
             ("K13m", "Falcon9", "Falcon 9's clock recovery (1.68 a "
              "symbol)", WB_MM_PREFIX))
    for tag, caller, what, n in cases:
        got = calls[caller].get(tag)
        if not got:
            fail(f"phase 30 (a): no {tag} call from {caller}")
        call = got[-1]
        loop_at_shape(tag, call, card, what)
        err = loop_prefix(tag, call, n, card, what)
        report[tag]["max_abs_err"] = max(report[tag]["max_abs_err"], err)


def loop_state(tag: str, out) -> tuple:
    """The carried state a loop kernel's result hands its next call."""
    if tag == "K13p":
        return tuple(out[1:])
    if tag == "K12c":
        return (out[1], out[2])
    return (out[1],)


def loop_prefix(tag: str, call, n: int, card: str, what: str) -> float:
    """``call``'s first 2·n input samples as two calls, the second from
    the state the kernel returned for the first, each held to the plain
    version (``check_loop_kernel``); their largest |error|."""
    kern = getattr(*kernel_fn(tag, "_kernel"))
    head, x, rest = call[0], call[1], tuple(call[2:])
    if tag == "K12c":
        state, tail = rest[:2], rest[2:]
    else:
        state, tail = rest, ()
    err = 0.0
    for b in range(2):
        blk = (head, x[:, b * n:(b + 1) * n].contiguous(), *state, *tail)
        err = max(err, check_loop_kernel(
            tag, blk, card, f"{what}, prefix block {b + 1} of {n}",
            timed=False, host=tag == "K13m")["max_abs_err"])
        state = loop_state(tag, kern(*blk))
    return err


def loop_at_shape(tag: str, call, card: str, what: str,
                  label: str = "phase 30 (a)") -> None:
    """A loop kernel on its caller's full call: CUDA-event ms (a launch
    of milliseconds, the wrapper's host time a few µs of it; a profiler
    window late in the script saw none of these launches), its chain
    clocked (``chain_clock_runs``) beside its bound and the chain
    floor."""
    kern = getattr(*kernel_fn(tag, "_kernel"))
    x = loop_input(tag, call)
    steps = loop_steps(tag, call)
    runs = np.array([event_ms(lambda: kern(*call), 3) for _ in range(3)])
    ms = float(np.median(runs))
    cpi, mhz = chain_clock_runs(kern, call, steps, x)
    top = max(sm_clock_mhz(), float(mhz.max()))
    floor = steps * cpi.min() / top
    bms, by = bound(tag, call)
    print(f"{label}: {tag} ({what}, {x.shape[0]} x {x.shape[1]}, "
          f"{steps} steps): kernel {ms:.4f} ms ({runs.min():.4f}-"
          f"{runs.max():.4f}), bound {bms:.6f} ms ({by}); chain "
          f"{np.median(cpi):.2f} cycles a step ({cpi.min():.2f}-"
          f"{cpi.max():.2f}) at {np.median(mhz):.0f} MHz over {LOOP_RUNS} "
          f"runs; chain floor {floor:.1f} us, {ms * 1e3 / floor:.2f}x it "
          f"[{card}]")


def host_stages(name: str, mod) -> list:
    """(owner, attribute) of the host stages a module's blocks run (its
    framer or OFDM front end), to time."""
    if name == "HRPT":
        return [(mod.framer, "push_symbols")]
    if name == "Falcon9":
        import sdrplusplusbrown_tpu_torch.modules.falcon9_module as fm
        return [(mod.deframer, "push_bits"), (fm, "falcon_rs_decode"),
                (mod.pkt_sync, "push_frame")]
    if name == "ATV":
        return [(mod.linesync, "push"), (mod.assembler, "push_line")]
    if name == "DAB":
        return [(mod.csync, "push"), (mod.ffsync, "push_symbol")]
    return []


class timed_stages:
    """Within: each (owner, attribute) of ``stages`` adds its wall time
    to ``seconds``."""

    def __init__(self, stages):
        self.stages, self.seconds, self.saved = stages, 0.0, []

    def __enter__(self):
        for owner, attr in self.stages:
            orig = getattr(owner, attr)

            def timed(*a, _orig=orig, **k):
                t = time.perf_counter()
                try:
                    return _orig(*a, **k)
                finally:
                    self.seconds += time.perf_counter() - t
            self.saved.append((owner, attr, orig))
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in self.saved:
            setattr(owner, attr, orig)
        return False


def wideband_capture(label: str, path: str, mblk: int) -> tuple:
    """(c)'s capture for ``label`` at its source rate: the module's (b)
    signal (from a fresh generator of the JAX tests' seed; Falcon 9's
    back-to-back frames) at its offset, padded to whole blocks of the
    module (``mblk`` samples) and of the pump (50 ms); (seconds, the
    product check: a function of the module → (message, ok), the
    signal's length at the channel rate)."""
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    from sdrplusplusbrown_tpu_torch.models import atv as A
    from sdrplusplusbrown_tpu_torch.models import dab as D
    from sdrplusplusbrown_tpu_torch.models import falcon9 as F
    from sdrplusplusbrown_tpu_torch.models import vor as V
    name, _, fs, off, _ = WB_SERVED[label]
    rng = np.random.default_rng(WB_SEED)
    blk = int(fs // 20)
    if name == "HRPT":
        iq, avs, tip = hrpt_channel(rng, fs)
        x = at_rate(iq, fs, fs, off, blk, mblk)
        check = lambda m: hrpt_product(m.framer, avs, tip)  # noqa: E731
    elif name == "Falcon9":
        n = int(WB_FALCON_FRAMES_S * F.FALCON_BAUD / (F.FRAME_BITS + 32))
        iq, pkts = falcon_frames(rng, n, fs, 0.02)
        x = at_rate(iq, fs, fs, off, blk, mblk)
        check = lambda m: falcon_product(m, pkts)  # noqa: E731
    elif name == "ATV":
        iq, pattern = atv_channel(rng)
        x = at_rate(iq, A.SAMPLE_RATE, fs, off, blk, mblk)
        check = lambda m: atv_product(m, pattern)  # noqa: E731
    elif name == "DAB":
        iq, dibits = dab_channel(rng)
        x = at_rate(iq, D.DAB_SR, fs, off, blk, mblk)
        check = lambda m: dab_product(m, dibits, -350.0)  # noqa: E731
    else:
        az = WB_VOR_AZ[1]
        iq = V.synthesize_vor(np.deg2rad(az), WB_VOR_SECONDS, fs=fs,
                              noise=0.05, seed=3)
        x = at_rate(iq, fs, fs, off, blk, mblk)

        def check(m):
            r = m.handle_debug_command("get_bearing", "")
            err = abs(((r["bearing"] - az + 180.0) % 360.0) - 180.0)
            return (f"bearing {r['bearing']} deg at {az} (error bar 2), "
                    f"quality {r['quality']} % (bar 90), {r['windows']} "
                    "windows"), err < 2.0 and r["quality"] > 90.0
    write_wav(path, x, fs, bits=32)
    return len(x) / fs, check, len(iq)


def wideband_served(label: str, dev, card: str, report: dict,
                    tmp: str) -> None:
    """(c) for one served app: the app on its capture (fft 65 536 at 20
    fps, 8 192 below 1 MS/s: VOR's airband receiver; manual pump), the
    counts zeroed before: the module's kernels and the spectrum's
    launched and held to their plans, every other kernel not; the
    product held to its bars, but where the reference's own fault keeps
    it from them (``WB_SERVED``: the product is printed beside the
    fault); the module's launches, device µs and loop kernels' share a
    0.1 s block and its handler's wall and host stages' seconds a second
    of signal."""
    import torch
    from sdrplusplusbrown_tpu_torch.runtime.pump import Rechunker
    name, mtype, fs, off, fault = WB_SERVED[label]
    probe = channel_app(tmp, f"probe{len(os.listdir(tmp))}", mtype, fs, dev)
    try:
        mblk = next(iter(probe.modules.values())).rc.out_len
    finally:
        probe.shutdown()
    cap = os.path.join(tmp, f"wb_{len(os.listdir(tmp))}_100000000Hz_"
                            "10-00-00_01-01-2024.wav")
    seconds, check, n_sig = wideband_capture(label, cap, mblk)
    app = new_app(os.path.join(tmp, f"p30c_{len(os.listdir(tmp))}"), {
        "source": {"type": "file", "path": cap, "loop": False},
        "fftSize": FFT if fs >= 1e6 else 8192, "fftRate": 20,
        "pump": "manual",
        "modules": {name: {"type": mtype, "offset": off}}}, dev)
    per_module: dict = {}
    try:
        mod = app.modules[name]
        if name == "DAB":
            dab_frames_within(mod, n_sig)
        wrappers = {t: getattr(*kernel_fn(t, "_kernel")) for t in KERNELS}
        ev = app.baseband_event
        ev._handlers = [counted_handler(h, per_module, wrappers)
                        for h in ev._handlers]
        reset_counts()
        app.start()
        with no_plain_on_card(), timed_stages(host_stages(name, mod)) as hs:
            (blocks, ), capd = capture(tuple(KERNELS), lambda: (
                app.pump_step(10 ** 6), ))
            torch.cuda.synchronize()
        counts = {t: kernel_count(t) for t in KERNELS}
        msg, ok = check(mod)
        block_len = app.pump_block_len
        # a 0.1 s block's device time: whole module blocks from a fresh
        # rechunker (each call then makes exactly one), scaled to 0.1 s
        mod.rc = Rechunker(mblk)
        chunk = read_capture_block(cap, 0, mblk)
        reps = max(1, min(3, int(0.3 * fs // mblk)))
        by: dict = {}
        us, n = 0.0, 0          # a module without a kernel: host only
        if per_module.get(name, {}).get("launches"):
            us, n = call_profile(lambda: mod._on_baseband(chunk), reps,
                                 by_kernel=by)
    finally:
        app.shutdown()
    tags = WB_TAGS[label]
    head = f"phase 30 (c), served {label} ({fs / 1e6:g} MS/s)"
    hold_launches(f"{head}, {blocks} blocks",
                  {t: counts[t] for t in tags}, capd)
    others = {t: c for t, c in counts.items() if c and t not in tags}
    if min(counts[t] for t in tags) < 1 or others:
        fail(f"{head}: launch pattern {counts}")
    print(f"{head}: {seconds:.3f} s of capture, {blocks} blocks of "
          f"{block_len} (the module's block {mblk}); {msg}"
          + (f" -- not held: {fault}" if fault else ""))
    if not ok and not fault:
        fail(f"{head}: the product fails its bars")
    e = per_module.get(name, {"calls": 0, "launches": {}, "wall": 0.0})
    scale = 0.1 * fs / mblk
    loops = sum(v for k, v in by.items()
                if k in ("agc_rows_kernel", "pll_kernel", "mm_kernel"))
    print(f"{head}: module {name}: launches over the run "
          + (", ".join(f"{t}={c}" for t, c in e["launches"].items())
             or "none") + f"; a 0.1 s block: device {us * scale:.1f} us "
          f"in {n * scale:.1f} launches (" + ", ".join(
              f"{k} {v * scale:.1f}" for k, v in sorted(
                  by.items(), key=lambda kv: -kv[1]))
          + f"), the loop kernels {loops * scale:.1f} us "
          f"({100 * loops / us if us else 0.0:.1f} %); the handler's "
          f"wall {e['wall'] / seconds:.4f} s a second of signal, its host "
          f"stages {hs.seconds / seconds:.4f} s [{card}]")
    for t in WB_REPORT_TAGS:
        report.setdefault(t, {}).setdefault("launches_by_path", {})[
            f"served {label} ({blocks} blocks)"] = counts[t]


# ---- phase 31: the voice and trunking decoders -----------------------
VO_FS = 2_400_000.0           # an RTL-SDR class receiver
VO_SECONDS = 1.5
VO_NOISE = 0.005              # per component, on every channel
VO_SYMRATE = 4_800.0          # DMR / P25 / D-STAR (the DSD front end)
VO_DEV = 1_944.0              # the 4FSK outer deviation (the module's)
VO_DMR, VO_P25, VO_DSTAR = -600e3, -300e3, 150e3
VO_CTCSS, VO_DCS, VO_TETRA = 300e3, 450e3, 700e3
VO_DMR_CC = 7
VO_DMR_LC = (2350, 2310123)   # the voice superframe's embedded LC (tg, src)
VO_DMR_HDR = (91, 3120101)    # the voice LC header's full LC (tg, src)
VO_DMR_CSBK = (4197, 150587)  # the CSBK's (dst, src): BS_Dwn_Act
VO_DMR_SLC = (0x1, 0x00AB12)  # the CACH's short LC (opcode, data)
VO_P25_NAC = 0x293
VO_P25_LC = (4242, 31337)     # tests/test_e2e_synthetic_digital.py's LDU1
VO_P25_NET = (0xBEE00, 0x3A1)   # its NET_STS_BCST (WACN, system)
#: an IDEN_UP: identifier, bandwidth, the transmit offset's sign bit (0:
#: negative) and magnitude in channel spacings, the spacing and the base
#: frequency (units of 125 Hz and 5 Hz): 851.00625 MHz, -1.0 MHz
VO_IDEN = (1, 100, 0, 80, 100, 170_201_250)
VO_DSTAR_CALLS = ("DB0TPU G", "DB0TPU B", "CQCQCQ", "TP9UZT", "73")
VO_CTCSS_HZ = 100.0
VO_DCS_CODE = 0o023
VO_TETRA_CELL = (250, 13, 22)   # MCC, MNC, colour
VO_TETRA_SSI = 0x123456
VO_TETRA_TEXT = b"HELLO TPU"
VO_POCSAG = (0x15ABC8, "TPU PAGER OK")   # tests/test_pocsag.py's page
VO_TAGS = ("K4f", "K8", "K12c", "K13m", "K16")
VO_SEED = 31


def bits_msb(value: int, n: int) -> np.ndarray:
    return np.array([(value >> (n - 1 - i)) & 1 for i in range(n)],
                    np.uint8)


def air_of_bits(bits: np.ndarray) -> np.ndarray:
    """Bit pairs → on-air dibits (first bit the high one)."""
    bits = np.asarray(bits, np.uint8)
    return (bits[0::2] << 1 | bits[1::2]).astype(np.uint8)


def sync_air(name: str) -> np.ndarray:
    """A DSD sync word as on-air dibits ('1' = +3 = 01b, '3' = -3 = 11b)."""
    from sdrplusplusbrown_tpu_torch.models.dsd import SYNC_PATTERNS
    pat = dict((n, p) for n, p, _ in SYNC_PATTERNS)[name]
    return np.array([1 if c == "1" else 3 for c in pat], np.uint8)


def rs129_reversed_taps(data9) -> np.ndarray:
    """The JAX package's RS(12,9) parity rule (models/dmr_burst.py:493):
    the generator's taps applied in reversed order, for the printout
    beside the standard parity."""
    from sdrplusplusbrown_tpu_torch.models.dmr_burst import _RS_EXP, _RS_LOG
    g = [64, 56, 14, 1]
    reg = [0, 0, 0]
    for d in np.asarray(data9, np.int64):
        fb = int(d) ^ reg[0]
        reg = reg[1:] + [0]
        if fb:
            for i in range(3):
                reg[i] ^= int(_RS_EXP[_RS_LOG[g[i + 1]] + _RS_LOG[fb]])
    return np.array(reg, np.uint8)


def lc_octets(flco: int, dst: int, src: int) -> np.ndarray:
    return np.array([flco, 0, 0, dst >> 16, (dst >> 8) & 255, dst & 255,
                     src >> 16, (src >> 8) & 255, src & 255], np.uint8)


def dmr_air(rng, n: int) -> np.ndarray:
    """A DMR base station's n on-air dibits: random dibits carrying a voice
    superframe (embedded LC VO_DMR_LC, colour VO_DMR_CC) from dibit 2 400
    (0.5 s: the demod's slicer levels and clock settle over the first
    0.4 s),
    then four data bursts a TDMA frame apart (a voice LC header with the
    standard RS(12,9), a CSBK, a terminator with LC, an idle burst), their
    CACHs carrying the short LC VO_DMR_SLC (tests/test_dmr_burst.py's
    layouts)."""
    from sdrplusplusbrown_tpu_torch.models import dmr_burst as D
    air = rng.integers(0, 4, n).astype(np.uint8)
    frag = D.encode_embedded_lc(lc_octets(0, *VO_DMR_LC))
    a_end = 2400
    air[a_end - 23:a_end + 1] = sync_air("DMR_BS_VOICE")
    for k, lcss in enumerate([1, 3, 3, 2, 0], start=1):
        emb = np.zeros(16, np.uint8)
        emb[:4] = bits_msb(VO_DMR_CC, 4)
        emb[5:7] = bits_msb(lcss, 2)
        f = frag[32 * (k - 1):32 * k] if k <= 4 else np.zeros(32, np.uint8)
        e = a_end + 288 * k
        air[e - 23:e + 1] = air_of_bits(np.concatenate([emb[:8], f,
                                                        emb[8:]]))
    a = np.zeros(64, np.uint8)
    a[16:40] = bits_msb(VO_DMR_CSBK[0], 24)
    a[40:64] = bits_msb(VO_DMR_CSBK[1], 24)
    hdr = lc_octets(0, *VO_DMR_HDR)
    bursts = [(1, D.bptc_196_96_encode(D.encode_full_lc(hdr, 1))),
              (3, D.bptc_196_96_encode(D.encode_csbk(56, 0, a))),
              (2, D.bptc_196_96_encode(D.encode_full_lc(hdr, 2))),
              (9, None)]
    slc = D.encode_short_lc(*VO_DMR_SLC)
    for k, (dt, pay) in enumerate(bursts):
        e = a_end + 288 * 6 + 400 + 288 * k
        st = D.encode_slot_type(cc=VO_DMR_CC, data_type=dt)
        cach = D.encode_cach(1, 0, [1, 3, 3, 2][k], slc[17 * k:17 * k + 17])
        air[e - 89:e - 77] = air_of_bits(cach)
        if pay is not None:
            air[e - 77:e - 28] = air_of_bits(pay[:98])
            air[e + 6:e + 55] = air_of_bits(pay[98:])
        air[e - 28:e - 23] = air_of_bits(st[:10])
        air[e - 23:e + 1] = sync_air("DMR_BS_DATA")
        air[e + 1:e + 6] = air_of_bits(st[10:])
    return air


def p25_sync_nid(nac: int, duid: int) -> np.ndarray:
    """Sync + NID on-air dibits, the status dibit inserted
    (tests/test_e2e_synthetic_digital.py)."""
    from sdrplusplusbrown_tpu_torch.models import p25 as P
    cw = P.bch_63_16_encode((nac << 4) | duid)
    bits = [(cw >> (62 - i)) & 1 for i in range(63)] + [0]
    d = [bits[2 * k] * 2 + bits[2 * k + 1] for k in range(11)] + [1] + [
        bits[2 * k] * 2 + bits[2 * k + 1] for k in range(11, 32)]
    return np.concatenate([sync_air("P25P1"), np.asarray(d, np.uint8)])


def p25_tsbk_args(opcode: int) -> np.ndarray:
    """The 64 argument bits of VO_P25's TSBKs: the group voice grant, the
    NET_STS_BCST and the IDEN_UP."""
    a = np.zeros(64, np.uint8)
    if opcode == 0x00:
        a[8:24] = bits_msb(0x0C21, 16)
        a[24:40] = bits_msb(VO_P25_LC[0], 16)
        a[40:64] = bits_msb(VO_P25_LC[1], 24)
    elif opcode == 0x3B:
        a[8:28] = bits_msb(VO_P25_NET[0], 20)
        a[28:40] = bits_msb(VO_P25_NET[1], 12)
    else:
        iden, bw, sign, mag, spacing, base = VO_IDEN
        a[0:4] = bits_msb(iden, 4)
        a[4:13] = bits_msb(bw, 9)
        a[13:22] = bits_msb((sign << 8) | mag, 9)
        a[22:32] = bits_msb(spacing, 10)
        a[32:64] = bits_msb(base, 32)
    return a


def p25_air(rng, n: int) -> tuple:
    """A P25 Phase 1 station's n on-air dibits (NAC VO_P25_NAC): 1 200
    random dibits (the demod settles over them), then LDU1s
    with the link control VO_P25_LC, a TSDU of the voice grant and the
    NET_STS_BCST (last block), more LDU1s, a TSDU whose first block fails
    its trellis and whose second is the IDEN_UP (last block), LDU1s to the
    end; each frame followed by 40 random dibits.  (air, the dibit where
    the first TSDU ends, the dibit where the second begins)."""
    from sdrplusplusbrown_tpu_torch.models import p25 as P
    lcinfo = np.zeros(56, np.uint8)
    lcinfo[16:32] = bits_msb(VO_P25_LC[0], 16)
    lcinfo[32:56] = bits_msb(VO_P25_LC[1], 24)
    grant = P.encode_tsbk(0x00, 0x00, p25_tsbk_args(0x00))
    bad = grant.copy()
    bad[rng.choice(196, 40, replace=False)] ^= 1
    tsdus = [[grant, P.encode_tsbk(0x3B, 0x00, p25_tsbk_args(0x3B),
                                   lb=True)],
             [bad, P.encode_tsbk(0x3D, 0x00, p25_tsbk_args(0x3D),
                                 lb=True)]]
    frames, marks = [rng.integers(0, 4, 1200).astype(np.uint8)], []
    for i in range(64):
        if i in (2, 5):
            body = np.concatenate([p25_sync_nid(VO_P25_NAC, 0x7),
                                   P.encode_tsdu(tsdus[i == 5])])
            marks.append(sum(map(len, frames)) + (len(body) if i == 2
                                                  else 0))
        else:
            body = np.concatenate([p25_sync_nid(VO_P25_NAC, 0x5),
                                   P.encode_ldu1(0x00, 0x00, lcinfo, rng)])
        frames += [body, rng.integers(0, 4, 40).astype(np.uint8)]
        if sum(map(len, frames)) >= n:
            break
    return np.concatenate(frames)[:n], marks[0], marks[1]


def dstar_air(rng, n: int) -> np.ndarray:
    """A D-STAR station's n on-air dibits: random dibits (as
    tests/test_dmr_burst.py's stream) carrying two radio headers
    (VO_DSTAR_CALLS, outer symbols) after their header syncs, a voice
    sync after each."""
    from sdrplusplusbrown_tpu_torch.models import dstar as S
    air = rng.integers(0, 4, n).astype(np.uint8)
    rpt2, rpt1, ur, my, suffix = VO_DSTAR_CALLS
    hdr = S.encode_header(b"\x00\x00\x00", rpt2, rpt1, ur, my, suffix)
    hdr = np.where(hdr == 1, 3, 1).astype(np.uint8)
    for e in (2400, 5000):
        air[e - 23:e + 1] = sync_air("DSTAR_HD")
        air[e + 1:e + 1 + len(hdr)] = hdr
        v = e + len(hdr) + 400
        air[v - 23:v + 1] = sync_air("DSTAR_SYNC")
    return air


def fsk4_iq(air: np.ndarray, fs: float) -> np.ndarray:
    """On-air dibits → 4FSK (01 +3, 00 +1, 10 -1, 11 -3 at VO_DEV outer)
    with GFSKMod's gaussian (BT 0.5) frequency pulses at 10 samples a
    symbol, interpolated to ``fs`` and integrated: complex64 at ``fs``."""
    lvl = np.array([1 / 3, 1.0, -1 / 3, -1.0])[air]
    sps = 10
    fr = np.repeat(lvl, sps)
    t = (np.arange(4 * sps + 1) - 2 * sps) / sps
    sigma = np.sqrt(np.log(2)) / (2 * np.pi * 0.5)
    g = np.exp(-t * t / (2 * sigma * sigma))
    fr = np.convolve(fr, g / g.sum(), mode="same")
    n = int(len(air) * fs / VO_SYMRATE)
    f = np.interp(np.arange(n) * (VO_SYMRATE * sps / fs),
                  np.arange(len(fr)), fr)
    return np.exp(2j * np.pi * VO_DEV * np.cumsum(f) / fs).astype(
        np.complex64)


def fm_iq(dev_hz: np.ndarray, fs: float) -> np.ndarray:
    """A frequency track (Hz) at ``fs`` → the FM carrier."""
    return np.exp(2j * np.pi * np.cumsum(dev_hz) / fs).astype(np.complex64)


def nfm_tone_dev(n: int, fs: float, ctcss: float | None = None,
                 dcs: int | None = None) -> np.ndarray:
    """An NFM voice channel's frequency track: a 1 kHz tone at 0.4 of the
    outer deviation with the subaudible CTCSS tone (0.15) or the DCS code's
    NRZ at 134.366 bps (0.2), as in tests/test_dmr_burst.py's detector
    tests."""
    from sdrplusplusbrown_tpu_torch.ops.ctcss import DCS_BITRATE, \
        dcs_codeword
    t = np.arange(n) / fs
    a = 0.4 * np.sin(2 * np.pi * 1000.0 * t)
    if ctcss is not None:
        a += 0.15 * np.sin(2 * np.pi * ctcss * t)
    if dcs is not None:
        w = dcs_codeword(dcs)
        nrz = 2.0 * np.array([(w >> b) & 1 for b in range(23)]) - 1.0
        a += 0.2 * nrz[(t * DCS_BITRATE).astype(np.int64) % 23]
    return VO_DEV * a


def tetra_encode_sch(t1: np.ndarray, K: int, a: int, init: int):
    """Type-1 → type-5 bits of a TETRA signalling block (CRC, the rate-1/4
    K = 5 mother code, the rate-2/3 puncturing, block interleaving,
    scrambling): tests/test_tetra_mac.py's oracle."""
    from sdrplusplusbrown_tpu_torch.models import tetra as T
    r = T.crc16_itut(t1)
    t2 = np.concatenate([t1, bits_msb(r ^ 0xFFFF, 16), np.zeros(4,
                                                                np.uint8)])
    dd = np.zeros(4, np.int64)
    mom = []
    for b in t2:
        mom += [(b + dd[0] + dd[3]) % 2, (b + dd[1] + dd[2] + dd[3]) % 2,
                (b + dd[0] + dd[1] + dd[3]) % 2,
                (b + dd[0] + dd[2] + dd[3]) % 2]
        dd = np.roll(dd, 1)
        dd[0] = b
    mom = np.array(mom, np.uint8)
    j = np.arange(1, K + 1)
    blk = (j - 1) // 3
    t3 = mom[8 * blk + np.array((1, 2, 5))[(j - 3 * blk) - 1] - 1]
    t4 = np.zeros(K, np.uint8)
    t4[(a * j) % K] = t3
    return t4 ^ T.scramble_sequence(init, K)


def tetra_sds_bits(rng) -> np.ndarray:
    """tests/test_tetra_mac.py's fragmented SDS loopback as a downlink bit
    stream of 14 bursts: the BSCH of cell VO_TETRA_CELL, then a D-SDS-DATA
    (SSI VO_TETRA_SSI, VO_TETRA_TEXT) in MAC-RESOURCE + MAC-FRAG + MAC-END
    on SCH/HD in one timeslot of three consecutive frames; with ``rng``
    every bit the test's stream leaves 0 (the other bursts, and the
    fields of these four that it does not set) is a random one instead, as
    a scrambled downlink's are: long runs of one dibit leave the demod's
    clock recovery without a timing error to track."""
    from sdrplusplusbrown_tpu_torch.models import tetra as T
    mcc, mnc, colour = VO_TETRA_CELL
    init = T.cell_scramb_init(mcc, mnc, colour)
    data = np.unpackbits(np.frombuffer(VO_TETRA_TEXT, np.uint8))
    sdu = np.concatenate([bits_msb(0b0010, 4), bits_msb(2, 3),
                          bits_msb(15, 5), bits_msb(1, 2),
                          bits_msb(VO_TETRA_SSI, 24), bits_msb(3, 2),
                          bits_msb(len(data), 11), data])
    hdr = np.concatenate([bits_msb(0, 2), [0, 0], bits_msb(0, 2), [0],
                          bits_msb(63, 6), bits_msb(1, 3),
                          bits_msb(0xFFFFFF, 24), [0, 0, 0]]).astype(
        np.uint8)
    used = 124 - len(hdr)
    blocks = [np.concatenate([hdr, sdu[:used]])]
    rest = np.concatenate([sdu[used:], np.zeros(120, np.uint8)])[:120]
    blocks.append(np.concatenate([[0, 1, 0, 0], rest]).astype(np.uint8))
    left = max(0, len(sdu) - used - 120)
    li = (left + 7) // 8 if left else 1
    end = np.zeros(8 * li, np.uint8)
    end[:left] = sdu[used + 120:]
    blk = np.concatenate([[0, 1, 1, 1, 0], bits_msb(li, 6), [0, 0], end])
    blocks.append(np.concatenate([blk, np.zeros(124 - len(blk))]).astype(
        np.uint8))
    n_b = T.BURST_BITS
    stream = np.zeros(n_b * 14, np.uint8) if rng is None else \
        rng.integers(0, 2, n_b * 14).astype(np.uint8)

    def burst(i):
        return stream[i * n_b:(i + 1) * n_b]
    t1 = np.zeros(60, np.uint8)
    t1[4:10] = bits_msb(colour, 6)
    t1[31:41] = bits_msb(mcc, 10)
    t1[41:55] = bits_msb(mnc, 14)
    sb = burst(0)
    sb[T.SB_BLK1_OFF:T.SB_BLK1_OFF + 120] = tetra_encode_sch(
        t1, 120, 11, T.SCRAMB_INIT)
    sb[T.SB_SYNC_TRAIN_OFF:T.SB_SYNC_TRAIN_OFF + 38] = T.Y_BITS
    for i, b in enumerate(blocks):
        nb = burst(1 + 4 * i)
        nb[T.NDB_BLK1_OFF:T.NDB_BLK1_OFF + 216] = tetra_encode_sch(
            b, 216, 101, init)
        nb[T.NDB_TRAIN_OFF:T.NDB_TRAIN_OFF + 22] = T.P_BITS
    return stream


def tetra_dibits(bits: np.ndarray) -> np.ndarray:
    """TETRA bit pairs → the demod's dibits (the inverse of
    models/tetra.py:dibits_to_bits: 00→0, 01→1, 11→2, 10→3)."""
    return np.array([0, 1, 3, 2], np.int64)[air_of_bits(bits)]


def tetra_downlink_bits(rng, copies: int) -> np.ndarray:
    """The TETRA downlink of phase 31: 128 random bits (the demod settles
    over them), then ``copies`` of ``tetra_sds_bits(rng)``."""
    return np.concatenate([rng.integers(0, 2, 128).astype(np.uint8)] + [
        tetra_sds_bits(rng) for _ in range(copies)])


def pi4_iq(bits: np.ndarray, fs: float) -> np.ndarray:
    """A TETRA bit stream → π/4-DQPSK at 18 k symbols/s, RRC (β 0.35)
    shaped to ``fs``: the demod's dibit k is the differential phase
    (2k + 1)·π/4 (ops/demod_digital.py: ⌊∠d / (π/2)⌋ mod 4)."""
    k = tetra_dibits(bits)
    sym = np.exp(1j * np.cumsum((2 * k + 1) * np.pi / 4))
    return _shaped(sym.astype(np.complex64), 18_000.0, fs, 0.35, 31)


def voice_capture(path: str | None, fs: float = VO_FS,
                  seconds: float = VO_SECONDS, channels=None) -> dict:
    """Phase 31's capture: ``seconds`` at ``fs`` holding the DMR, P25 and
    D-STAR stations, the CTCSS and DCS carriers and the TETRA downlink
    (``channels``: {name: offset}, all of them by default), each at its
    offset in noise; written to ``path`` (a 32-bit WAV) when given.
    Returns {"iq", "p25_marks": (the second where the first TSDU ends,
    where the second begins)}."""
    rng = np.random.default_rng(VO_SEED)
    if channels is None:
        channels = {"DMR": VO_DMR, "P25": VO_P25, "DSTAR": VO_DSTAR,
                    "CTCSS": VO_CTCSS, "DCS": VO_DCS, "TETRA": VO_TETRA}
    n = int(fs * seconds)
    n_sym = int(seconds * VO_SYMRATE) + 1
    x = np.zeros(n, np.complex128)
    k = np.arange(n)
    out = {}
    for name, off in channels.items():
        if name == "DMR":
            sig = fsk4_iq(dmr_air(rng, n_sym), fs)
        elif name == "P25":
            air, end1, start2 = p25_air(rng, n_sym)
            out["p25_marks"] = (end1 / VO_SYMRATE, start2 / VO_SYMRATE)
            sig = fsk4_iq(air, fs)
        elif name == "DSTAR":
            sig = fsk4_iq(dstar_air(rng, n_sym), fs)
        elif name in ("CTCSS", "DCS"):
            sig = fm_iq(nfm_tone_dev(n, fs, ctcss=VO_CTCSS_HZ if
                                     name == "CTCSS" else None,
                                     dcs=VO_DCS_CODE if name == "DCS"
                                     else None), fs)
        else:
            reps = int(np.ceil(seconds * 36_000 / (14 * 510)))
            sig = pi4_iq(tetra_downlink_bits(rng, reps), fs)
        m = min(n, len(sig))
        x[:m] += 0.2 * sig[:m] * np.exp(2j * np.pi * off * k[:m] / fs)
    x += VO_NOISE * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    out["iq"] = x.astype(np.complex64)
    if path is not None:
        from sdrplusplusbrown_tpu_torch.io.wav import write_wav
        write_wav(path, out["iq"], fs, bits=32)
    return out


#: the loop kernels' names in a profiler window (K12c, K13m, K16)
VO_LOOP_NAMES = ("agc_rows_kernel", "mm_kernel", "viterbi_warp_kernel",
                 "viterbi_kernel")
#: on the host CPU the TETRA module's plain loops take about 12 ms a
#: granule (1 600 samples): the CPU app's TETRA module stops at the mid
#: read, where both apps' TETRA products are held
VO_CPU_TETRA = "TETRA"
VO_CPU_THREADS = 2            # the host CPU app's torch threads
VO_LOOP_TAGS = ("K12c", "K13m", "K16")


def drive_voice(dev, card: str, report: dict) -> None:
    """Phase 31: (b) the voice and trunking decoders served by one app on
    the card (one ``ch_extravhf_decoder`` a channel, one
    ``ch_tetra_demodulator``), their products held and held equal to the
    same app's on the host CPU, the loop kernels' calls captured by
    module; (c) each module's device time and launches a 0.1 s block and
    its host share; (a) K13m, K12c and K16 at the voice paths' shapes
    against their plain versions; POCSAG on the card's GFSK demod."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vo_") as tmp:
        calls, card_st, cpu = voice_app(dev, card, report, tmp)
        try:
            t1 = time.perf_counter()
            voice_kernels(calls, dev, card, report)
            t2 = time.perf_counter()
            pocsag_on_card(dev, card, report)
            t3 = time.perf_counter()
        except BaseException:
            cpu.kill()
            raise
        voice_on_host(card_st, cpu.finish())
    t4 = time.perf_counter()
    print(f"phase 31: {t4 - t0:.1f} s ((b) and (c) {t1 - t0:.1f}, (a) "
          f"{t2 - t1:.1f}, POCSAG {t3 - t2:.1f}, the rest of the host CPU "
          f"app's run {t4 - t3:.1f}) [{card}]")


def voice_config(capture: str) -> dict:
    """Phase 31's config.json: the capture through a file source, fft
    65 536 at 20 fps, manual pump, a module a channel."""
    mods = {n: {"type": "ch_extravhf_decoder", "offset": off} for n, off in (
        ("DMR", VO_DMR), ("P25", VO_P25), ("DSTAR", VO_DSTAR),
        ("CTCSS", VO_CTCSS), ("DCS", VO_DCS))}
    mods["TETRA"] = {"type": "ch_tetra_demodulator", "offset": VO_TETRA}
    return {"source": {"type": "file", "path": capture, "loop": False},
            "fftSize": FFT, "fftRate": 20, "pump": "manual",
            "modules": mods}


def voice_statuses(app) -> dict:
    """Every module's status, as JSON gives it back (lists for tuples)."""
    return json.loads(json.dumps({n: m.handle_debug_command("status", "")
                                  for n, m in app.modules.items()}))


def voice_cpu_main() -> None:
    """Phase 31's app on the host CPU as a process of its own:
    ``python3 -c "import chip_smoke; chip_smoke.voice_cpu_main()" CAPTURE
    MID OUT``: ``voice_pump`` on the capture with ``MID`` blocks to the
    mid read, its statuses to OUT as JSON."""
    import tempfile
    import torch
    cap, mid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(VO_CPU_THREADS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vocpu_") as tmp:
        app = new_app(tmp, voice_config(cap), "cpu")
        try:
            first, end, blocks = voice_pump(app, mid)
        finally:
            app.shutdown()
    with open(out, "w") as f:
        json.dump({"first": first, "end": end, "blocks": blocks,
                   "seconds": time.perf_counter() - t0}, f)


class VoiceCpuProcess:
    """``voice_cpu_main`` in a subprocess; ``finish()`` waits for it and
    returns what it wrote."""

    def __init__(self, cap: str, mid: int, out: str):
        self.out = out
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             "chip_smoke.voice_cpu_main()", cap, str(mid), out],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL)

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=10)

    def finish(self) -> dict:
        try:
            rc = self.proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
            fail("phase 31: the host CPU app did not end within 300 s")
        if rc != 0:
            fail(f"phase 31: the host CPU app exited with {rc}")
        with open(self.out) as f:
            return json.load(f)


def voice_pump(app, mid: int) -> tuple:
    """Start the app, pump ``mid`` blocks, read every module's status,
    pump to the capture's end, read again: (mid statuses, end statuses,
    blocks).  On the host CPU the TETRA module stops at the mid read
    (VO_CPU_TETRA)."""
    app.start()
    if app.pump_step(mid) != mid:
        fail("phase 31: the pump stopped")
    first = voice_statuses(app)
    if app.device.type == "cpu":
        app.modules[VO_CPU_TETRA].disable()
    rest = app.pump_step(10 ** 6)
    return first, voice_statuses(app), mid + rest


def module_calls(tags, by_module: dict, name: str, h):
    """Module ``name``'s baseband handler ``h`` under ``capture``: the
    calls of ``tags`` that each of its calls makes go to
    ``by_module[name][tag]``."""
    def handler(iq):
        n0 = {t: len(capture_log.get(t, ())) for t in tags}
        h(iq)
        for t in tags:
            by_module.setdefault(name, {}).setdefault(t, []).extend(
                capture_log.get(t, [])[n0[t]:])
    return handler


def joined_call(tag: str, calls, k: int, suffix: str = "_kernel"):
    """K12c's or K13m's first ``k`` consecutive calls of one module as one
    call: their inputs side by side from the first call's state.  Each
    call must start from the state the one before returned (``suffix``'s
    function run on it), bit for bit; fails otherwise."""
    import torch
    fn = getattr(*kernel_fn(tag, suffix))
    for i in range(k - 1):
        got = flat(loop_state(tag, fn(*calls[i])))
        want = flat(calls[i + 1][2:4] if tag == "K12c" else calls[i + 1][2])
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"phase 31 (a): {tag}'s call {i + 1} does not start from "
                 f"the state call {i} returned")
    x = torch.cat([loop_input(tag, c) for c in calls[:k]], dim=1)
    return (calls[0][0], x.contiguous(), *calls[0][2:])


def voice_products(st: dict, mid: dict, marks) -> list:
    """(what, got, want) of every product phase 31 holds, from the end
    statuses ``st`` and the mid read ``mid``."""
    dmr, p25m, p25e = st["DMR"], mid["P25"]["p25"], st["P25"]["p25"]
    ds, te, tm = st["DSTAR"]["dstar"], st["TETRA"], mid["TETRA"]

    def lc(d):
        return None if d is None else (d["dst"], d["src"])

    def tsbk(d, keys):
        return None if d is None else tuple(d.get(k) for k in keys)

    def cell(t):
        c = t["cell"]
        return None if c is None else (c["mcc"], c["mnc"], c["colour"])

    def sdu(t):
        s = t["last_tm_sdu"]
        return None if s is None else (s.get("callingSsi"), bytes.fromhex(
            s.get("userData", "")))
    hdr = ds["lastHeader"] or {}
    return [
        ("DMR embedded LC (tg, src)", lc(dmr["lastLC"]), VO_DMR_LC),
        ("DMR colour code", dmr["colorCode"], VO_DMR_CC),
        ("DMR short LC (opcode, data)", tsbk(dmr["lastShortLC"], (
            "opcode", "data")), VO_DMR_SLC),
        ("DMR CSBK (name, dst, src)", tsbk(dmr["lastCSBK"], (
            "csbkoName", "dst", "src")), ("BS_Dwn_Act",) + VO_DMR_CSBK),
        ("DMR voice LC header and terminator decoded (RS(12,9))",
         (dmr["burstTypes"].get("VOICE Header", 0), dmr["fullLcDecodes"]),
         (1, 2)),
        ("DMR full LC (tg, src)", lc(dmr["lastFullLC"]), VO_DMR_HDR),
        ("P25 NAC", p25e["nac"], VO_P25_NAC),
        ("P25 LDU1 LC (tg, src)", tsbk(p25e["lastLC"], ("talkgroup", "src")),
         VO_P25_LC),
        (f"P25 TSBK at the mid read (after the TSDU ending at "
         f"{marks[0]:.3f} s, before the one at {marks[1]:.3f} s)",
         tsbk(p25m["lastTSBK"], ("opcodeName", "wacn", "sysId")),
         ("NET_STS_BCST",) + VO_P25_NET),
        ("P25 last TSBK (its TSDU's first block bad): IDEN_UP (tx offset "
         "MHz, spacing kHz, base MHz)", tsbk(p25e["lastTSBK"], (
             "opcodeName", "txOffsetMhz", "spacingKhz", "baseFreqMhz")),
         ("IDEN_UP", -1.0, 12.5, 851.00625)),
        ("D-STAR headers with crc_ok", ds["headerCrcOk"], 2),
        ("D-STAR callsigns", tuple(hdr.get(k) for k in (
            "rpt2", "rpt1", "ur", "my", "suffix")), VO_DSTAR_CALLS),
        ("CTCSS tone", st["CTCSS"]["ctcss"]["tone"], VO_CTCSS_HZ),
        ("DCS code (inverted)", (st["DCS"]["dcs"]["code"],
                                 st["DCS"]["dcs"]["inverted"]),
         (f"{VO_DCS_CODE:03o}", False)),
        ("TETRA sync decodes > 0", te["sync_decodes"] > 0, True),
        ("TETRA cell at the mid read (MCC, MNC, colour)", cell(tm),
         VO_TETRA_CELL),
        ("TETRA TM-SDU at the mid read (SSI, text)", sdu(tm),
         (VO_TETRA_SSI, VO_TETRA_TEXT)),
        ("TETRA cell (MCC, MNC, colour)", cell(te), VO_TETRA_CELL),
        ("TETRA TM-SDU (SSI, text)", sdu(te), (VO_TETRA_SSI, VO_TETRA_TEXT)),
    ]


def voice_summary(st: dict) -> dict:
    """An ExtraVHF status less its two rounded float readings (the CTCSS
    ratio and the DCS bit error rate: the card's and the host's audio
    agree to rounding, which can move a rounded figure; they are printed
    beside)."""
    out = dict(st)
    if "ctcss" in out:
        out["ctcss"] = {k: v for k, v in out["ctcss"].items()
                        if k != "ratio_db"}
        out["dcs"] = {k: v for k, v in out["dcs"].items() if k != "ber"}
    return out


def voice_stages(name: str, mod) -> list:
    """(owner, attribute) of a voice module's host stages, to time."""
    if name == "TETRA":
        return [(mod.decoder, "push")]
    return [(mod.burst, "push"), (mod.ctcss, "take"), (mod.dcs, "push")]


def voice_app(dev, card: str, report: dict, tmp: str) -> tuple:
    """(b) and (c): the served app on the card, its products held, then
    the same app started on the host CPU in a process of its own
    (``VoiceCpuProcess``, while (c), (a) and POCSAG run); returns (the
    loop kernels' calls by module, the card's statuses, that process)."""
    import contextlib
    import torch
    from sdrplusplusbrown_tpu_torch.runtime.pump import Rechunker
    cap = os.path.join(tmp, "baseband_460000000Hz_10-00-00_01-01-2024.wav")
    t0 = time.perf_counter()
    marks = voice_capture(cap)["p25_marks"]
    mid = int(np.ceil((marks[0] + 0.15) * 20))
    if (mid + 1) * 0.05 >= marks[1]:
        fail(f"phase 31: no mid read between the TSDUs {marks}")
    print(f"phase 31 (b): capture {VO_SECONDS} s at {VO_FS / 1e6:g} MS/s "
          f"made in {time.perf_counter() - t0:.1f} s: DMR at "
          f"{VO_DMR / 1e3:g} kHz, P25 {VO_P25 / 1e3:g}, D-STAR "
          f"{VO_DSTAR / 1e3:g}, NFM with CTCSS {VO_CTCSS_HZ} Hz "
          f"{VO_CTCSS / 1e3:g}, NFM with DCS {VO_DCS_CODE:03o} "
          f"{VO_DCS / 1e3:g}, TETRA {VO_TETRA / 1e3:g}; the mid read after "
          f"block {mid}")
    app = new_app(os.path.join(tmp, "p31"), voice_config(cap), dev)
    per_module: dict = {}
    by_module: dict = {}
    cpu = None
    try:
        wrappers = {t: getattr(*kernel_fn(t, "_kernel")) for t in KERNELS}
        ev = app.baseband_event
        ev._handlers = [module_calls(
            VO_LOOP_TAGS, by_module,
            getattr(getattr(h, "__self__", None), "name", "?"),
            counted_handler(h, per_module, wrappers)) for h in ev._handlers]
        reset_counts()
        with contextlib.ExitStack() as stack:
            stack.enter_context(no_plain_on_card())
            hs = {n: stack.enter_context(timed_stages(voice_stages(n, m)))
                  for n, m in app.modules.items()}
            (first, end, blocks), capd = capture(
                tuple(KERNELS), lambda: voice_pump(app, mid))
            torch.cuda.synchronize()
        counts = {t: kernel_count(t) for t in KERNELS}
        block_len = app.pump_block_len
        # the same app on the host CPU from here on, beside (c), (a) and
        # POCSAG; (b)'s wall and host times are taken
        cpu = VoiceCpuProcess(cap, mid, os.path.join(tmp, "p31cpu.json"))
        # (c): each module's device time from a fresh rechunker, scaled to
        # a 0.1 s block: an ExtraVHF module's 0.1 s block (one call), 0.05
        # s of TETRA's (75 granules: the profiler's windows of its 150
        # granules' 12 700 launches took most of a minute)
        dev_us = {}
        for n, m in app.modules.items():
            span = 0.05 if n == VO_CPU_TETRA else 0.1
            chunk = read_capture_block(cap, 0, int(VO_FS * span))
            m.feed.rc = m.rc = Rechunker(m.rc.out_len)
            by, cnt = {}, {}
            us, nl = call_profile(lambda m=m: m._on_baseband(chunk),
                                  1 if n == VO_CPU_TETRA else 3,
                                  by_kernel=by, counts=cnt)
            k = 0.1 / span
            dev_us[n] = (us * k, nl * k, {t: v * k for t, v in by.items()})
    except BaseException:
        if cpu is not None:
            cpu.kill()
        raise
    finally:
        app.shutdown()
    try:
        return voice_report(dev, card, report, counts, capd, blocks,
                            block_len, first, end, marks, per_module, hs,
                            dev_us, by_module, cpu)
    except BaseException:
        cpu.kill()
        raise


def voice_report(dev, card, report, counts, capd, blocks, block_len, first,
                 end, marks, per_module, hs, dev_us, by_module, cpu):
    """(b)'s launches and products held, (c)'s measurements printed;
    returns ``voice_app``'s result."""
    from sdrplusplusbrown_tpu_torch.models import dmr_burst as D
    tag_counts = {t: counts[t] for t in VO_TAGS}
    hold_launches(f"phase 31 (b), served voice decoders, {blocks} blocks",
                  tag_counts, capd)
    others = {t: c for t, c in counts.items() if c and t not in VO_TAGS}
    if min(tag_counts.values()) < 1 or others:
        fail(f"phase 31 (b): launch pattern {counts}")
    print(f"phase 31 (b): served app on {dev} ({block_len}-sample blocks, "
          f"fft {FFT}), {blocks} blocks: launches " + ", ".join(
              f"{t}={counts[t]}" for t in VO_TAGS) + ", every other kernel 0")
    for t in VO_TAGS:
        report.setdefault(t, {}).setdefault("launches_by_path", {})[
            f"served voice decoders ({blocks} blocks)"] = counts[t]
    bad = []
    for what, got, want in voice_products(end, first, marks):
        print(f"phase 31 (b): {what}: {got}" + ("" if got == want else
                                                f" -- want {want}"))
        if got != want:
            bad.append(what)
    hdr = lc_octets(0, *VO_DMR_HDR)
    std, rev = D.rs_12_9_parity(hdr), rs129_reversed_taps(hdr)
    print(f"phase 31 (b): the voice LC header's RS(12,9) parity "
          f"{std.tolist()} (standard); the JAX package's rule would give "
          f"{rev.tolist()}, {'not ' if std.tolist() != rev.tolist() else ''}"
          "the same (not held)")
    iden, bw, sign, mag, spacing, base = VO_IDEN
    print(f"phase 31 (b): the IDEN_UP's transmit offset field "
          f"0x{(sign << 8) | mag:03x} read unsigned in 0.25 MHz, the JAX "
          f"package's rule, would be {((sign << 8) | mag) * 0.25} MHz (not "
          "held)")
    if bad:
        fail(f"phase 31 (b): products {bad}")
    # (c)
    for n, m_us in dev_us.items():
        us, nl, by = m_us
        e = per_module.get(n, {"calls": 0, "launches": {}, "wall": 0.0})
        loops = sum(v for k, v in by.items() if k in VO_LOOP_NAMES)
        own = sum(e["launches"].values())
        print(f"phase 31 (c): module {n}: {e['calls']} baseband calls, own "
              f"kernel launches " + (", ".join(
                  f"{t}={c}" for t, c in e["launches"].items()) or "none")
              + f" ({own / blocks:.1f} a 50 ms block); a 0.1 s block: "
              f"device {us:.1f} us in {nl:.0f} launches (" + ", ".join(
                  f"{k} {v:.1f}" for k, v in sorted(
                      by.items(), key=lambda kv: -kv[1])[:6])
              + f"), the loop kernels {loops:.1f} us "
              f"({100 * loops / us if us else 0.0:.1f} %); the handler's "
              f"wall {e['wall'] / VO_SECONDS:.4f} s a second of signal, its "
              f"host stages {hs[n].seconds / VO_SECONDS:.4f} s [{card}]")
    return by_module, {"first": first, "end": end, "blocks": blocks,
                       "marks": marks}, cpu


def voice_on_host(card_st: dict, cpu_st: dict) -> None:
    """(b)'s products on the card against the same app's on the host CPU:
    every product of ``voice_products`` equal (the TETRA module's at the
    mid read, where the host's stops); whether every module's whole
    status is equal too (but the two rounded float readings,
    ``voice_summary``) is printed, with those readings side by side."""
    first, end, marks = card_st["first"], card_st["end"], card_st["marks"]
    cfirst, cend = cpu_st["first"], cpu_st["end"]

    def held(items):
        return [(w, g) for w, g, _ in items
                if not (w.startswith("TETRA") and "mid read" not in w)]
    card_p = held(voice_products(end, first, marks))
    host_p = held(voice_products(cend, cfirst, marks))
    diff = [w for (w, g), (_, h) in zip(card_p, host_p) if g != h]
    same = [n for n in end if n != VO_CPU_TETRA
            and voice_summary(end[n]) == voice_summary(cend[n])] + [
        f"{n} at the mid read" for n in first
        if voice_summary(first[n]) == voice_summary(cfirst[n])]
    for n in end:
        if "ctcss" in end[n]:
            print(f"phase 31 (b): {n}: the rounded readings, card / host "
                  f"CPU: CTCSS ratio {end[n]['ctcss']['ratio_db']} / "
                  f"{cend[n]['ctcss']['ratio_db']} dB, DCS bit error rate "
                  f"{end[n]['dcs']['ber']} / {cend[n]['dcs']['ber']}")
    print(f"phase 31 (b): the same app on the host CPU ({cpu_st['blocks']} "
          f"blocks in {cpu_st['seconds']:.1f} s, {VO_CPU_THREADS} torch "
          f"threads, its TETRA module to the mid read): {len(card_p)} "
          f"products equal to the card's: " + ("yes" if not diff else
                                               f"NO ({diff})")
          + f"; whole statuses equal (not held): {len(same)} of "
          f"{2 * len(end) - 1} ({sorted(same)})")
    if diff or cpu_st["blocks"] != card_st["blocks"]:
        for w in diff:
            print(f"phase 31 (b): {w}: card {dict(card_p)[w]}, host CPU "
                  f"{dict(host_p)[w]}")
        fail(f"phase 31 (b): the card's products are not the host CPU's: "
             f"{diff}, blocks {card_st['blocks']} / {cpu_st['blocks']}")


def voice_kernels(by_module: dict, dev, card: str, report: dict) -> None:
    """(a): the loop kernels at the voice paths' shapes, on (b)'s served
    calls: K13m's real form at DMR's 0.1 s block (1 600 samples, 3.33 a
    symbol), K12c and K13m's complex form at TETRA's granule (24
    samples) and at 0.1 s (150 granules' inputs side by side,
    ``joined_call``), each clocked at the shape and held to its plain
    version on two blocks of that shape, the second from the state the
    kernel returned (every output and state bit for bit; K12c's output
    100 dB; K13m's plain version on a host CPU copy); K16 at K = 3 on a
    D-STAR header with correctable errors, timed beside its plain
    version, and on (b)'s last served header."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import dstar as S
    dmr = by_module.get("DMR", {}).get("K13m", [])
    tet = by_module.get("TETRA", {})
    if len(dmr) < 4 or len(tet.get("K12c", [])) < 700 or \
            len(tet.get("K13m", [])) < 700:
        fail(f"phase 31 (a): served calls DMR K13m {len(dmr)}, TETRA "
             f"{ {t: len(v) for t, v in tet.items()} }")
    cases = [("K13m", dmr[-3:], 1, 1600, "DMR's clock recovery (real, "
              "3.33 a symbol), a 0.1 s block")]
    for tag in ("K12c", "K13m"):
        cs = tet[tag][-700:]
        what = "TETRA's AGC" if tag == "K12c" else \
            "TETRA's clock recovery (complex, 2 a symbol)"
        cases += [(tag, cs, 1, 24, f"{what}, a granule"),
                  (tag, cs, 150, 3600, f"{what}, 0.1 s (150 granules)")]
    for tag, cs, k, n, what in cases:
        one = joined_call(tag, cs, k) if k > 1 else cs[0]
        if loop_input(tag, one).shape[1] != n:
            fail(f"phase 31 (a): {what}: {loop_input(tag, one).shape}")
        loop_at_shape(tag, one, card, what, "phase 31 (a)")
        two = joined_call(tag, cs, 2 * k)
        err = loop_prefix(tag, two, n, card, what)
        report[tag]["max_abs_err"] = max(report[tag]["max_abs_err"], err)
    # K16: a D-STAR header with 6 channel errors, descrambled and
    # deinterleaved as models/dstar.py:decode_header does
    bits = S.encode_header(b"\x00\x00\x00", *VO_DSTAR_CALLS)
    rx = bits.copy()
    rx[np.random.default_rng(VO_SEED).choice(S.HEADER_BITS, 6,
                                             replace=False)] ^= 1
    deint = np.empty(S.HEADER_BITS, np.float32)
    deint[S.deinterleave_indices()] = rx ^ S.scramble_sequence(
        S.HEADER_BITS)
    call = (torch.from_numpy(deint[None]).to(dev), 0b111, 0b101, 3)
    out = check_loop_kernel("K16", call, card, "a D-STAR header with 6 "
                            "channel errors, K = 3", timed=True)
    got = S.decode_header(rx, device=dev)
    print(f"phase 31 (a): that header decoded on the card: crc_ok "
          f"{got['crc_ok']}, MY {got['my']!r}")
    if not got["crc_ok"] or got["my"] != VO_DSTAR_CALLS[3]:
        fail(f"phase 31 (a): the D-STAR header with errors: {got}")
    served = by_module.get("DSTAR", {}).get("K16", [])
    if not served:
        fail("phase 31 (a): no K16 call from the D-STAR module")
    err = check_loop_kernel("K16", served[-1], card, "the served D-STAR "
                            "header", timed=False)["max_abs_err"]
    report["K16"]["max_abs_err"] = max(report["K16"]["max_abs_err"], err,
                                       out["max_abs_err"])


def pocsag_on_card(dev, card: str, report: dict) -> None:
    """POCSAG (no module in the JAX package): tests/test_pocsag.py's RF
    loopback, the page VO_POCSAG at 1 200 Bd, ±4.5 kHz on 24 kS/s with
    noise, through ``GFSKDemod`` on the card in 0.1 s blocks (K8, K13m's
    real form, 20 samples a symbol; the counts zeroed before), its hard
    bits to the host ``POCSAGDecoder``: the page held."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.pocsag import POCSAGDecoder, \
        encode_transmission
    from sdrplusplusbrown_tpu_torch.ops.demod_digital import GFSKDemod
    from sdrplusplusbrown_tpu_torch.ops.digital import valid_hard_bits
    from sdrplusplusbrown_tpu_torch.ops.mod import GFSKMod
    from sdrplusplusbrown_tpu_torch.runtime.block import to_device
    fs, baud, devhz = 24_000.0, 1_200.0, 4_500.0
    bits = np.concatenate([encode_transmission(*VO_POCSAG),
                           np.tile([1, 0], 32).astype(np.uint8)])
    nrz = (1.0 - 2.0 * bits).astype(np.float32).repeat(int(fs / baud))
    mod = GFSKMod(fs, devhz, baud, bt=0.5)
    tx, _ = mod.apply(None, mod.init_state(()), torch.from_numpy(nrz))
    rng = np.random.default_rng(12345)
    T = tx.shape[-1]
    ch = (tx.numpy() * np.exp(1j * 0.4) + 0.05 * (
        rng.standard_normal(T) + 1j * rng.standard_normal(T))).astype(
        np.complex64)
    dem = GFSKDemod(baud, fs, devhz)
    st = to_device(dem.init_state(()), dev)
    blk = int(fs // 10)
    ch = np.concatenate([ch, np.zeros((-T) % blk, np.complex64)])
    hard = []
    reset_counts()
    with no_plain_on_card():
        for i in range(0, len(ch), blk):
            (sym, valid), st = dem.apply(None, st, torch.from_numpy(
                ch[i:i + blk]).to(dev))
            hard.append(1 - valid_hard_bits(sym, valid))
        torch.cuda.synchronize()
    counts = {t: kernel_count(t) for t in KERNELS if kernel_count(t)}
    dec = POCSAGDecoder()
    dec.push_bits(np.concatenate(hard))
    msgs = [(m["address"], m["text"]) for m in dec.messages]
    print(f"phase 31: POCSAG, {len(ch)} samples at 24 kS/s in "
          f"{len(ch) // blk} blocks on the card: launches " + ", ".join(
              f"{t}={c}" for t, c in counts.items()) + f"; pages {msgs}")
    if set(counts) != {"K8", "K13m"} or msgs[:1] != [VO_POCSAG]:
        fail(f"phase 31: POCSAG: {counts}, {msgs}")
    for t in ("K8", "K13m"):
        report[t].setdefault("launches_by_path", {})[
            f"POCSAG ({len(ch) // blk} blocks)"] = counts[t]

if __name__ == "__main__":
    sys.exit(main())
