#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cudavolumerenderer_tpu_torch) on
one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU or to a plain version on a CUDA tensor):

1. identify the card (nvidia-smi name and power limit); refuse to run
   without CUDA; check that torch.sqrt on CUDA float32 is correctly
   rounded on 2^21 inputs (ops/math3.sqrt relies on it there), and the
   two rules of torch's CUDA ops the body kernel follows (a sum over 3 is
   (x0 + x2) + x1; x / c is x * float32(1 / c));
2. build the nine kernel libraries, csrc/tailpk.cu (the tail kernel and
   the tail stage's drain), csrc/tracking.cu, csrc/pgather.cu,
   csrc/fastbody.cu, csrc/replaybody.cu, csrc/familybody.cu,
   csrc/brickbody.cu, csrc/fastqbody.cu and csrc/nestedreplay.cu, with one
   nvcc each, started
   together with g++ on the native data-path library (the repository's csrc/cvr_native.cpp
   and csrc/cvr_vdb.cpp), all into the package's ignored _build/
   directory; print the build times and ptxas registers and spills;
3. the tail kernel against its plain torch version on the card, on the
   medical 256^3 dilated-brick table with R = 128 and R = 4096 paths at
   K = 16 steps: integer outputs equal on >= 99.9% of paths, floats
   allclose (rtol 1e-5, atol 1e-6) on those; the status histogram, and
   per path the steps and scatters the plain version takes (one step at
   a time) and the rounds the kernel needs for them; the kernel's device
   time per call from replays of a CUDA graph of 16 calls, the plain
   version's with CUDA events around eager calls; the bound from the
   bytes the call moves (state rows, and the table words its taps read,
   counted from the plain version's taps) and a lower count of its
   operations; the step sweep (R = 128, K = 1, 2, 4, 8, 16: the slope is
   the time of a step); the kernel's ptxas registers, spills and shared
   memory;
4. white furnace through the tail stage's drain and through its eager
   loop's tail kernel (every pixel == spp, rtol 2e-5), and a small render
   on the card against the same render on the CPU;
5. the slice: BASELINE config 2 (medical 256^3 MHD, red-channel albedo,
   scale 100, 512^2 x 4 iterations, one tile) through load_scene and
   create_renderer(...).render() with fastSK two-level and the tail
   kernel on, every cascade stage gated chains of the body kernel
   (csrc/fastbody.cu) and the tail stage one drain launch (csrc/tailpk.cu's
   drain_kernel): three renders timed with the image copy to the host, the
   counts set to 0 just before the first and read just after it (one drain
   launch, one host read of the tail stage, no tail-kernel launch); one
   more with torch.profiler over the tail stage alone (the drain's device
   time, and the card's busy share: the union of the device intervals over
   the stage's wall); then the slice with the tail stage's eager loop (its
   eager_body=True path; a tail-kernel launch and a host read a round),
   with torch.profiler over its tail rounds 100-159 (the kernel's device
   time per launch at the slice's own state, the busy share as above) and
   the inputs of round 130 kept (the kernel against its plain version on
   them, their paths traced, and timed as in phase 3): both runs give the
   6,040,005 rays of the kernel's first design, the same n_rows and
   n_busy, bit-equal images and tail-stage states; walls, drain launches,
   host reads and tail-kernel launches of both;
6. the tracking kernel against its plain torch version on the brickSK
   slice's own dilated table (smoke 128x128x50, scale 800) with R = 8
   and R = 1,250 rows at K = 8 and K = 32 steps: integer outputs equal on
   >= 99.9% of lanes, t allclose (rtol 1e-5, atol 1e-6) on those; timed
   and bounded as in phase 3, and at R = 1,250, K = 8 also timed with cold
   inputs;
7. white furnace through brickSK's round kernels (csrc/brickbody.cu) on
   the card (every pixel == spp), and a small brickSK render on the card
   against the same render on the CPU;
8. the brickSK slice (the smoke class of benchmarks/micro_smoke_brick.py:
   smoke 128x128x50, albedo 0.9 d, scale 800, written as Mitsuba XML +
   .vol files like BASELINE config 4) through the CLI's batch mode:
   -k brickSK -i 4 -r 400 400, one trial, timed with the image copy,
   brick.render_tile (the function make_kernel_fn returns) wrapped to count
   its rounds and keep its image: once through the round kernels (phase A,
   torch's stable sort and the round launch per round, gated batches with
   a host read per batch; the kernels' counts set to 0 just before and
   read just after) and once with eager_body=True (the eager loop, the
   tracking kernel once per round): both exactly 1,151,411 rays and the
   same rounds, the images bit-equal; walls, launches, sorts and host
   reads of both;
9. each of the five gather kernels (csrc/pgather.cu) against its plain
   torch version at the gather benchmark's published shapes (67 MB
   table, N = 262,144, S = 16): bit-equal outputs; the kernel, its plain
   version and the one torch call that computes the same function (its
   yardstick, library_ms) each timed per call by CUDA events around
   replays of a CUDA graph of 16 back-to-back calls on the same inputs,
   so the wrapper's host time stays out (kernel and yardstick twice, in
   turns); for every gather kernel also cold, a graph of 16
   calls on 16 fresh index sets; the bound from the bytes the gather
   moves (indices, the distinct values read, outputs) and the floor at
   32-byte sectors; two measured floors in the same protocol, a tiny
   torch op and a copy_ of the 1 MB idx into a 1 MB float buffer; then
   binned again on the 4.3 GB table (V = 1,127,219,200, made on the card
   from a seed and freed before phase 10), bit-equal, warm and cold;
10. the gather benchmark's entry point (benchmarks/micro_pgather.main) at
   its defaults, every variant at 67 MB, then at --table-mb 4300 on
   xla_big, xla_sorted, xla_packed, xla_packed8f and pallas_binned with 3
   reps; each variant's M rows/s printed, the JSON checked, and every
   gather kernel's launch count must rise;
11. the scheduler family (naiveSK, naiveMK with and without compaction,
   regenerationSK at levels 0/1/2, streamingSK, sortingSK, streamingMK,
   whose bodies run as csrc/familybody.cu's kernels, and fastQ one- and
   two-level, whose loop runs as csrc/fastqbody.cu's), each through create_renderer(...).render() on the brickSK slice's
   scene (thesis Table 6.2: smoke 128x128x50, scale 800, Mitsuba XML +
   .vol, 400^2) at 1 iteration and one seed, through the kernels (their
   counts set to 0 just before each render and read just after) and then
   with eager_body=True (the eager bodies): wall seconds with the image
   copied to the host, the wavefront passes (bounce or extend
   evaluations of the loop; fastQ's iterations), kernel launches, host
   reads, Mrays/s and Config.n_lanes of both; both give the same n_rays
   and passes, the kernel render no eager evaluation, the eager render no
   launch; every integrator-family row must give naiveSK's n_rays exactly
   and an image allclose to naiveSK's (rtol = atol = 1e-4), fastQ's mean
   and n_rays within 2% of naiveSK's; torch.profiler over streamingSK's
   whole render through the kernels (the card's busy share); under
   --boundary variable naiveSK, naiveMK and regenerationSK 0 at 400^2 x 1
   through the kernels (the bounce's isosurface march; each naiveSK-
   variable's n_rays exactly, images allclose at 1e-4), then each through
   the kernels and with the eager bodies at VARIABLE_EAGER_RES^2 (the same
   n_rays and passes, images within 1e-4), and the variable white furnace
   exact through the kernels; the white furnace exact on the card through
   every row; and each row's 16^2 render on the card against the same
   render on the CPU;
12. naiveSK through the CLI's batch mode on the same scene: -k naiveSK
   -i 4 -r 400 400, two trials (the first discarded), through the drain;
13. the gradient on the card (the two-level replay through the replay
   kernels of csrc/replaybody.cu): render_diff one- and two-level, null
   and GGX BSDF, on a
   random 16^3 grid with a per-voxel albedo at 16^2 x 4, against the
   same call on the CPU (images allclose at 1e-4 on the null scene, >= 90%
   of pixels on the GGX scene; both cotangents within rtol 1e-3, atol
   1e-4 x max on >= 99% of voxels: the tolerances of
   tests/test_torch_diff.py; their sums within 1e-3 on the null scene and
   1e-2 on the GGX scene, where a path that takes another branch on the
   card carries ~1/1,024 of each sum); the pass-A elision (the
   forward's saved radiance equals pass A's bit for bit, GGX and RR on,
   cascaded pools); a central finite difference of one albedo voxel;
14. training: the port's benchmarks/inverse_256.main (BASELINE config 5)
   at the recipe's full width, n = 256, 128^2, spp 8 in 2 chunks, 2 views
   per step, cut in depth only (2 views, 8 target spp, steps 1 0 1):
   per level the seconds per step and per forward+backward program and
   the replay's iterations, the replay kernels' launches, drain launches,
   host reads and eager evaluations (counts set to 0 just before the run
   and read just after; no eager evaluation); finite losses, a density
   that moved at each level that took a step and stays within
   clip_density, the 128^3 level's checkpoint the upsampled 64^3 grid,
   the last checkpoint reloaded with its Adam moments; then one
   forward+backward program at 256^3 twice: per pass (primal, pass B)
   its launches, host reads and wall, then its device time and kernels
   under torch.profiler; pass B as long as the primal;
15. the native library's build time, and BASELINE config 3's smoke
   (128x128x50, albedo 0.9 d) written with write_vdb and read back with
   load_vdb_scene(device="cuda"), then through save_npz and
   load_npz_scene: density and albedo equal to the source on the active
   bounding box;
16. BASELINE config 3 at its published size (1024^2 x 4, one tile,
   fastSK two-level) through the port's baseline_configs driver (one
   trial), then through the CLI's batch mode with
   --tail-pallas, whose tail stage's drain must launch (and the tail
   kernel not); wall seconds
   with the image copy, n_rays and Mrays/s for both; then BASELINE config
   1 at its published size (256^2 x 20, the RAW scene whose transfer-
   function albedo makes the 'full' table, fastSK two-level) through
   baseline_configs, three trials: wall with and without the image copy,
   n_rays, Mrays/s, the body kernel's launches;
17. BASELINE config 4 at its published width (400^2 in 10x10 tiles of
   40x40, Mitsuba XML + .vol), iterations cut from 50 to 4, rendered
   once through create_renderer(...).render(): one fastSK cascade over
   all 100 tiles (fast.render_tile counted, with its body evaluations),
   wall with the image copy and n_rays; then multi-tile mode against the
   sequential tile loop at 2x2 tiles of 40x40, 1 iteration: image and
   n_rays bit-equal;
18. the CLI's interactive modes at 64^2 on config 4's scene:
   --interactive with --orbit 2, with a --camera-path of a rotate between
   two renders (one accumulation reset), and the progressive mode; each
   writes its frames;
19. a density on the 255-level grid renders bit-identically with
   table_bits 8 and 32 on the card (16^2 x 4, one- and two-level; the
   packed path's warm-up); then BASELINE config 2 with --champion
   (packed q4 density tables through the allow_quantized gate, min_width
   64, 512 bricks, cascade factor 1.25) at its published size, 512^2 x
   CONFIG2_ITERS = 4, one tile, through the body kernel and the port's
   baseline_configs driver, then the f32
   row in the same call: table_bits 4 and 32 reach fast.render_tile,
   each image finite with rays traced, the q4 image mean within 5% of the
   f32 one (a sanity bound: the quantizer rounds to the nearest of 16
   levels); wall with and without the image copy, rays, body
   evaluations, and the two density tables' bytes; the f32 row also
   counts the device kernels per evaluation over its render_tile call
   (torch.profiler) and is phase 20's defer_ggx 0 row;
20. fastSK's options on config 2's scene at its published width, 512^2
   x CONFIG2_ITERS (as phase 19), one tile, two-level, no tail kernel,
   through create_renderer(...).render()
   in one call so the rows compare: defer_ggx 4 (the body kernels with
   the deferred flush) against phase 19's f32 render, which is defer_ggx
   0: render_tile's images bit-equal, n_rays equal; wall with the image
   copy, body evaluations, launches, host reads, and device kernels per
   evaluation from torch.profiler over each whole render (at most
   DEFER_KERNELS_MAX for defer_ggx 4);
   brick_major (the 256^3 grid divides (8, 8, 128): bit-equal to
   the defer_ggx=0 image); the white furnace exact on the card for
   tests/test_fast.py's two tail configurations (16^2 x 4); then
   micro_medical2's bricks16 (cascade 2, 4,096 bricks), bricks16+tb4
   (tail_bricks 4), b16+spec8@512, b16+spec16@512, b16+spec32@512
   (min_width 512, a single-level spec-K tail at <= 512 lanes) and
   b16+spec16@2048, all through the body kernels: wall, evaluations per
   stage, n_rays, launches (the speculative ones counted apart), each
   tail row's image mean within 2% and n_rays within 5% of bricks16's;
   b16+spec16@512 at SPEC_EAGER_RES^2 x 1 (a cut of depth: on an H100 the
   eager body took 67 s at 512^2 x 4, 2,139 evaluations, against 38-42 s
   at 128^2 x 1, 968) through the kernels (a speculative stage
   launched) and through the eager body (eager_body=True): image, n_rays
   and n_rows bit-equal; a 64^3 per-voxel
   albedo under a budget cut to send it to 'split', bit-equal to its
   'full' render; then a per-voxel albedo grid
   made on the card at the side n where plan_albedo_table picks 'split'
   on this card (16 n^3 > 30% and 20 n^3 < 80% of its memory), rendered
   at 128^2 x 1: wall, peak allocated memory, image mean;
21. parallel/ (torch.distributed) on the card: (a) phase 5's render
   through render_sharded on a 1-rank NCCL group, image and n_rays equal
   to phase 5's bit for bit, the tail stage's drain launching, wall
   with the image copy and the all_reduce of the image timed by CUDA
   events; (b) two processes of a gloo group sharing the card (NCCL
   refuses two ranks on one device) render config 2's scene at 64^2 x 5
   (odd spp) with fastSK two-level, q4 tables and cascade 1.25 while this
   process renders the same on its 1-rank mesh: images allclose at 1e-5,
   n_rays equal; (c) make_inverse_step (32^3, 32^2 x 8, two-level, SGD)
   on the 1-rank mesh against an unsharded render_diff + SGD step: loss
   and grids bit for bit, both under torch.use_deterministic_algorithms;
   (d) benchmarks/scaling_efficiency --compare-plain at its default
   width (128^2 x 4 per rank) and its default 3 timed reps, in a group of
   one: the N = 1 row and the plain render beside it;
22. the body kernels on config 2 (phase 5's scene, 512^2 x 4, two-level,
   no tail kernel): (a) rendered through the per-evaluation loop
   (ops/fastbody.loop_stage: one launch and a pending-count read per
   evaluation or chain), keeping the state at evaluations 0, 20 and 100,
   at the first evaluation of the 16,384- and 4,096-lane pools and at
   each stage's entry, then through the stage path (gated chains, the
   last stage drained), the kernels' counts set to 0 just before it:
   image, n_rays, n_rows, n_busy and per-stage rows bit-equal, n_rays
   6,056,452 and 3,002 evaluations, launches, host reads and the host's
   enqueue time per gated launch; the two renders again in turns (loop,
   stage, stage, loop; wall with the image copy); (b) on each stage's
   entry state the per-evaluation loop against the stage path, in turns:
   every FastState field equal, wall, device kernels and busy ms
   (torch.profiler), launches and host reads; (c) the drain at 32, 64,
   128 and 256 threads per block, twice in turns (CUDA events around one
   drain; bit-equal), the longest lane's L and the drain's us per step of
   it, its plain version (the eager body's loop, timed) and its byte
   bound (ops/fastbody.body_bytes over every evaluation's taps: each
   lane's state read and written once, the distinct table entries and
   brick rows read); (d) on each kept evaluation state, one kernel
   evaluation and one eager evaluation give equal FastState fields (NaN
   equal to NaN) and the same pending count; the kernel's device time per
   evaluation from replays of a CUDA graph of 16 out-of-place evaluations
   of the kept state, the eager body's by CUDA events, and the byte
   bound; (e) the two modes' kept pools: config 2 as b16+spec16@512
   (the 512-lane stage's entry, spec_k 16) and at defer_ggx 4 (the
   16,384-lane stage, advanced to an evaluation that flushes with lanes
   waiting), each one kernel evaluation against one eager evaluation
   (every FastState field, the pending count), the kernel's time per
   evaluation (CUDA graph), the eager evaluation's and the byte bound,
   then one drain launch capped at MODE_DRAIN_CAP evaluations against as
   many eager evaluations, both timed, and its bound; the spec pool also
   drained to its end at spec_k 1, 8, 16 and 32 (CUDA events);
23. render_diff's replay kernels (csrc/replaybody.cu) on phase 14's
   256^3 problem (inverse_256's phantom, albedo 0.6, scale 12, its first
   view at 128^2 x 4: 65,536 lanes in pools down to 4,096): (a) pass B
   through the eager body, keeping the pool at evaluations 0, 4 (the
   65,536-lane pool's tracking), 20 and 100, at the first 16,384- and
   4,096-lane evaluations and at each
   stage's entry; whole replays through the kernels against the eager
   body (radiance bit for bit, cotangents within rtol 1e-4 and atol 1e-5
   x max per voxel, sums within 1e-6, evaluations equal), wall, launches
   and host reads; (b) on each kept pool one kernel evaluation against one
   eager evaluation, primal and pass B: every _Lanes field and the alive
   count equal, pass B's cotangents bit for bit under deterministic
   algorithms and within those tolerances with atomics; the kernel's
   device time per evaluation (replays of a CUDA graph of 16 out-of-place
   evaluations), the eager body's (CUDA events) and the byte bound
   (ops/replaybody.replay_bytes); (c) on each stage's entry the
   per-evaluation loop against the stage path (gated chains, the drain),
   primal and pass B, in turns: fields and evaluations equal, walls,
   launches and reads; (d) the drain timed by CUDA events around one
   launch, primal and pass B in turns, the longest lane L and us per
   step, its plain version (the eager loop, wall) and its byte bound;
24. the north-star benchmark, benchmarks/bench_1024.main at its defaults
   with --bwd (1024^3 plume made on the card, the forward at 1024^2 x 4,
   the fwd+bwd at 256^2 x 1, max_path_length 100, RR on), the replay
   kernels' counts set to 0 just before and read just after: forward
   Mrays/s, the primal replay and two fwd+bwd times, peak allocated
   memory; finite numbers, pass B as long as the primal, every replay
   through the kernels;
25. the family's kernels (csrc/familybody.cu) on phase 11's scene: for
   pools of 65,536, 16,384 and 4,096 lanes whose paths start at the
   image's middle rows, kept after plain iterations (regenerationSK's
   first iteration for the refill, and one more refill
   for the bounce with the splat; streamingSK's sixth for the extend;
   sortingSK's seventh, lanes pending, for the flush), one kernel evaluation against one eager evaluation (every lane field
   equal bit for bit), the kernel's device time per evaluation (CUDA
   events over replays of a graph of 16 out-of-place evaluations), the
   eager function's (CUDA events, its input's copy included) and the
   byte bound (ops/familybody.family_bytes from the eager function's
   taps); then naiveSK's drain at 400^2 x 1 (160,000 lanes) twice by CUDA
   events around one launch, equal to trace's eager loop bit for bit,
   the longest lane L and the drain's us per bounce of it, the eager
   loop's wall and the drain's byte bound (every bounce's taps); fastQ
   (csrc/fastqbody.cu), one- and two-level, at the same widths: a refill
   iteration (12) and a step (13) on states kept from the middle rows'
   queue, the kernel against the eager body (every lane field and counter
   bit for bit), timed as the family's entry points, bound by
   ops/fastqbody.fastq_bytes; its drain (one-level) on a 65,536-lane
   state kept where every path is issued, twice, against the eager loop
   (bit for bit, its wall), with the longest lane's iterations and the
   bound over every iteration's taps; and the bounce under --boundary
   variable (the march) at the same widths, and at 65,536 lanes with
   threshold LONG_MARCH (long marches), against integrator.bounce_step,
   timed and bound the same way (family_bytes counts the march's distinct
   voxels), beside the AABB bounce on the same pool and the eager march's
   iterations.
26. (run right after phase 8, on its scene) brickSK's round kernels on
   rounds kept from the slice (400^2 x 4, 160,000 lanes: rounds 0, 100
   and 600) and from a 48x40 tile in its middle (1,920 lanes in 15 rows:
   rounds 0, 20 and 100), reached through the kernels: phase_a_kernel
   against the eager phase A in the kernels' layout (every lane field,
   keys, perm, the count, n_rays) and round_kernel against the eager
   tracking round on the sorted keys (every lane field, pos), bit for bit;
   each kernel's device time per launch (CUDA events over replays of a
   graph of 16 out-of-place launches of the kept state), its plain
   version's (CUDA events, the input's copy included), the stable sort's
   (graph of 16), and the byte bound (ops/brickbody.brick_bytes from the
   plain versions' taps); then 100 rounds of the 160,000-lane render
   from round 601, in place as the render runs them, under
   torch.profiler: each kernel's device time per launch, the sort's,
   device kernels per round and the busy share, each kernel's byte bound
   over the same rounds by the plain versions, whose state after them
   must equal the kernels' bit for bit.
27. (run last, on phase 5's kept tail stage) the tail stage's drain on
   the state kept at its entry: two launches in turns, each timed by CUDA
   events around the launch and bit-equal to the eager loop's state; the
   longest lane's rounds and the drain's us per round of it; the eager
   loop's wall; the byte bound (ops/taildrain.drain_bytes over the taps
   of every round of the plain loop run with the tail kernel's plain
   version) and the drain's share of it; drain_kernel's ptxas registers
   and spills.
28. (run right after phase 5, on its scene) fastQ two-level at BASELINE
   config 2's full width (512^2 x 4, one tile) through the kernels: three
   renders timed with the image copy, launches and host reads (no eager
   iteration); the image mean within 2% of phase 5's fastSK render, and
   n_rays beside fastSK's (the two schedulers count segment starts 2.1%
   apart on this scene: ROADMAP C3).
29. (run after phase 27) render_diff's bounce-lockstep replays
   (csrc/nestedreplay.cu) on benchmarks/results_inverse64.json's problem
   (medical_volume 64^3, 40 blobs, scale 12, albedo 0.6, RR off,
   max_path_length 64, GGX; the first of 6 orbit views at radius 100, fov
   0.8; InverseConfig's 32^2 x 64 spp, 65,536 lanes): (a) the one-level
   pass A and pass B through the drain against the eager loop (every lane
   field bit for bit; cotangents within GRAD_*; their walls, launches and
   host reads, and each path's device kernels under torch.profiler), the
   drain timed alone (CUDA events, torch.profiler), the longest lane's
   steps and bounces, nested_bytes' bound; deterministic pass B (the
   lockstep, at the full 32^2 x 64) bit for bit;
   render_diff(two_level=False) forward and backward end to end through
   the kernels and through the eager loop (walls with the gradients' copy,
   counts set to 0 just before; cotangents within GRAD_*; the images come
   from the one forward kernel and are not compared);
   (b) run_inverse at InverseConfig's defaults,
   n_steps cut from 200 to 10: seconds per step, losses, launches;
   (c) the nested two-level replay (fused=False) against its eager loop,
   pass A, pass B and deterministic pass B (32^2 x 8), its drain timed and
   bounded,
   then on phase 23's 256^3 problem against the fused replay's kernels
   (radiance bit-equal, cotangents within GRAD_*); (d) run_multihost.py on
   one NCCL rank: its render mode at its defaults (512^2 x 32) on config
   1's bucky 32^3 RAW, then --inverse on that image at the same size with
   --steps cut from 100 to 10 (seconds per step, launches, host reads, no
   eager pass); (f) benchmarks/inverse_scale100 with --steps cut from 30
   20 15 to 2 1 1.
30-41. the measurement drivers of cudavolumerenderer_tpu_torch/benchmarks,
   each main at its published size and reps (the JAX scripts' defaults):
   30 run_suite (kernels naiveSK, regenerationSK, streamingSK and fastSK
   through create_renderer at n_lanes 2^17, and fastSK-2L through
   render_tile, on bucky 32^3 at 256^2 x 20, smoke 128x128x50 at 400^2 x
   4 and medical 256^3 at 512^2 x 4), 31 run_suite --tiling (bucky at
   1920^2 x 5 on 1, 2, 4, 8, 32 and 64 tiles a side), 32 micro_classes,
   33 micro_stats, 34 micro_ablate (its blob-field stand-in, 256^3 at
   512^2 x 4) and micro_ablate --regen-levels, 35 micro_driver_overhead
   (then its direct render once under torch.profiler), 36 micro_medical,
   37 micro_medical2 (its whole sweep, the tail kernel's rows included),
   38 micro_smoke2, 39 micro_bucky_r5, 40 micro_config3 (config 3's .vdb
   at 400^2 and 1024^2) and 41 micro_smoke_brick; for each: the JSON
   written equals main's dict and holds the driver's KEYS (the JAX
   script's keys, held to the script's text by tests/test_torch_
   drivers.py); every row (its counts set to 0 just before it and read
   just after: scene_classes.RowCounts) launched each kernel that it names
   in `kernels` (its body kernel: fastbody, familybody or brickbody, and
   the tail stage's drain where the row opens the tail kernel's gate), and
   made no eager evaluation and no launch of the eager loops' tail or
   tracking kernels; run_suite's naiveSK, regenerationSK and streamingSK rows of
   each scene trace the same n_rays exactly; albedo_affine set for the
   smoke and medical classes and not for bucky; each row's wall, n_rays,
   launches and host reads printed.

The whole script's wall time is printed last before the JSON lines.

The last lines are a JSON line describing the kernels, the card's name
and power limit, and the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

RTOL, ATOL = 1e-5, 1e-6
N_STEPS = 16
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s
PEAK_OPS_PER_MS = 67e9  # H100 SXM float32 outside the tensor cores, 67 T/s
GRAPH_CALLS = 16  # calls per timed CUDA graph
SWEEP_STEPS = (1, 2, 4, 8, 16)  # K of phase 3's step sweep, at R = 128
SLICE_RAYS = 6040005  # n_rays of the fastSK slice (phase 5), first tail kernel
BRICK_RAYS = 1151411  # n_rays of the brickSK slice (phase 8), the eager loop's
# phase 26: (label, tile w, h, tile offset, rounds run before each kept state)
BRICK_STATES = (("160000", 400, 400, (0, 0), (0, 100, 600)),
                ("1920", 48, 40, (176, 180), (0, 20, 100)))
BRICK_PROFILE_ROUNDS = 100  # phase 26's profiled rounds (160,000 lanes)
BRICK_REPLACES = {"phase_a": "cudavolumerenderer_tpu/models/brick.py:185",
                  "round": "cudavolumerenderer_tpu/models/brick.py:365"}
BRICK_DESIGN = {
    "phase_a": "one thread per lane, the lanes kept in place (they carry "
               "their sorted position); phase A in registers, the sort key "
               "and perm written in position order; n_rays and the loop's "
               "count by the last block; rounds enqueued in gated batches",
    "round": "one block per row of 128 sorted positions, each reading its "
             "lane through perm[order]; the row's brick table staged in "
             "shared memory, tracking.cu's step loop (common.cuh) for the "
             "usable lanes; the last block moves the loop's count into the "
             "control words",
}
WINDOW = (100, 60)  # phase 5's profiler window: first tail round, rounds
NULL, SCATTER, DIED, CROSSED = 1, 2, 3, 4  # what a traced step did
COLD = ("taa1", "taa0", "stream", "vmem", "binned")  # also timed on fresh indices
SQRT_INPUTS = 1 << 20  # phase 1's float32 inputs of torch.sqrt on the card
GATHER_N, GATHER_S = 262144, 16  # the gather benchmark's published N and S
GATHER_BIG = ("xla_big", "xla_sorted", "xla_packed", "xla_packed8f",
              "pallas_binned")  # the variants run at 4.3 GB
# phase 11's rows: (label, -k kernel, Config fields, render_tile keywords
# that no Config field sets)
FAMILY_ROWS = (
    ("naiveSK", "naiveSK", {}, {}),
    ("naiveMK", "naiveMK", {}, {}),
    ("naiveMK no compaction", "naiveMK", {}, {"compaction": False}),
    ("regenerationSK 0", "regenerationSK", {"regeneration_level": 0}, {}),
    ("regenerationSK 1", "regenerationSK", {"regeneration_level": 1}, {}),
    ("regenerationSK 2", "regenerationSK", {"regeneration_level": 2}, {}),
    ("streamingSK", "streamingSK", {}, {}),
    ("sortingSK", "sortingSK", {}, {}),
    ("streamingMK", "streamingMK", {}, {}),
    ("fastQ", "fastQ", {}, {}),
    ("fastQ two-level", "fastQ", {"two_level": True}, {}),
)
FASTQ_LABELS = ("fastQ", "fastQ two-level")
# phase 11's rows under --boundary variable (the bounce's isosurface march)
VARIABLE_ROWS = ("naiveSK", "naiveMK", "regenerationSK 0")
VARIABLE_EAGER_RES = 400  # their eager renders' width (a cut of the 400^2)
FAMILY_WIDTHS = (65536, 16384, 4096)  # phase 25's pool widths
FASTQ_ITS = {"refill": 12, "step": 13}  # phase 25's fastQ iterations
LONG_MARCH = 0.05  # phase 25: a march threshold the smoke's edges stay under
FASTQ_REPLACES = {"body": "cudavolumerenderer_tpu/models/fastq.py:148",
                  "drain": "cudavolumerenderer_tpu/models/fastq.py:402"}
# phase 25: the JAX function each family entry point replaces
FAMILY_REPLACES = {
    "bounce": "cudavolumerenderer_tpu/models/integrator.py:237",
    "refill": "cudavolumerenderer_tpu/models/regeneration.py:30",
    "extend": "cudavolumerenderer_tpu/models/streaming.py:217",
    "flush": "cudavolumerenderer_tpu/models/streaming.py:363",
    "march": "cudavolumerenderer_tpu/models/integrator.py:92",
}
# phase 13's gradient case (tests/test_torch_diff.py's): grid, image, spp, seed
DIFF_N, DIFF_RES, DIFF_SPP, DIFF_SEED = 16, (16, 16), 4, 7
# phase 14: inverse_256 at the recipe's full width, depth cut to the run's time
TRAIN_ARGV = ("--n", "256", "--res", "128", "--spp", "8", "--spp-chunks", "2",
              "--views", "2", "--target-spp", "8", "--steps", "1", "0", "1")
TRAIN_CUTS = ("--views 2 (the recipe's 8)", "--target-spp 8 (64)",
              "--steps 1 0 1 (80 60 40; 128^3 is upsampled through)")
CONFIG4_ITERS = 4  # phase 17: BASELINE config 4's 50 iterations, cut
# phase 20's tail rows (benchmarks/micro_medical2.py:88-113), the first the
# reference the others are held to
BRICKS16 = {"cascade_factor": 2, "max_bricks": 4096}
def spec_row(k: int, width: int) -> tuple:
    """micro_medical2's b16+spec{k}@{width}: a single-level spec-k tail at
    pools of at most `width` lanes, the cascade cut there."""
    return (f"b16+spec{k}@{width}", {**BRICKS16, "min_width": width,
                                     "tail_single_level": True,
                                     "tail_spec": k, "spec_width": width})


TAIL_ROWS = (
    ("bricks16", BRICKS16),
    ("bricks16+tb4", {**BRICKS16, "tail_bricks": 4}),
    spec_row(8, 512), spec_row(16, 512), spec_row(32, 512),
    spec_row(16, 2048),
)
#: the spec row held bit for bit against its eager-body render, both at
#: SPEC_EAGER_RES^2 x 1 (a cut of depth from 512^2 x 4; its 512-lane
#: speculative stage still runs)
SPEC_EAGER = "b16+spec16@512"
SPEC_EAGER_RES = 128
#: the most device kernels per evaluation of the defer_ggx 4 render
DEFER_KERNELS_MAX = 2
CONFIG2_ITERS = 4  # phases 19-20's config-2 iterations (the published 4)
# phase 21 (b): two gloo ranks sharing the card, and (c): the inverse step
GLOO_RES, GLOO_SPP = (64, 64), 5
GLOO_KNOBS = {"two_level": True, "table_bits": 4, "cascade_factor": 1.25}
INV_N, INV_RES, INV_SPP, INV_LR, INV_SEED = 32, (32, 32), 8, 5.0, 11
RANK_TIMEOUT = 600  # seconds for each phase 21 (b) rank
ALL_REDUCE_REPS = 20  # phase 21 (a): all_reduces of the image timed
SCALING_REPS = 3  # phase 21 (d): timed reps (the benchmark's default)
HERE = os.path.dirname(os.path.abspath(__file__))
# tests/test_fast.py:51-70's tail configurations (white furnace)
FURNACE_TAILS = (
    {"tail_spec": 4, "tail_width": 1 << 20, "min_width": 64},
    {"tail_single_level": True, "tail_spec": 8, "tail_width": 1 << 20,
     "min_width": 64, "tail_chain": 4},
)
# each gather kernel's Pallas body (file:line)
GATHER_REPLACES = {
    "taa1": "benchmarks/micro_pgather.py:284",
    "taa0": "benchmarks/micro_pgather.py:310",
    "vmem": "benchmarks/micro_pgather.py:334",
    "stream": "benchmarks/micro_pgather.py:354",
    "binned": "benchmarks/micro_pgather.py:390",
}
# taa1's design (csrc/pgather.cu, taa1_kernel)
TAA1_DESIGN = ("one warp per row, 8 warps per block, a grid of one wave; each "
               "lane's 16-byte tab and idx loads issued together, the row "
               "through the warp's shared-memory slice after __syncwarp, "
               "16-byte stores")
# vmem's and binned's design (csrc/pgather.cu, gather_tiles)
TILE_DESIGN = ("persistent grid over flat tiles of the shard-major lanes "
               "(vmem 256 threads x 4 lanes, 2 blocks per SM; binned 512 x 4, "
               "1 per SM); idx staged by 16-byte cp.async in a 2-stage "
               "shared-memory ring, each group's shard found while its copy "
               "is in flight; every table read before any store; table read "
               "L2 evict_last, idx and out evict_first; 16-byte stores")
SLICE_XML = """<scene version="0.5.0">
  <medium type="heterogeneous" id="smoke">
    <volume name="density" type="gridvolume">
      <string name="filename" value="density.vol"/>
    </volume>
    <volume name="albedo" type="gridvolume">
      <string name="filename" value="albedo.vol"/>
    </volume>
    <float name="scale" value="800"/>
  </medium>
  <sensor type="perspective">
    <float name="fov" value="0.7"/>
    <film type="hdrfilm">
      <integer name="width" value="400"/>
      <integer name="height" value="400"/>
    </film>
  </sensor>
</scene>
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sqrt_on_card() -> None:
    """Phase 1: torch.sqrt on CUDA float32 is correctly rounded (equal to
    the float64 root rounded to float32) on SQRT_INPUTS random bit
    patterns, denormals to the largest finite, and as many uniform [0, 1)
    values.  ops/math3.sqrt takes CPU float32 through float64 because some
    hosts' CPU sqrt is not; on the card it calls torch.sqrt, which this
    check holds to the same."""
    import torch

    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    bits = torch.randint(0, 0x7F800000, (SQRT_INPUTS,), dtype=torch.int32,
                         device="cuda", generator=gen)
    x = torch.cat([bits.view(torch.float32),
                   torch.rand(SQRT_INPUTS, device="cuda", generator=gen)])
    misses = int((torch.sqrt(x) != torch.sqrt(x.double()).float()).sum())
    log(f"[1] torch.sqrt float32 on the card: {misses} of {x.numel()} inputs "
        "differ from the float64 root rounded to float32")
    check(misses == 0, "CUDA torch.sqrt is not correctly rounded: "
          "ops/math3.sqrt must take the float64 route on the card too")


def torch_ops_on_card() -> None:
    """Phase 1: the two rules of torch's CUDA ops that the body kernel
    (csrc/fastbody.cu) follows to stay bit-equal to the eager body, on
    2^20 random rows: a float32 sum over a last dim of 3 adds
    (x0 + x2) + x1, and a division by a Python scalar multiplies by the
    scalar's float32 reciprocal (400 and 40 tell it from a true division;
    512 cannot)."""
    import torch

    gen = torch.Generator("cuda")
    gen.manual_seed(1)
    scale = torch.tensor([1e-3, 1.0, 1e3], device="cuda")
    x = torch.randn((1 << 20, 3), generator=gen, device="cuda") * scale
    s = torch.sum(x, dim=-1)
    check(torch.equal(s, (x[:, 0] + x[:, 2]) + x[:, 1]),
          "torch.sum over a last dim of 3 is not (x0 + x2) + x1 on the card")
    swapped = int((s != (x[:, 0] + x[:, 1]) + x[:, 2]).sum())
    y = torch.rand(1 << 20, generator=gen, device="cuda") * 1000.0
    for r in (400.0, 40.0, 512.0):
        inv = np.float32(1.0) / np.float32(r)
        check(torch.equal(y / r, y * float(inv)),
              f"x / {r} on the card is not x * float32(1 / {r})")
    true_div = int((y / 400.0 != y / torch.full_like(y, 400.0)).sum())
    log(f"[1] torch on the card: a sum over 3 is (x0 + x2) + x1 "
        f"({swapped} of {1 << 20} rows differ from (x0 + x1) + x2); x / "
        f"400.0 is x * float32(1 / 400) ({true_div} rows differ from a "
        "true division)")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def write_medical_mhd(tmp: str) -> str:
    """BASELINE config 2's scene file (benchmarks/baseline_configs.py
    _write_medical_mhd): 256^3 CT-style u16 counts, min-max normalized and
    smoothstepped by the loader."""
    from cudavolumerenderer_tpu_torch.scene import procedural

    n = 256
    d = procedural.medical_volume((n, n, n), n_blobs=40)
    raw_path = os.path.join(tmp, "medical_synth.raw")
    (d * 4095.0).astype("<u2").tofile(raw_path)
    mhd_path = os.path.join(tmp, "medical_synth.mhd")
    with open(mhd_path, "w") as f:
        f.write(
            "ObjectType = Image\nNDims = 3\nBinaryData = True\n"
            "BinaryDataByteOrderMSB = False\n"
            f"DimSize = {n} {n} {n}\n"
            "ElementType = MET_USHORT\n"
            "ElementSpacing = 1 1 1\n"
            f"ElementDataFile = {os.path.basename(raw_path)}\n"
        )
    return mhd_path


def write_smoke_xml(tmp: str) -> str:
    """The brickSK slice's scene files: smoke_volume((128, 128, 50)) and an
    RGB albedo of 0.9 * density over [-0.5, 0.5]^3, scale 800, fov 0.7,
    a 400x400 film (benchmarks/baseline_configs.py _write_mitsuba_xml's
    files, at micro_smoke_brick.py's scale)."""
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.vol import write_vol

    d = procedural.smoke_volume((128, 128, 50)).astype(np.float32)
    alb = (np.stack([d, d, d], axis=-1) * 0.9).astype(np.float32)
    box = ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    write_vol(os.path.join(tmp, "density.vol"), d, *box)
    write_vol(os.path.join(tmp, "albedo.vol"), alb, *box)
    path = os.path.join(tmp, "smoke_scene.xml")
    with open(path, "w") as f:
        f.write(SLICE_XML)
    return path


def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Mean milliseconds per call of fn, CUDA events around reps calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(calls, replays: int = 10) -> float:
    """Milliseconds per call, CUDA events around `replays` replays of a
    CUDA graph of the given calls back to back (no host time per call)."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks.micro_pgather import GraphRun

    graphed = GraphRun(lambda: [fn() for fn in calls], ())
    graphed.run()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graphed.run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * len(calls))


def bound_ms(n_bytes: int, n_ops: int = 0):
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, n_ops / PEAK_OPS_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tap_bound(taps, bytes_of_words, step_ops: int):
    """(bound ms, bound_by, bytes, distinct table words, taps) of one call
    of a render kernel whose plain version reported `taps`."""
    import torch

    pos = torch.cat(taps)
    words = int(pos.unique().numel())
    n_bytes = bytes_of_words(words)
    return (*bound_ms(n_bytes, step_ops * pos.numel()), n_bytes, words,
            pos.numel())


def gather_vs_plain(table, name: str, card: str) -> dict:
    """Phase 9 for one gather kernel: its error, times, bound and
    32-byte-sector floor (and cold time, for the kernels in COLD)."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as mpg
    from cudavolumerenderer_tpu_torch.ops import pgather as pg

    args = mpg.kernel_args(name, table, GATHER_N, GATHER_S)
    run, plain = pg.WRAPPERS[name]
    lib = pg.YARDSTICKS[name]
    before = pg.KERNELS[name].launches
    got = run(*args)
    torch.cuda.synchronize()
    check(pg.KERNELS[name].launches == before + 1, f"{name} did not launch")
    want = plain(*args)
    check(torch.equal(got, want), f"gather kernel {name} is not bit-equal "
          "to its plain version")
    i64 = args[1].long()
    check(torch.equal(lib(args[0], i64), want),
          f"{name}'s yardstick differs from its plain version")
    err = float((got - want).abs().max())

    def kernel():
        return run(*args)

    def library():
        return lib(args[0], i64)

    # in turns: kernel, yardstick, plain, yardstick, kernel
    ms_a = graph_ms([kernel] * GRAPH_CALLS)
    lib_a = graph_ms([library] * GRAPH_CALLS)
    plain_ms = graph_ms([lambda: plain(*args)] * GRAPH_CALLS)
    lib_b = graph_ms([library] * GRAPH_CALLS)
    ms_b = graph_ms([kernel] * GRAPH_CALLS)
    n = args[1].numel()
    values, sectors = pg.touched(name, args[1])
    bound, bound_by = bound_ms(pg.gather_bytes(n, values))
    sector_ms = pg.gather_bytes(n, sectors, 32) / HBM_BYTES_PER_MS
    res = {"max_abs_err": err, "ms": (ms_a + ms_b) / 2, "plain_ms": plain_ms,
           "library_ms": (lib_a + lib_b) / 2, "bound_ms": bound,
           "bound_by": bound_by, "sector_ms": sector_ms}
    log(f"[9] {name}: idx {tuple(args[1].shape)} into tab "
        f"{tuple(args[0].shape)}: bit-equal, max |err| {err:.3g}; per call "
        f"kernel {ms_a * 1e3:.2f} / {ms_b * 1e3:.2f} us, yardstick "
        f"{lib_a * 1e3:.2f} / {lib_b * 1e3:.2f} us, plain torch "
        f"{plain_ms * 1e3:.2f} us; bound {bound * 1e3:.3f} us by {bound_by} "
        f"({pg.gather_bytes(n, values)} B, {values} distinct values), the "
        f"kernel at {bound / res['ms']:.1%} of it; 32-byte-sector floor "
        f"{sector_ms * 1e3:.3f} us ({sectors} sectors); card {card}")
    if name in COLD:
        sets = [mpg.kernel_args(name, table, GATHER_N, GATHER_S, rep)
                for rep in range(GRAPH_CALLS)]
        wide = [a[1].long() for a in sets]
        cold_k = graph_ms([lambda a=a: run(*a) for a in sets])
        cold_l = graph_ms([lambda a=a, w=w: lib(a[0], w)
                           for a, w in zip(sets, wide)])
        cold_k2 = graph_ms([lambda a=a: run(*a) for a in sets])
        res["cold_ms"] = (cold_k + cold_k2) / 2
        res["cold_library_ms"] = cold_l
        log(f"[9] {name} cold (16 fresh index sets per graph): kernel "
            f"{cold_k * 1e3:.2f} / {cold_k2 * 1e3:.2f} us, yardstick "
            f"{cold_l * 1e3:.2f} us per call; card {card}")
    return res


def binned_big(card: str) -> dict:
    """Phase 9 at 4.3 GB: the binned kernel on the benchmark's 1024^3-class
    table (V = 1,127,219,200; 269 MB shards, none of which fits L2), made
    on the card from a seed and freed after; bit-equal to its plain
    version, timed warm and cold with its bound and sector floor."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as mpg

    t0 = time.perf_counter()
    V = mpg.table_rows(4300.0, GATHER_S)
    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    table = torch.rand(V, device="cuda", generator=gen)
    torch.cuda.synchronize()
    log(f"[9] binned at 4.3 GB: table ({V},) ({V * 4 / 1e9:.2f} GB) made "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    res = gather_vs_plain(table, "binned", card)
    del table
    torch.cuda.empty_cache()
    log(f"[9] binned at 4.3 GB took {time.perf_counter() - t0:.1f} s")
    return res


def measured_floors(card: str) -> dict:
    """Phase 9's two measured floors, in the kernels' graph protocol and
    with no kernel of the port: one launch of a tiny torch op (a 1-float
    add_), and a copy_ of the published 1 MB idx into a 1 MB float buffer
    (the idx and out streams with no table).  Each timed twice."""
    import torch

    tiny = torch.zeros(1, device="cuda")
    idx = torch.zeros(GATHER_N // 128, 128, dtype=torch.int32, device="cuda")
    buf = torch.empty(idx.shape, device="cuda")
    launch = [graph_ms([lambda: tiny.add_(1.0)] * GRAPH_CALLS) for _ in range(2)]
    copy = [graph_ms([lambda: buf.copy_(idx)] * GRAPH_CALLS) for _ in range(2)]
    log(f"[9] measured floors per call: a tiny torch op {launch[0] * 1e3:.2f} "
        f"/ {launch[1] * 1e3:.2f} us, copy_ of the 1 MB idx into a 1 MB float "
        f"buffer {copy[0] * 1e3:.2f} / {copy[1] * 1e3:.2f} us; card {card}")
    return {"launch_ms": sum(launch) / 2, "copy_ms": sum(copy) / 2}


def gather_benchmark(tmp: str, card: str):
    """Phase 10: the gather benchmark's entry point at 67 MB (every
    variant) and 4.3 GB (the named subset); returns the gather kernels'
    launch counts over both runs."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as mpg
    from cudavolumerenderer_tpu_torch.ops import pgather as pg

    runs = (("67", []), ("4300", ["--table-mb", "4300", "--only",
                                  ",".join(GATHER_BIG), "--reps", "3"]))
    torch.cuda.synchronize()
    for kern in pg.KERNELS.values():
        kern.launches = 0
    rates = {}
    for mb, argv in runs:
        path = os.path.join(tmp, f"pgather_{mb}.json")
        t0 = time.perf_counter()
        ret = mpg.main([*argv, "--json-out", path])
        log(f"[10] micro_pgather at {mb} MB: {time.perf_counter() - t0:.1f} s")
        with open(path) as f:
            saved = json.load(f)
        check(saved == ret, "the benchmark's JSON differs from its result")
        check(list(saved) == ["V", "N", "S", "inner", "platform", "results"],
              f"JSON keys {list(saved)}")
        check(saved["V"] == mpg.table_rows(float(mb), 16)
              and saved["N"] == GATHER_N and saved["S"] == GATHER_S
              and saved["inner"] == 16 and saved["platform"] == "cuda",
              f"JSON header {saved}")
        for name, res in saved["results"].items():
            check(sorted(res) == ["mrows_s", "ms_per_gather"]
                  and all(np.isfinite(v) and v > 0 for v in res.values()),
                  f"{mb} MB {name}: {res}")
            rates.setdefault(name, {})[mb] = res
    names = set(rates)
    want_67 = {"xla_small_1mb", "xla_small_4mb", "xla_wide_1mb",
               "xla_wide_8mb", "xla_wide_16mb"} | {
        v for v in mpg.VARIANTS if v not in ("xla_small", "xla_wide")}
    check(names == want_67, f"variants run at 67 MB: {sorted(names)}")
    check({n for n in names if "4300" in rates[n]} == set(GATHER_BIG),
          "variants run at 4.3 GB")
    launches = {k: kern.launches for k, kern in pg.KERNELS.items()}
    check(all(n > 0 for n in launches.values()),
          f"a gather kernel never launched in the benchmark: {launches}")
    log(f"[10] gather kernel launches (graph replays x 16 + warm-ups + "
        f"checks): {launches}")
    log(f"[10] per gather, card {card}:")
    order = {v: i for i, v in enumerate(mpg.VARIANTS)}
    for name in sorted(rates, key=lambda n: order.get(n, order.get(
            n.rsplit("_", 1)[0]))):
        cells = "  ".join(
            f"{mb} MB {r['ms_per_gather'] * 1e3:9.2f} us "
            f"{r['mrows_s']:10.1f} M rows/s" for mb, r in rates[name].items())
        log(f"[10]   {name:16s} {cells}")
    return launches


def kernel_vs_plain(tables, params, n_paths: int, card: str):
    """Phase 3 at one width: returns (max_abs_err, kernel ms, plain ms,
    bound ms, bound_by)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    inputs = tpk.random_tail_state(tables, params, n_paths, seed=n_paths)
    args = (tables.tab, *inputs[:1], params, *inputs[1:])
    got = tpk.run_tail_steps(*args, n_steps=N_STEPS)
    torch.cuda.synchronize()
    taps = []
    want = tpk.tail_steps(*args, n_steps=N_STEPS, taps=taps)
    (gf, gi, gs), (wf, wi, ws) = (
        [x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want]
    )
    agree = (gi == wi).all(axis=0) & (gs == ws)
    n_diff = int((~agree).sum())
    statuses = np.bincount(gi[1], minlength=4).tolist()
    log(f"[3] R={n_paths} K={N_STEPS}: paths differing {n_diff}/{n_paths}; "
        f"status RUN/NEED_WINDOW/EXIT_BOX/DEAD = {statuses}")
    check(agree.mean() >= 0.999, f"R={n_paths}: {n_diff} paths differ")
    a, b = gf[:, agree], wf[:, agree]
    fin = np.isfinite(a) & np.isfinite(b)
    check(np.array_equal(a[~fin], b[~fin], equal_nan=True),
          f"R={n_paths}: non-finite outputs differ")
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)
    err = float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))
    ms = graph_ms([lambda: tpk.run_tail_steps(*args, n_steps=N_STEPS)]
                  * GRAPH_CALLS)
    plain_ms = cuda_ms(lambda: tpk.tail_steps(*args, n_steps=N_STEPS), 10, 2)
    bound, bound_by, n_bytes, words, n_taps = tap_bound(
        taps, lambda w: tpk.tail_bytes(n_paths, w), tpk.STEP_OPS)
    log(f"[3] R={n_paths}: kernel {ms * 1e3:.2f} us of device time per "
        f"{N_STEPS}-step call (graph of {GRAPH_CALLS}), plain torch "
        f"{plain_ms:.4f} ms (eager, host-bound); bound {bound * 1e3:.4f} us "
        f"by {bound_by} ({n_bytes} B, {words} distinct table words of "
        f"{n_taps} taps), the kernel at {bound / ms:.2%} of it; max "
        f"|err| {err:.3g}; card {card}")
    trace_paths(args, n_paths, "[3]")
    return err, ms, plain_ms, bound, bound_by


def trace_paths(args, n_paths: int, tag: str) -> None:
    """What each path does in its N_STEPS steps, from the plain version run
    one step at a time: steps taken, scatters, and the rounds the kernel
    needs for them (kernel_rounds)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    tab, brick, params, f, i, rng = args
    codes = []
    for _ in range(N_STEPS):
        active = i[tpk.I_STATUS] == tpk.RUN
        f, i_out, state = tpk.tail_steps(tab, brick, params, f, i, rng, 1)
        scatter = i_out[0] != i[tpk.I_BOUNCE]
        running = i_out[1] == tpk.RUN
        codes.append(torch.where(~active, 0, torch.where(
            scatter, torch.where(running, SCATTER, DIED),
            torch.where(running, NULL, CROSSED))))
        i = torch.cat([i[:tpk.I_BOUNCE], i_out]).contiguous()
        rng = torch.stack([state, rng[1]])
    codes = torch.stack(codes).cpu().numpy()
    steps = (codes > 0).sum(0)
    scatters = ((codes == SCATTER) | (codes == DIED)).sum(0)
    rounds = np.array(kernel_rounds(codes))
    longest = int(steps.argmax())
    log(f"{tag} R={n_paths} K={N_STEPS}: paths by steps taken "
        f"{np.bincount(steps, minlength=N_STEPS + 1).tolist()}; {steps.sum()} "
        f"steps, {scatters.sum()} scatters in all; the longest path takes "
        f"{steps[longest]} steps with {scatters[longest]} scatters in "
        f"{rounds[longest]} kernel rounds; the most scatters on a path "
        f"{scatters.max()}, the most kernel rounds {rounds.max()}")


def kernel_rounds(codes) -> list:
    """Rounds the tail kernel takes per path, from its steps' codes (K, R):
    a null run covers up to tpk.LANES null collisions and ends at the first
    other step (a scatter goes on in a scatter run); a scatter run covers
    run links (tpk.FIRST_RUN after a null run, twice the last after a run
    in which every link scattered and survived) and ends at the first link
    that did not."""
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    out = []
    for seq in codes.T:
        seq = [int(x) for x in seq if x]
        n, i, run, rounds = len(seq), 0, 0, 0
        while i < n:
            rounds += 1
            if run == 0:
                j = i
                while j < n and j - i < tpk.LANES and seq[j] == NULL:
                    j += 1
                if j == n or j - i == tpk.LANES or seq[j] == CROSSED:
                    i = j if j == n or j - i == tpk.LANES else n
                    continue
                i, run = j, tpk.FIRST_RUN
                continue
            c, k = min(run, n - i), 0
            while k < c and seq[i + k] == SCATTER:
                k += 1
            if k == c:
                i, run = i + c, min(2 * run, tpk.LANES)
                continue
            i, run = (i + k + 1, 0) if seq[i + k] == NULL else (n, 0)
        out.append(rounds)
    return out


def step_sweep(tables, params, card: str) -> dict:
    """Phase 3: the tail kernel's device time per call at R = 128 for each
    K in SWEEP_STEPS (graph protocol as kernel_vs_plain); returns
    {K: ms} and the least-squares slope, ms per step."""
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    inputs = tpk.random_tail_state(tables, params, 128, seed=128)
    args = (tables.tab, *inputs[:1], params, *inputs[1:])
    ms = {k: graph_ms([lambda k=k: tpk.run_tail_steps(*args, n_steps=k)]
                      * GRAPH_CALLS) for k in SWEEP_STEPS}
    slope, icept = np.polyfit(SWEEP_STEPS, [ms[k] for k in SWEEP_STEPS], 1)
    log(f"[3] step sweep R=128: " + ", ".join(
        f"K={k} {v * 1e3:.2f} us" for k, v in ms.items())
        + f"; slope {slope * 1e3:.3f} us per step, intercept "
        f"{icept * 1e3:.2f} us; card {card}")
    return {"ms": ms, "slope_ms": slope}


def ptxas_report(log_text: str) -> str:
    """The ptxas lines (registers, spills, shared memory) of a build log."""
    return "; ".join(line.split(":", 1)[-1].strip()
                     for line in log_text.splitlines()
                     if "Used" in line or "spill" in line)


def profile_tail_window(renderer, card: str):
    """Phase 5: the slice's render with torch.profiler over the WINDOW of
    tail rounds, keeping the kernel's inputs of the window's middle round.
    Returns the tail kernel's device us per launch there (None if the
    trace holds no device time), those inputs, the renderer's image and
    the render's wall seconds (image copy included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    first, n = WINDOW
    prof = profile(activities=[ProfilerActivity.CUDA])
    run = tpk.run_tail_steps
    rounds, clock, kept = 0, [], []

    def windowed(*args, **kw):
        nonlocal rounds
        if rounds == first + n // 2:
            kept.extend(x.clone() for x in args[:6])
        if rounds == first:
            torch.cuda.synchronize()
            prof.start()
            clock.append(time.perf_counter())
        out = run(*args, **kw)
        rounds += 1
        if rounds == first + n:
            torch.cuda.synchronize()
            clock.append(time.perf_counter())
            prof.stop()
        return out

    tpk.run_tail_steps = windowed
    t0 = time.perf_counter()
    try:
        img = renderer.render()
    finally:
        tpk.run_tail_steps = run
    wall = time.perf_counter() - t0
    log(f"[5] the slice's render {wall:.2f} s ({rounds} tail rounds, "
        f"{first}-{first + n - 1} profiled)")
    check(len(clock) == 2, f"the render ran {rounds} tail rounds, fewer "
          f"than the window's {first + n}")
    window_us = (clock[1] - clock[0]) * 1e6
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    summed_us = sum(e.self_device_time_total for e in on_card)
    busy_us = busy_union_us(prof)
    tail = [e for e in on_card if "tail_kernel" in e.key]
    if not tail or busy_us == 0.0:
        log(f"[5] profiler window: no device time in the trace; the tail "
            "kernel's in-slice time is not measured")
        return None, kept, img, wall
    launches = sum(e.count for e in tail)
    per_launch = sum(e.self_device_time_total for e in tail) / launches
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:5]
    log(f"[5] profiler window of the eager loop, tail rounds {first}-"
        f"{first + n - 1}: {window_us / 1e3:.2f} ms of wall, device busy "
        f"{busy_us / 1e3:.3f} ms ({busy_us / window_us:.1%}; the union of "
        f"the device intervals; their sum {summed_us / 1e3:.3f} ms); tail "
        f"kernel {launches} launches, {per_launch:.2f} us of device time per "
        f"launch; top device time: "
        + "; ".join(f"{e.key[:48]} x{e.count} {e.self_device_time_total:.0f} us"
                    for e in top) + f"; card {card}")
    return per_launch, kept, img, wall


def busy_union_us(prof) -> float:
    """Microseconds in which the card ran anything (kernels, copies, sets)
    in a torch.profiler trace: the union of the device intervals, so work
    that overlaps counts once."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    total, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (0.0 if hi is None else hi - lo)


@contextlib.contextmanager
def tail_stage_kept(kept: list, eager: bool = False, prof=None):
    """models/fast.py's _run_tailpk_stage wrapped to keep, per stage, its
    context, a copy of its entry state, its result and its wall (the card
    synchronised around it): with `eager` the stage runs its eager loop
    (the stage's eager_body=True path, the cascade staying on the body
    kernel), and with `prof` a torch.profiler runs over the stage alone."""
    import dataclasses

    import torch

    from cudavolumerenderer_tpu_torch.models import fast

    run = fast._run_tailpk_stage

    def stage(state, ctx):
        if eager:
            ctx = dataclasses.replace(ctx, eager_body=True)
        entry = clone_state(state)
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        out = run(state, ctx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        kept.append({"ctx": ctx, "entry": entry, "out": out, "wall": wall,
                     "window_us": wall * 1e6})
        return out

    fast._run_tailpk_stage = stage
    try:
        yield kept
    finally:
        fast._run_tailpk_stage = run


def slice_runs(renderer, card: str) -> dict:
    """Phase 5: the slice through the drain (three timed renders, the
    counts set to 0 just before the first and read just after it), once
    more with its tail stage kept and under torch.profiler (the drain's
    device time, the card's busy share over the stage), then with the
    tail stage's eager loop (profile_tail_window: its rounds 100-159
    profiled, round 130's inputs kept): both 6,040,005 rays, the same
    n_rows and n_busy, bit-equal images and stage states."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cudavolumerenderer_tpu_torch.ops import fastbody as fb
    from cudavolumerenderer_tpu_torch.ops import taildrain as td
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    torch.cuda.synchronize()
    tpk.KERNEL.launches = fb.KERNEL.launches = fb.KERNEL.reads = 0
    td.KERNEL.reset()
    t0 = time.perf_counter()
    img = renderer.render()
    walls = [time.perf_counter() - t0]
    drain = {"drain_launches": td.KERNEL.drain_launches,
             "reads": td.KERNEL.reads, "tail_launches": tpk.KERNEL.launches,
             "body_launches": fb.KERNEL.launches,
             "body_reads": fb.KERNEL.reads, **td.KERNEL.last_drain,
             "n_rays": renderer.n_rays}
    check(drain["drain_launches"] == 1 and drain["reads"] == 1,
          f"the slice's tail stage took {drain['drain_launches']} drain "
          f"launches and {drain['reads']} host reads, not 1 and 1")
    check(drain["tail_launches"] == 0, "the drain's render launched the tail "
          "kernel")
    for _ in range(2):
        t0 = time.perf_counter()
        again = renderer.render()
        walls.append(time.perf_counter() - t0)
        check(np.array_equal(again, img), "two renders through the drain "
              "differ")
    drain["walls"] = walls

    kept = []
    with tail_stage_kept(kept):
        renderer.render()
    drain["stage_walls"] = [kept[0]["wall"]]
    # the profiler's first session in a process pays its set-up inside the
    # window: one on a tiny op first
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    kept, prof = [], profile(activities=[ProfilerActivity.CUDA])
    with tail_stage_kept(kept, prof=prof):
        renderer.render()
    check(len(kept) == 1, f"{len(kept)} tail stages in one render")
    stage = kept[0]
    drain["stage_walls"].append(stage["wall"])
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    mine = [e for e in on_card if "drain_kernel" in e.key]
    busy_us = busy_union_us(prof)
    if mine and busy_us:
        stage["device_us"] = sum(e.self_device_time_total for e in mine)
        stage["busy"] = busy_us / stage["window_us"]
        log(f"[5] the drain's tail stage under torch.profiler: "
            f"{stage['window_us'] / 1e3:.3f} ms of wall, the drain "
            f"{stage['device_us'] / 1e3:.3f} ms of device time in "
            f"{sum(e.count for e in mine)} launch, the card busy "
            f"{busy_us / 1e3:.3f} ms ({stage['busy']:.1%}, the union of the "
            f"device intervals over the stage's wall) in "
            f"{sum(e.count for e in on_card)} device operations; card {card}")
    else:
        stage["device_us"] = stage["busy"] = None
        log("[5] the drain's tail stage: no device time in the profiler's "
            "trace; its device time and busy share are not measured")
    drain["stage"] = stage

    eager_kept = []
    torch.cuda.synchronize()
    tpk.KERNEL.launches = 0
    td.KERNEL.reset()
    with tail_stage_kept(eager_kept, eager=True):
        in_slice_us, round_inputs, eager_img, eager_wall = profile_tail_window(
            renderer, card)
    eager = {"walls": [eager_wall], "tail_launches": tpk.KERNEL.launches,
             "reads": td.KERNEL.reads, "drain_launches": td.KERNEL.drain_launches,
             "rounds": td.KERNEL.plain_rounds, "n_rays": renderer.n_rays,
             "stage": eager_kept[0], "in_slice_us": in_slice_us}
    check(eager["drain_launches"] == 0 and eager["tail_launches"] ==
          eager["rounds"] == drain["E"] > 0,
          f"the eager loop ran {eager['rounds']} rounds with "
          f"{eager['tail_launches']} tail-kernel launches, the drain "
          f"{drain['E']} rounds")
    diff, err = state_diff(stage["out"], eager["stage"]["out"])
    check(not state_diff(stage["entry"], eager["stage"]["entry"])[0],
          "the two renders enter the tail stage in different states")
    check(not diff, f"the drain's tail stage differs from the eager loop's: "
          f"{diff}")
    check(np.array_equal(img, eager_img), "the slice through the drain and "
          "through the eager loop give different images")
    check(drain["n_rays"] == eager["n_rays"], "n_rays differs between the "
          "drain and the eager loop")
    drain["max_abs_err"] = err
    for tag, run in (("drain", drain), ("eager loop", eager)):
        out = run["stage"]["out"]
        log(f"[5] slice through the {tag}: walls "
            + ", ".join(f"{w:.4f}" for w in run["walls"])
            + f" s (incl. image copy), {run['n_rays']:.0f} rays, n_rows "
            f"{float(out.n_rows):.0f}, n_busy {float(out.n_busy):.0f}; tail "
            f"stage " + ", ".join(f"{w * 1e3:.3f}" for w in run.get(
                "stage_walls", [run["stage"]["wall"]]))
            + f" ms (the card synchronised around it); drain launches "
            f"{run['drain_launches']}, host reads of the tail stage "
            f"{run['reads']}, tail-kernel launches {run['tail_launches']}; "
            f"card {card}")
    log(f"[5] the drain and the eager loop: images, n_rays, n_rows, n_busy "
        f"and every lane field of the tail stage bit-equal; {drain['E']} "
        f"rounds, the longest lane's {drain['L']}")
    return {"drain": drain, "eager": eager, "img": img,
            "round_inputs": round_inputs}


def slice_round(kept, card: str) -> float:
    """Phase 5: the tail kernel on one round's inputs kept from the slice
    (R = tail_pk_width paths at the render's own state): held against the
    plain version, each path's steps and scatters, and the device time per
    call in phase 3's graph protocol.  Returns that time in ms."""
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    R = kept[3].shape[1]
    got = tpk.run_tail_steps(*kept, n_steps=N_STEPS)
    want = tpk.tail_steps(*kept, n_steps=N_STEPS)
    (gf, gi, gs), (wf, wi, ws) = (
        [x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want])
    agree = (gi == wi).all(axis=0) & (gs == ws)
    check(agree.mean() >= 0.999, f"slice round: {int((~agree).sum())} paths "
          "differ from the plain version")
    np.testing.assert_allclose(gf[:, agree], wf[:, agree], rtol=RTOL,
                               atol=ATOL)
    statuses = np.bincount(gi[1], minlength=4).tolist()
    log(f"[5] slice round {WINDOW[0] + WINDOW[1] // 2}: R={R} K={N_STEPS}, "
        f"paths differing {int((~agree).sum())}; status RUN/NEED_WINDOW/"
        f"EXIT_BOX/DEAD = {statuses}")
    trace_paths(kept, R, "[5]")
    ms = graph_ms([lambda: tpk.run_tail_steps(*kept, n_steps=N_STEPS)]
                  * GRAPH_CALLS)
    log(f"[5] slice round: kernel {ms * 1e3:.2f} us of device time per call "
        f"(graph of {GRAPH_CALLS}); card {card}")
    return ms


def tail_drain_alone(drain_stage: dict, eager_stage: dict, ptxas: str,
                     card: str) -> dict:
    """Phase 27: the tail stage's drain on the state kept at the slice's
    tail stage: two launches in turns, each timed by CUDA events around
    the launch and equal to the eager loop's state bit for bit; the
    longest lane's rounds and us per round; the byte bound (ops/taildrain
    .drain_bytes over every round's taps of the plain loop, with the tail
    kernel's plain version) and its share; the eager loop's wall."""
    import torch

    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.ops import taildrain as td
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    from cudavolumerenderer_tpu_torch.ops.stages import C_LEFT, C_LMAX, C_TOTAL

    ctx, entry = drain_stage["ctx"], drain_stage["entry"]
    want = eager_stage["out"]
    ms = []
    for _ in range(2):
        prep = td.KERNEL.prepare(ctx, clone_state(entry))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        td.KERNEL.launch(prep)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        words = prep.ctrl.tolist()
        check(words[C_LEFT] == 0, "the timed drain left lanes at its cap")
        diff, _ = state_diff(prep.state, want)
        check(not diff, f"the drain on the kept state differs from the eager "
              f"loop: {diff}")
    info = {"L": words[C_LMAX], "E": words[C_TOTAL]}
    taps = []
    t0 = time.perf_counter()
    plain = fast.plain_stage(ctx, clone_state(entry), taps)
    taps_s = time.perf_counter() - t0
    n_bytes = td.drain_bytes(taps)
    n_taps = sum(x.numel() for k, x in taps if k == "tab")
    bound, bound_by = bound_ms(n_bytes, tpk.STEP_OPS * n_taps)
    close = state_diff(plain, want)[0]
    per_round = min(ms) * 1e3 / info["L"]
    plain_ms = eager_stage["wall"] * 1e3
    log(f"[27] the tail stage's drain, R = {entry.alive.shape[0]}, "
        f"K = {ctx.pk_steps}: {ms[0]:.3f} and {ms[1]:.3f} ms (CUDA events "
        f"around one launch, two in turns), each bit-equal to the eager "
        f"loop; the longest lane {info['L']} rounds (E = {info['E']}), "
        f"{per_round:.2f} us per round of it; the eager loop's wall "
        f"{plain_ms:.1f} ms; bound {bound * 1e3:.3f} us by {bound_by} "
        f"({n_bytes} B: state, {n_taps} taps' distinct words, per-round "
        f"counts), the drain at {bound / min(ms):.3%} of it; the plain "
        f"loop with the tail kernel's plain version {taps_s:.1f} s, lanes "
        f"apart from the eager loop's: {close or 'none'}; drain_kernel "
        f"ptxas: {ptxas}; card {card}")
    return {"ms": sum(ms) / len(ms), "ms_runs": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "bound_bytes": n_bytes,
            "L": info["L"], "E": info["E"], "us_per_round": per_round,
            "ptxas": ptxas}


def tail_phases(card: str) -> dict:
    """Phases 5 and 27 alone: config 2's scene written and loaded, the
    slice through the drain and through the eager loop, round 130's tail
    kernel, then the drain on the kept state."""
    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene

    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(scene_file=write_medical_mhd(tmp), kernel=Kernel.FAST_SK,
                     two_level=True, tail_pallas=True, resolution=(512, 512),
                     iterations=4, n_tiles=(1, 1))
        scene, camera = load_scene(cfg, device="cuda")
    runs = slice_runs(create_renderer(scene, camera, cfg), card)
    slice_round(runs["round_inputs"], card)
    ptxas = ptxas_of(tpk.KERNEL.library().log, "drain_kernel")
    return tail_drain_alone(runs["drain"]["stage"], runs["eager"]["stage"],
                            ptxas, card)


def ptxas_of(log_text: str, kernel: str) -> str:
    """The ptxas lines (spills, registers) of the entry function whose
    mangled name holds `kernel`, from a build log."""
    out, mine = [], False
    for line in log_text.splitlines():
        if "Function properties for" in line:
            mine = kernel in line
        elif mine and ("spill" in line or "Used" in line):
            out.append(line.split(":", 1)[-1].strip())
    return "; ".join(out) or "not in the build log"


def furnace_and_small_render():
    """Phase 4: exact white furnace through the kernel, then a small
    medical render on the card against the CPU (plain-version) render."""
    import torch

    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.ops import taildrain as td
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk
    from cudavolumerenderer_tpu_torch.ops.camera import make_camera
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import (
        RenderSettings, make_medium, make_scene,
    )

    tail = dict(two_level=True, tail_pallas=True, tail_pk_width=16,
                tail_pk_steps=8, min_width=32)
    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = make_scene(make_medium(d, 1.0, scale=8.0, max_density=1.0,
                                   device="cuda"))
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=200, bsdf_kind="null")
    for eager in (False, True):
        before = tpk.KERNEL.launches, td.KERNEL.drain_launches
        img, _ = fast.render_tile(
            scene, make_camera(6, 6, device="cuda"), settings, (6, 6),
            torch.zeros(2, device="cuda"), (6, 6), 2, 3, 0, eager_body=eager,
            **tail)
        img = img.cpu().numpy()
        launched = (tpk.KERNEL.launches - before[0],
                    td.KERNEL.drain_launches - before[1])
        check(launched[eager == False] > 0,  # noqa: E712
              "white furnace launched no " + ("tail kernel" if eager else
                                              "drain"))
        np.testing.assert_allclose(img, 2.0, rtol=2e-5)
        log(f"[4] white furnace exact through the "
            + (f"eager loop's tail kernel ({launched[0]} launches)" if eager
               else f"tail stage's drain ({launched[1]} launch)"))

    d = procedural.medical_volume((24, 24, 24), n_blobs=6)
    albedo = np.zeros(d.shape + (3,), np.float32)
    albedo[..., 0] = d
    settings = RenderSettings.from_flags(True, max_path_length=64)
    imgs = []
    for dev in ("cuda", "cpu"):
        scene = make_scene(make_medium(d, albedo, scale=30.0, max_density=1.0,
                                       device=dev))
        img, _ = fast.render_tile(
            scene, make_camera(8, 8, device=dev), settings, (8, 8),
            torch.zeros(2, device=dev), (8, 8), 32, 5, 0, **tail)
        imgs.append(img.cpu().numpy() / 32)
    a, b = imgs
    share = float(np.mean(np.abs(a - b) < 1e-4))
    log(f"[4] small render card vs CPU: means {a.mean():.5f} / {b.mean():.5f}, "
        f"max |diff| {np.abs(a - b).max():.4f}, pixels equal within 1e-4 "
        f"{share:.3f}")
    check(np.isfinite(a).all(), "small render not finite")
    check(abs(a.mean() - b.mean()) < 0.02 and np.abs(a - b).max() < 0.25,
          "small render on the card disagrees with the CPU render")


def track_vs_plain(tables, major, n_rows: int, n_steps: int, card: str):
    """Phase 6 at one shape: returns (max_abs_err, kernel ms, plain ms,
    bound ms, bound_by)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import tracking as tk

    inputs = tk.random_track_state(
        major, n_rows, seed=n_rows + n_steps, scale=800.0,
        vox_per_unit=(127.0, 127.0, 49.0),
    )
    args = (tables, *inputs)
    got = tk.run_track_steps(*args, n_steps=n_steps)
    torch.cuda.synchronize()
    taps = []
    want = tk.track_steps(*args, n_steps=n_steps, taps=taps)
    (gt, gs, gtap, gst), (wt, ws, wtap, wst) = (
        [x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want]
    )
    agree = (gs == ws) & (gtap == wtap) & (gst == wst)
    n_diff = int((~agree).sum())
    statuses = np.bincount(gs.ravel(), minlength=5).tolist()
    log(f"[6] R={n_rows} K={n_steps}: lanes differing {n_diff}/{agree.size}; "
        f"status RUNNING/SCATTER/EXIT_BRICK/EXIT_BOX/other = {statuses}")
    check(agree.mean() >= 0.999, f"R={n_rows} K={n_steps}: {n_diff} lanes differ")
    a, b = gt[agree], wt[agree]
    fin = np.isfinite(a) & np.isfinite(b)
    check(np.array_equal(a[~fin], b[~fin], equal_nan=True),
          f"R={n_rows}: non-finite outputs differ")
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)
    err = float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))
    ms = graph_ms([lambda: tk.run_track_steps(*args, n_steps=n_steps)]
                  * GRAPH_CALLS)
    plain_ms = cuda_ms(lambda: tk.track_steps(*args, n_steps=n_steps), 10, 2)
    bound, bound_by, n_bytes, words, n_taps = tap_bound(
        taps, lambda w: tk.track_bytes(n_rows, w), tk.STEP_OPS)
    log(f"[6] R={n_rows} K={n_steps}: kernel {ms * 1e3:.2f} us of device "
        f"time per call (graph of {GRAPH_CALLS}), plain torch "
        f"{plain_ms:.4f} ms (eager, host-bound); bound {bound * 1e3:.3f} us "
        f"by {bound_by} ({n_bytes} B, {words} distinct table words of "
        f"{n_taps} taps), the kernel at {bound / ms:.1%} of it; max "
        f"|err| {err:.3g}; card {card}")
    return err, ms, plain_ms, bound, bound_by


def track_cold(tables, major, card: str) -> None:
    """Phase 6 at the slice's shape (R = 1,250, K = 8): the kernel's device
    time with its inputs cold (a graph of 16 calls on 16 input sets,
    16 x 15.4 MB), beside the graph of 16 calls on one input set, whose
    inputs stay in L2."""
    from cudavolumerenderer_tpu_torch.ops import tracking as tk

    def inputs(seed):
        return (tables, *tk.random_track_state(
            major, 1250, seed=seed, scale=800.0,
            vox_per_unit=(127.0, 127.0, 49.0)))

    sets = [inputs(1258 + k) for k in range(GRAPH_CALLS)]
    cold = graph_ms([lambda a=a: tk.run_track_steps(*a, n_steps=8)
                     for a in sets])
    log(f"[6] R=1250 K=8: kernel {cold * 1e3:.2f} us per call with cold "
        f"inputs (16 input sets per graph); card {card}")


def brick_furnace_and_small_render():
    """Phase 7: exact white furnace through brickSK's round kernels
    (csrc/brickbody.cu) on the card, then a small smoke render on the card
    (the kernels) against the CPU (plain-version) render."""
    import torch

    from cudavolumerenderer_tpu_torch.models import brick
    from cudavolumerenderer_tpu_torch.ops import brickbody as bb
    from cudavolumerenderer_tpu_torch.ops import tracking as tk
    from cudavolumerenderer_tpu_torch.ops.camera import make_camera
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import (
        RenderSettings, make_medium, make_scene,
    )

    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = make_scene(make_medium(d, 1.0, scale=8.0, max_density=1.0,
                                   device="cuda"))
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, bsdf_kind="null")
    bb.KERNEL.reset()
    before = tk.KERNEL.launches
    img, _, rounds = brick.render_tile(
        scene, make_camera(16, 16, device="cuda"), settings, (16, 16),
        torch.zeros(2, device="cuda"), (16, 16), 2, 3, 0, with_stats=True)
    img = img.cpu().numpy()
    launched = dict(bb.KERNEL.by_op)
    check(launched["phase_a"] == launched["round"] >= rounds > 0
          and tk.KERNEL.launches == before,
          f"{launched} round-kernel launches in {rounds} rounds")
    check(np.array_equal(img, np.full_like(img, 2.0)),
          "brickSK white furnace not exact")
    log(f"[7] brickSK white furnace exact through csrc/brickbody.cu "
        f"({rounds} rounds, {launched} launches, {bb.KERNEL.reads} host "
        "reads)")

    d = procedural.smoke_volume((32, 32, 16))
    alb = np.stack([d, d, d], axis=-1) * 0.9
    out = []
    for dev in ("cuda", "cpu"):
        scene = make_scene(make_medium(d, alb, scale=800.0,
                                       max_density=float(d.max()), device=dev))
        img, n_rays, rounds = brick.render_tile(
            scene, make_camera(16, 16, device=dev), RenderSettings(),
            (16, 16), torch.zeros(2, device=dev), (16, 16), 2, 5, 0,
            with_stats=True)
        out.append((img.cpu().numpy() / 2, float(n_rays), rounds))
    (a, ra, na), (b, rb, nb) = out
    share = float(np.mean(np.abs(a - b) < 1e-4))
    log(f"[7] small brickSK render card vs CPU: means {a.mean():.5f} / "
        f"{b.mean():.5f}, rays {ra:.0f} / {rb:.0f}, rounds {na} / {nb}, "
        f"pixels equal within 1e-4 {share:.3f}")
    check(np.isfinite(a).all(), "small brickSK render not finite")
    check(abs(a.mean() - b.mean()) < 0.02 and abs(ra - rb) <= 0.01 * rb,
          "small brickSK render on the card disagrees with the CPU render")


def brick_slice(bcfg, dev, card: str) -> dict:
    """Phase 8: the brickSK slice through the CLI's batch mode, once
    through the round kernels (counts set to 0 just before and read just
    after: rounds, launches, sorts, host reads) and once with
    eager_body=True (the eager loop, one tracking-kernel launch a round);
    brick.render_tile is wrapped to count rounds and keep the image.  Both
    must give 1,151,411 rays, the same rounds and the same image bit for
    bit."""
    import torch

    from cudavolumerenderer_tpu_torch import cli
    from cudavolumerenderer_tpu_torch.models import brick
    from cudavolumerenderer_tpu_torch.ops import brickbody as bb
    from cudavolumerenderer_tpu_torch.ops import tracking as tk
    from cudavolumerenderer_tpu_torch.utils.image import load_hdr

    tile_fn = brick.render_tile
    runs = {}
    for label, eager in (("kernels", False), ("eager", True)):
        kept = []

        def counted(*args, _eager=eager, _kept=kept, **kw):
            img, n_rays, rounds = tile_fn(*args, with_stats=True,
                                          eager_body=_eager, **kw)
            _kept.append((img, int(rounds)))
            return img, n_rays

        torch.cuda.synchronize()
        bb.KERNEL.reset()
        tk.KERNEL.launches = 0
        brick.render_tile = counted
        t0 = time.perf_counter()
        try:
            result = cli.run_test(bcfg, dev)
        finally:
            brick.render_tile = tile_fn
        cli_wall = time.perf_counter() - t0
        saved = load_hdr(bcfg.output_name + ".hdr")
        check(saved.shape == (400, 400, 3) and np.isfinite(saved).all(),
              f"phase 8 ({label}): the CLI's saved image is not finite or "
              "has the wrong shape")
        check(len(kept) == 1, f"phase 8 ({label}): {len(kept)} tiles")
        img, rounds = kept[0]
        wall, n_rays = result["mean_time_with_copy"], result["n_rays"]
        row = {
            "wall": wall, "mean_time": result["mean_time"], "cli_wall":
            cli_wall, "n_rays": n_rays, "rounds": rounds,
            "mrays": n_rays / wall / 1e6, "mean": float(saved.mean()),
            "track_launches": tk.KERNEL.launches,
            "launches": dict(bb.KERNEL.by_op), "sorts": bb.KERNEL.sorts,
            "reads": bb.KERNEL.reads,
            "image": img,
        }
        runs[label] = row
        log(f"[8] brickSK slice 400^2 x 4 ({label}): {wall:.4f} s wall "
            f"(incl. image copy; CLI {cli_wall:.2f} s in all), {n_rays:.0f} "
            f"rays, {row['mrays']:.4f} Mrays/s, {rounds} rounds, "
            f"{wall / rounds * 1e3:.4f} ms per round, round-kernel launches "
            f"{row['launches']}, sorts {row['sorts']}, tracking-kernel "
            f"launches {row['track_launches']}, host reads {row['reads']}, "
            f"image mean {row['mean']:.5f}; card {card}")
    k, e = runs["kernels"], runs["eager"]
    check(k["n_rays"] == e["n_rays"] == BRICK_RAYS,
          f"phase 8: {k['n_rays']:.0f} / {e['n_rays']:.0f} rays, not "
          f"{BRICK_RAYS}")
    check(k["rounds"] == e["rounds"] > 0,
          f"phase 8: {k['rounds']} rounds through the kernels, "
          f"{e['rounds']} eager")
    check(torch.equal(k["image"], e["image"]),
          "phase 8: the kernels' image differs from the eager loop's")
    check(0.05 < k["mean"] < 1.5, f"brickSK slice image mean {k['mean']} "
          "implausible")
    check(k["launches"]["phase_a"] >= k["rounds"]
          and k["launches"]["round"] >= k["rounds"]
          and k["track_launches"] == 0,
          f"phase 8: the kernel render launched {k['launches']} for "
          f"{k['rounds']} rounds and {k['track_launches']} tracking kernels")
    check(e["track_launches"] == e["rounds"],
          f"phase 8: the eager loop launched {e['track_launches']} tracking "
          f"kernels in {e['rounds']} rounds")
    check(k["reads"] < k["rounds"] // 8,
          f"phase 8: {k['reads']} host reads in {k['rounds']} rounds")
    log(f"[8] brickSK slice: the kernels' image bit-equal to the eager "
        f"loop's, {BRICK_RAYS} rays and {k['rounds']} rounds each; wall "
        f"{k['wall']:.4f} s against {e['wall']:.3f} s "
        f"({e['wall'] / k['wall']:.1f}x); card {card}")
    for row in runs.values():
        del row["image"]
    return runs


def brick_float_err(a, b) -> float:
    """The largest absolute difference of two brick states' finite float
    fields (0 when they are equal)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import brickbody as bb
    from cudavolumerenderer_tpu_torch.ops.stages import lane_field

    err = 0.0
    for n in bb.STATE_FIELDS:
        x, y = lane_field(a, n), lane_field(b, n)
        if x.dtype == torch.float32:
            fin = torch.isfinite(x) & torch.isfinite(y)
            if bool(fin.any()):
                err = max(err, float((x - y)[fin].abs().max()))
    return err


def brick_differs(a, b) -> list:
    """The brick-state fields that differ bit for bit (and n_rays)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import brickbody as bb
    from cudavolumerenderer_tpu_torch.ops.stages import lane_field

    bad = []
    for n in bb.STATE_FIELDS:
        x, y = lane_field(a, n), lane_field(b, n)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(n)
    if not torch.equal(a.n_rays.view(torch.int32), b.n_rays.view(torch.int32)):
        bad.append("n_rays")
    return bad


def brick_state_row(ctx, s, pos, bufs, tag: str, card: str):
    """Phase 26 on one kept state (lanes in place at positions pos): each
    kernel against its plain version (every lane field bit for bit, the
    keys, perm, count and pos), timed per launch by CUDA events over graph
    replays of 16 out-of-place launches, its plain version by CUDA events
    (the input's copy included), the sort between them, and each kernel's
    byte bound (ops/brickbody.brick_bytes).  Returns (row, the state after
    the kernels' round, its pos, the largest float difference)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import brickbody as bb

    dev = torch.device("cuda")
    k = bb.KERNEL
    # phase A
    got, keys, perm, count = bb.phase_a(ctx, bb.own(s), pos.clone(), bufs)
    taps_a = []
    want, wkeys, wperm, wcount = bb.plain_phase_a(ctx, bb.own(s), pos,
                                                  taps=taps_a)
    bad = brick_differs(got, want)
    bad += [] if torch.equal(keys, wkeys) else ["keys"]
    bad += [] if torch.equal(perm, wperm) else ["perm"]
    bad += [] if int(count) == int(wcount) else ["count"]
    err = brick_float_err(got, want)
    check(not bad, f"phase 26, {tag}: phase_a_kernel differs from its plain "
          f"version in {bad}")
    spare = bb.RoundBuffers.make(ctx.n_lanes, dev)
    src, out = bb.own(s), bb.own(s)
    prep = k.prepare(ctx, "phase_a", src, pos.clone(), spare, out=out,
                     pos_out=torch.empty_like(pos),
                     n_rays_out=torch.empty((), device=dev))
    ms_a = graph_ms([lambda: k.launch(prep, dev)] * GRAPH_CALLS)
    plain_a = cuda_ms(lambda: bb.plain_phase_a(ctx, bb.own(s), pos), reps=3,
                      warmup=1)
    bytes_a = bb.brick_bytes(ctx, taps_a)
    # the sort
    bufs.sort()
    spare.keys.copy_(bufs.keys)
    sort_ms = graph_ms([spare.sort] * GRAPH_CALLS)
    # the tracking round
    base, bpos = want, pos
    got_r, got_pos = bb.round_(ctx, bb.own(base), bpos.clone(), bufs)
    taps_r = []
    want_r, want_pos = bb.plain_round(ctx, bb.own(base), bpos, bufs.perm,
                                      bufs.skeys, bufs.order, taps=taps_r)
    bad = brick_differs(got_r, want_r)
    bad += [] if torch.equal(got_pos, want_pos) else ["pos"]
    err = max(err, brick_float_err(got_r, want_r))
    check(not bad, f"phase 26, {tag}: round_kernel differs from its plain "
          f"version in {bad}")
    src, out = bb.own(base), bb.own(base)
    prep = k.prepare(ctx, "round", src, bpos.clone(), bufs, out=out,
                     pos_out=torch.empty_like(bpos))
    ms_r = graph_ms([lambda: k.launch(prep, dev)] * GRAPH_CALLS)
    plain_r = cuda_ms(lambda: bb.plain_round(
        ctx, bb.own(base), bpos, bufs.perm, bufs.skeys, bufs.order),
        reps=3, warmup=1)
    bytes_r = bb.brick_bytes(ctx, taps_r)
    key_rows = bufs.skeys.reshape(-1, 128)
    usable = int(((key_rows == key_rows[:, :1])
                  & (key_rows[:, :1] != bb.SENTINEL)).sum())
    pending, tracking = int(wcount), int(want.tracking.sum())
    row = {"pending": pending, "tracking": tracking, "usable": usable,
           "sort_ms": sort_ms}
    for op, ms, plain, n_bytes in (("phase_a", ms_a, plain_a, bytes_a),
                                   ("round", ms_r, plain_r, bytes_r)):
        bound, bound_by = bound_ms(n_bytes)
        row[op] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                   "bound_by": bound_by, "bytes": n_bytes}
        log(f"[26] {tag}: {op:7s} kernel {ms * 1e3:8.2f} us per launch, "
            f"plain {plain:8.3f} ms; bound {n_bytes} B = "
            f"{bound * 1e3:.3f} us ({bound / ms:.1%}); bit-equal; card {card}")
    log(f"[26] {tag}: {pending} lanes pending, {tracking} tracking, "
        f"{usable} usable in the round; the stable sort "
        f"{sort_ms * 1e3:.2f} us per call; card {card}")
    return row, got_r, got_pos, err


def brick_profile(ctx, s, pos, first: int, card: str) -> dict:
    """Phase 26: BRICK_PROFILE_ROUNDS rounds of a render from the state
    (s, pos) kept at round `first`: the gated runner's launches (prepared
    once, in place, without the gate) under torch.profiler, with the wall
    inside its window, each kernel's mean device time per launch there and
    the sort's; then the same rounds by the plain versions from the same
    state, whose taps give each kernel's mean byte bound per launch over
    those rounds, and whose final state must equal the kernels' bit for
    bit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cudavolumerenderer_tpu_torch.ops import brickbody as bb

    dev = torch.device("cuda")
    n = BRICK_PROFILE_ROUNDS
    ks, kpos = bb.own(s), pos.clone()
    bufs = bb.RoundBuffers.make(ctx.n_lanes, dev)
    phase = bb.KERNEL.prepare(ctx, "phase_a", ks, kpos, bufs)
    rnd = bb.KERNEL.prepare(ctx, "round", ks, kpos, bufs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            bb.KERNEL.launch(phase, dev)
            bufs.sort()
            bb.KERNEL.launch(rnd, dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    check(busy > 0, "phase 26: the profiler saw no device time")

    def per_launch(name):
        """Mean device ms of the launches the profiler recorded (CUPTI
        can miss the first launch of a window)."""
        hits = [e for e in on_card if name in e.key]
        count = sum(e.count for e in hits)
        check(n - 1 <= count <= n,
              f"phase 26: the profiler saw {count} {name} launches of {n}")
        return sum(e.self_device_time_total for e in hits) / 1e3 / count

    ms = {"phase_a": per_launch("phase_a_kernel"),
          "round": per_launch("round_kernel")}
    sort_ms = busy / n - ms["phase_a"] - ms["round"]
    # the same rounds by the plain versions: their taps, and the state
    ps, ppos, n_bytes = bb.own(s), pos.clone(), {"phase_a": 0, "round": 0}
    for _ in range(n):
        taps_a, taps_r = [], []
        ps, keys, perm, _ = bb.plain_phase_a(ctx, ps, ppos, taps=taps_a)
        skeys, order = torch.sort(keys, stable=True)
        ps, ppos = bb.plain_round(ctx, ps, ppos, perm, skeys, order,
                                  taps=taps_r)
        n_bytes["phase_a"] += bb.brick_bytes(ctx, taps_a)
        n_bytes["round"] += bb.brick_bytes(ctx, taps_r)
    bad = brick_differs(ks, ps) + ([] if torch.equal(kpos, ppos)
                                   else ["pos"])
    check(not bad, f"phase 26: {n} kernel rounds differ from the plain "
          f"versions' in {bad}")
    out = {"rounds": n, "first": first, "wall_ms": wall, "busy_ms": busy,
           "busy_share": busy / wall,
           "kernels_per_round": sum(e.count for e in on_card) / n,
           "sort_ms": sort_ms, "pending_after": int(
               (ks.alive | (ks.samples_done < ctx.spp_per_lane)).sum())}
    for op in ("phase_a", "round"):
        bound, bound_by = bound_ms(n_bytes[op] / n)
        out[op] = {"ms": ms[op], "bound_ms": bound, "bound_by": bound_by,
                   "bytes": n_bytes[op] / n}
        log(f"[26] 160000 lanes, rounds {first}-{first + n - 1} in place "
            f"(torch.profiler): {op:7s} kernel {ms[op] * 1e3:.2f} us per "
            f"launch; bound {n_bytes[op] / n:.0f} B = {bound * 1e3:.3f} us "
            f"({bound / ms[op]:.1%}); card {card}")
    log(f"[26] 160000 lanes, rounds {first}-{first + n - 1}: {wall:.2f} ms "
        f"wall, {busy:.3f} ms of device time ({busy / wall:.1%} busy), "
        f"{out['kernels_per_round']:.1f} device kernels a round, the sort "
        f"and the rest {sort_ms * 1e3:.2f} us a round; bit-equal to the "
        f"plain versions' {n} rounds; card {card}")
    return out


def brick_kernels(scene, camera, bcfg, card: str) -> dict:
    """Phase 26: brickSK's round kernels on rounds kept from the slice (its
    scene and settings, 400^2 x 4: 160,000 lanes) and from a 48x40 tile in
    its middle (1,920 lanes, 15 rows): at each kept round each kernel
    against its plain version and timed (brick_state_row); then
    BRICK_PROFILE_ROUNDS rounds of the 160,000-lane render under
    torch.profiler (device kernels per round, the card's busy share)."""
    import torch

    from cudavolumerenderer_tpu_torch.models import brick
    from cudavolumerenderer_tpu_torch.ops import brickbody as bb

    dev = torch.device("cuda")
    rows, err, profiled = {}, 0.0, None
    for label, tw, th, off, kept in BRICK_STATES:
        ctx = brick.make_context(
            scene, camera, bcfg.settings, (tw, th),
            torch.tensor(off, dtype=torch.float32, device=dev),
            tuple(bcfg.resolution), bcfg.iterations, bcfg.seed, 0)
        s = bb.own(brick.initial_state(ctx))
        pos = torch.arange(ctx.n_lanes, device=dev)
        bufs = bb.RoundBuffers.make(ctx.n_lanes, dev)
        done = 0
        rows[label] = {}
        for r in kept:
            for _ in range(r - done):
                s, pos = bb.one_round(ctx, s, pos, bufs)
            row, s, pos, e = brick_state_row(ctx, s, pos, bufs,
                                             f"{label} lanes, round {r}",
                                             card)
            rows[label][r] = row
            err = max(err, e)
            done = r + 1
        if label == "160000":
            profiled = brick_profile(ctx, s, pos, done, card)
    return {"rows": rows, "max_abs_err": err, "profile": profiled}


def row_kernel_fn(kernel: str, fields: dict, keywords: dict):
    """make_kernel_fn's function for the row, with the render_tile
    keywords no Config field sets (naiveMK's compaction switch)."""
    import functools

    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models import wavefront_mk
    from cudavolumerenderer_tpu_torch.models.renderer import make_kernel_fn

    if keywords:
        check(kernel == "naiveMK", f"no render_tile keywords for {kernel}")
        return functools.partial(wavefront_mk.render_tile, **keywords)
    return make_kernel_fn(Config(kernel=Kernel.from_name(kernel), **fields))


def family_counts(fam) -> dict:
    """The family kernels' counts since their last reset: launches per entry
    point and of the drain, host reads, the loops' evaluations (passes)
    and the plain versions' evaluations."""
    k = fam.KERNEL
    return {**k.by_op, "drain": k.drain_launches, "reads": k.reads,
            "passes": k.evals, "plain": sum(k.plain_evals.values()),
            "launches": sum(k.by_op.values()) + k.drain_launches}


def fastq_counts(fqb) -> dict:
    """fastQ's kernels' counts since their last reset, in family_counts's
    keys: body launches (gated ones included), drain launches, host reads,
    the loop's iterations (passes) and the plain body's evaluations."""
    k = fqb.KERNEL
    return {"body": k.launches, "drain": k.drain_launches, "reads": k.reads,
            "passes": k.evals, "plain": k.plain_evals,
            "launches": k.launches + k.drain_launches}


def family_rows(xml: str, card: str) -> dict:
    """Phase 11's rows on the slice's scene: each row's image, n_rays, walls
    and passes through the kernels and with the eager bodies, in turns;
    the kernels' counts summed over the rows' kernel renders (each render
    the main path: the counts set to 0 just before it, read just after)."""
    import functools

    import torch

    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.ops import familybody as fam
    from cudavolumerenderer_tpu_torch.ops import fastqbody as fqb
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene

    base = dict(scene_file=xml, iterations=1, resolution=(400, 400),
                n_tiles=(1, 1))
    scene, camera = load_scene(Config(**base), device="cuda")
    # one untimed render through the kernels and one eager (first calls)
    for kernel in (Kernel.NAIVE_SK, Kernel.FAST_Q):
        warm = create_renderer(scene, camera, Config(
            kernel=kernel, **{**base, "resolution": (64, 64)}))
        warm.render()
        warm.kernel_fn = functools.partial(warm.kernel_fn, eager_body=True)
        warm.render()
    rows, totals = {}, {}
    for label, kernel, fields, keywords in FAMILY_ROWS:
        cfg = Config(kernel=Kernel.from_name(kernel), **base, **fields)
        fastq = label in FASTQ_LABELS
        runs = {}
        for mode in ("kernels", "eager"):
            renderer = create_renderer(scene, camera, cfg)
            fn = (row_kernel_fn(kernel, fields, keywords) if keywords
                  else renderer.kernel_fn)
            if mode == "eager":
                fn = functools.partial(fn, eager_body=True)
            renderer.kernel_fn = fn
            torch.cuda.synchronize()
            fam.KERNEL.reset()
            fqb.KERNEL.reset()
            t0 = time.perf_counter()
            img = renderer.render()
            wall = time.perf_counter() - t0
            n_rays = renderer.n_rays
            counts = fastq_counts(fqb) if fastq else family_counts(fam)
            check(img.shape == (400, 400, 3) and np.isfinite(img).all(),
                  f"{label} ({mode}): image not finite or wrong shape")
            runs[mode] = dict(img=img, n_rays=n_rays, wall=wall, **counts)
            ops = ("body", "drain") if fastq else (*fam.OPS, "drain")
            log(f"[11] {label:22s} {mode:7s} 400^2 x 1: {wall:8.4f} s "
                f"wall (incl. image copy), {counts['passes']:5d} passes, "
                f"{counts['launches']:5d} kernel launches ("
                + ", ".join(f"{op} {counts[op]}" for op in ops
                            if counts[op])
                + f"), {counts['reads']:4d} host reads, {n_rays:.0f} "
                f"rays, {n_rays / wall / 1e6:.4f} Mrays/s, Config.n_lanes"
                f" {cfg.n_lanes}, image mean {img.mean():.6f}; card {card}")
        got, eager = runs["kernels"], runs["eager"]
        check(got["launches"] > 0 and got["plain"] == 0,
              f"{label}: the kernel render ran {got['plain']} eager "
              f"evaluations and {got['launches']} launches")
        check(eager["launches"] == 0 and eager["plain"] > 0,
              f"{label}: the eager render launched a kernel")
        check(got["n_rays"] == eager["n_rays"]
              and got["passes"] == eager["passes"],
              f"{label}: kernels {got['n_rays']:.0f} rays in "
              f"{got['passes']} passes, eager {eager['n_rays']:.0f} in "
              f"{eager['passes']}")
        err = float(np.abs(got["img"] - eager["img"]).max())
        log(f"[11] {label:22s} kernels / eager: wall {got['wall']:.4f} / "
            f"{eager['wall']:.4f} s ({eager['wall'] / got['wall']:.1f}x),"
            f" max |image - eager's| {err:.3g}")
        rows[label] = dict(img=got["img"], n_rays=got["n_rays"],
                           wall=got["wall"], passes=got["passes"],
                           eager_wall=eager["wall"],
                           launches=got["launches"], reads=got["reads"],
                           eager_reads=eager["reads"])
        for key in ("body", "drain") if fastq else (*fam.OPS, "drain"):
            tkey = f"fastq_{key}" if fastq else key
            totals[tkey] = totals.get(tkey, 0) + got[key]

    # streamingSK through the kernels again, under torch.profiler
    cfg = Config(kernel=Kernel.STREAMING_SK, **base)
    renderer = create_renderer(scene, camera, cfg)
    torch.cuda.synchronize()
    fam.KERNEL.reset()
    _, n_kernels, busy_ms = device_time(renderer.render)
    passes, wall_ms = fam.KERNEL.evals, rows["streamingSK"]["wall"] * 1e3
    if busy_ms is None:
        log("[11] streamingSK under the profiler: no device time in the "
            "trace; the busy share is not measured")
    else:
        log(f"[11] streamingSK through the kernels under torch.profiler: "
            f"{passes} passes, device busy {busy_ms:.3f} ms "
            f"({busy_ms / passes * 1e3:.2f} us per pass), "
            f"{n_kernels / passes:.1f} device kernels per pass; the card "
            f"{busy_ms / wall_ms:.1%} busy over the unprofiled render's "
            f"{wall_ms:.2f} ms; card {card}")
    return {"rows": rows, "launches": totals,
            "variable": variable_rows(scene, camera, base, card)}


def variable_rows(scene, camera, base: dict, card: str) -> dict:
    """Phase 11 under --boundary variable: naiveSK, naiveMK and
    regenerationSK 0 at 400^2 x 1 through the kernels (the bounce's
    isosurface march; counts set to 0 just before each render and read
    just after), each giving naiveSK-variable's n_rays and an image
    allclose to it; then each with the eager bodies at
    VARIABLE_EAGER_RES^2 beside the kernels at that size (the same n_rays,
    images within the family's tolerance); then the white furnace through
    the kernels.  Returns the rows and the kernels' launches."""
    import dataclasses
    import functools

    import torch

    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.ops import familybody as fam

    settings = dataclasses.replace(Config().settings, boundary="variable")
    rows, launches = {}, {**dict.fromkeys(fam.OPS, 0), "drain": 0}

    def render(label, res, eager, scene_=scene, camera_=camera, sett=settings):
        _, kernel, fields, keywords = next(
            r for r in FAMILY_ROWS if r[0] == label)
        cfg = Config(kernel=Kernel.from_name(kernel), settings=sett,
                     **{**base, "resolution": (res, res)}, **fields)
        renderer = create_renderer(scene_, camera_, cfg)
        if eager:
            renderer.kernel_fn = functools.partial(renderer.kernel_fn,
                                                   eager_body=True)
        torch.cuda.synchronize()
        fam.KERNEL.reset()
        t0 = time.perf_counter()
        img = renderer.render()
        wall = time.perf_counter() - t0
        return img, renderer.n_rays, wall, family_counts(fam)

    for label in VARIABLE_ROWS:
        img, n_rays, wall, counts = render(label, 400, False)
        check(np.isfinite(img).all() and counts["launches"] > 0
              and counts["plain"] == 0,
              f"{label} variable: {counts['plain']} eager evaluations, "
              f"{counts['launches']} launches")
        for key in launches:
            launches[key] += counts[key]
        ref = rows.get("naiveSK", {"img": img, "n_rays": n_rays})
        check(n_rays == ref["n_rays"], f"{label} variable traced "
              f"{n_rays:.0f} rays, naiveSK variable {ref['n_rays']:.0f}")
        np.testing.assert_allclose(img, ref["img"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{label} variable")
        rows[label] = dict(img=img, n_rays=n_rays, wall=wall,
                           passes=counts["passes"],
                           launches=counts["launches"], reads=counts["reads"])
        log(f"[11] {label:22s} variable 400^2 x 1 through the kernels: "
            f"{wall:8.4f} s wall (incl. image copy), {counts['passes']} "
            f"passes, {counts['launches']} launches, {counts['reads']} host "
            f"reads, {n_rays:.0f} rays (naiveSK variable's), "
            f"{n_rays / wall / 1e6:.4f} Mrays/s, image mean {img.mean():.6f};"
            f" card {card}")
    res = VARIABLE_EAGER_RES
    for label in VARIABLE_ROWS:
        k_img, k_rays, k_wall, k = render(label, res, False)
        e_img, e_rays, e_wall, e = render(label, res, True)
        check(e["launches"] == 0 and e["plain"] > 0,
              f"{label} variable: the eager render launched a kernel")
        check(k_rays == e_rays and k["passes"] == e["passes"],
              f"{label} variable at {res}^2: kernels {k_rays:.0f} rays in "
              f"{k['passes']} passes, eager {e_rays:.0f} in {e['passes']}")
        np.testing.assert_allclose(k_img, e_img, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{label} variable, eager")
        rows[label].update(eager_res=res, eager_wall=e_wall,
                           kernel_wall_at_eager_res=k_wall,
                           eager_reads=e["reads"])
        log(f"[11] {label:22s} variable {res}^2 x 1 kernels / eager: wall "
            f"{k_wall:.4f} / {e_wall:.4f} s ({e_wall / k_wall:.1f}x), host "
            f"reads {k['reads']} / {e['reads']}, {k_rays:.0f} rays both, max "
            f"|image - eager's| {float(np.abs(k_img - e_img).max()):.3g}; "
            f"card {card}")

    from cudavolumerenderer_tpu_torch.ops.camera import make_camera
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import (
        RenderSettings, make_medium, make_scene,
    )

    d = procedural.blob_volume()
    white = make_scene(make_medium(d, 1.0, scale=40.0, max_density=1.0,
                                   device="cuda"))
    furnace = RenderSettings.from_flags(True, bsdf_kind="null",
                                        boundary="variable")
    for label in VARIABLE_ROWS:
        img, _, _, counts = render(label, 64, False, white,
                                   make_camera(64, 64, device="cuda"),
                                   furnace)
        check(counts["launches"] > 0 and np.array_equal(
            img, np.ones_like(img)), f"{label} variable: white furnace not "
              f"exact through the kernels ({img.min()}..{img.max()})")
        log(f"[11] {label}: variable white furnace exact through the kernels "
            f"(64^2 x 1)")
    return {"rows": rows, "launches": launches}


def check_family(rows: dict) -> None:
    """Phase 11's checks: the integrator family gives naiveSK's estimate
    and ray count, fastQ (stochastic tap: another estimator) is within 2%."""
    rows = rows["rows"]
    ref = rows["naiveSK"]
    for label, row in rows.items():
        if label in FASTQ_LABELS:
            rel_mean = abs(row["img"].mean() - ref["img"].mean()) / ref["img"].mean()
            rel_rays = abs(row["n_rays"] - ref["n_rays"]) / ref["n_rays"]
            log(f"[11] {label} against naiveSK: mean {rel_mean:.3%}, n_rays "
                f"{rel_rays:.3%} apart")
            check(rel_mean < 0.02 and rel_rays < 0.02,
                  f"{label} is not within 2% of naiveSK")
            continue
        err = float(np.abs(row["img"] - ref["img"]).max())
        check(row["n_rays"] == ref["n_rays"],
              f"{label} traced {row['n_rays']:.0f} rays, naiveSK "
              f"{ref['n_rays']:.0f}")
        np.testing.assert_allclose(row["img"], ref["img"], rtol=1e-4,
                                   atol=1e-4, err_msg=label)
        log(f"[11] {label:22s} n_rays {row['n_rays']:.0f} == naiveSK's; max "
            f"|image - naiveSK's| {err:.3g}")


def family_furnace_and_small_renders() -> None:
    """Phase 11: the exact white furnace on the card through every row (the
    family's through the kernels), then every row's 16^2 render on the card
    against the same render on the CPU."""
    import torch

    from cudavolumerenderer_tpu_torch.ops.camera import make_camera
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import (
        RenderSettings, make_medium, make_scene,
    )

    d = procedural.blob_volume()

    def render(label, device, albedo, settings, res):
        _, kernel, fields, keywords = next(
            r for r in FAMILY_ROWS if r[0] == label)
        fn = row_kernel_fn(kernel, {"n_lanes": 4096, **fields}, keywords)
        scene = make_scene(make_medium(d, albedo, scale=40.0, max_density=1.0,
                                       device=device))
        img, n_rays = fn(scene, make_camera(res, res, device=device),
                         settings, (res, res), torch.zeros(2, device=device),
                         (res, res), 2, 9, 0)
        check(img.device.type == device, f"{label} left the {device}")
        return img.cpu().numpy() / 2, float(n_rays)

    furnace = RenderSettings.from_flags(True, bsdf_kind="null")
    for label, *_ in FAMILY_ROWS:
        img, n_rays = render(label, "cuda", 1.0, furnace, 64)
        check(np.array_equal(img, np.ones_like(img)),
              f"{label}: white furnace not exact on the card "
              f"(range {img.min()}..{img.max()})")
        log(f"[11] {label}: white furnace exact on the card (64^2 x 2, "
            f"{n_rays:.0f} rays)")

    albedo = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], -1)
    settings = RenderSettings.from_flags(True)
    for label, *_ in FAMILY_ROWS:
        (a, ra), (b, rb) = (render(label, dev, albedo, settings, 16)
                            for dev in ("cuda", "cpu"))
        share = float(np.mean(np.abs(a - b) < 1e-4))
        log(f"[11] {label:22s} 16^2 x 2 card vs CPU: means {a.mean():.5f} / "
            f"{b.mean():.5f}, rays {ra:.0f} / {rb:.0f}, pixels equal within "
            f"1e-4 {share:.3f}")
        check(np.isfinite(a).all() and abs(a.mean() - b.mean()) < 0.02
              and abs(ra - rb) <= 0.01 * rb,
              f"{label}: the card's render disagrees with the CPU's")


def fastq_config2(scene, camera, ref_img, ref_rays: float, card: str) -> dict:
    """Phase 28 (run right after phase 5, on its scene): fastQ two-level at
    BASELINE config 2's full width (512^2 x 4, one tile) through
    create_renderer(...).render() and csrc/fastqbody.cu: an untimed first
    render, then three timed with the image copy (the counts set to 0 just
    before each and read just after: body and drain launches, host reads,
    no eager iteration); the image mean within 2% of phase 5's fastSK
    render (both estimate the same image), and n_rays beside fastSK's.
    The eager body is not run here: at this size it takes ~2 min (5,505
    iterations, 692 host reads; NVIDIA H100 80GB HBM3, 700 W)."""
    import torch

    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.ops import fastqbody as fqb

    cfg = Config(kernel=Kernel.FAST_Q, two_level=True, resolution=(512, 512),
                 iterations=4, n_tiles=(1, 1))
    renderer = create_renderer(scene, camera, cfg)
    first = renderer.render()
    walls, runs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        fqb.KERNEL.reset()
        t0 = time.perf_counter()
        img = renderer.render()
        walls.append(time.perf_counter() - t0)
        runs.append(fastq_counts(fqb))
        check(runs[-1]["launches"] > 0 and runs[-1]["plain"] == 0,
              f"phase 28: fastQ ran {runs[-1]['plain']} eager iterations and "
              f"{runs[-1]['launches']} launches")
    n_rays, counts = renderer.n_rays, runs[0]
    check(img.shape == (512, 512, 3) and np.isfinite(img).all(),
          "phase 28: fastQ's config-2 image not finite or wrong shape")
    check(np.allclose(img, first, rtol=1e-5, atol=1e-5),
          "phase 28: two renders through the kernels differ beyond the "
          "flush's atomics")
    rel_mean = abs(float(img.mean()) - float(ref_img.mean())) / float(
        ref_img.mean())
    rel_rays = (n_rays - ref_rays) / ref_rays
    log(f"[28] fastQ two-level, config 2 (512^2 x 4, Config.n_lanes "
        f"{cfg.n_lanes}) through csrc/fastqbody.cu: walls "
        + ", ".join(f"{w:.4f}" for w in walls)
        + f" s (incl. image copy), {n_rays:.0f} rays, "
        f"{n_rays / min(walls) / 1e6:.4f} Mrays/s, {counts['passes']} "
        f"iterations, {counts['body']} body launches (gated), "
        f"{counts['drain']} drain launches, {counts['reads']} host reads; "
        f"against phase 5's fastSK: mean {rel_mean:.3%} apart, n_rays "
        f"{rel_rays:+.3%} ({ref_rays:.0f}); card {card}")
    check(rel_mean < 0.02, "phase 28: fastQ's config-2 image mean is not "
          "within 2% of fastSK's")
    return {"walls": walls, "n_rays": n_rays, "n_lanes": cfg.n_lanes,
            "rel_mean": rel_mean, "rel_rays": rel_rays, **counts}


def naive_cli(xml: str, tmp: str, card: str) -> None:
    """Phase 12: naiveSK through the CLI's batch mode (the drain)."""
    from cudavolumerenderer_tpu_torch import cli
    from cudavolumerenderer_tpu_torch.ops import familybody as fam
    from cudavolumerenderer_tpu_torch.utils.image import load_hdr

    argv = [xml, "-k", "naiveSK", "-i", "4", "-r", "400", "400", "--trials",
            "2", "-o", os.path.join(tmp, "naive_slice")]
    args = cli.build_parser().parse_args(argv)
    cfg = cli.config_from_args(args)
    fam.KERNEL.reset()
    t0 = time.perf_counter()
    result = cli.run_test(cfg, cli.device_of(args.platform))
    wall = time.perf_counter() - t0
    counts = family_counts(fam)
    check(counts["drain"] > 0 and counts["plain"] == 0,
          f"the CLI's naiveSK ran {counts['plain']} eager evaluations and "
          f"{counts['drain']} drain launches")
    saved = load_hdr(cfg.output_name + ".hdr")
    check(saved.shape == (400, 400, 3) and np.isfinite(saved).all(),
          "the CLI's naiveSK image is not finite or has the wrong shape")
    check(0.05 < saved.mean() < 1.5 and result["n_rays"] > 0,
          f"the CLI's naiveSK image mean {saved.mean()} implausible")
    log(f"[12] cli.run_test naiveSK 400^2 x 4, 2 trials: {wall:.2f} s in all; "
        f"mean time {result['mean_time']:.3f} s (image copy excluded), "
        f"{result['n_rays']:.0f} rays, {result['mrays_per_sec']:.4f} Mrays/s, "
        f"image mean {saved.mean():.5f}, {counts['drain']} drain launches, "
        f"{counts['reads']} host reads; card {card}")
    return counts["drain"]


def diff_case(device: str, bsdf: str, two_level: bool, rr: bool = False):
    """Phase 13's render_diff case on one device: (image, d density, d
    albedo) as numpy, from a random 16^3 density, a per-voxel albedo and
    an image cotangent made with numpy from one seed."""
    import torch

    from cudavolumerenderer_tpu_torch.models.differentiable import (
        CameraSpec, SceneSpec, render_diff,
    )
    from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

    rs = np.random.RandomState(0)
    n = DIFF_N
    density = (rs.rand(n, n, n) * 0.8).astype(np.float32)
    albedo = (0.3 + 0.6 * rs.rand(n, n, n, 4)).astype(np.float32)
    g_img = rs.rand(*DIFF_RES, 3).astype(np.float32)
    d = torch.tensor(density, device=device, requires_grad=True)
    a = torch.tensor(albedo, device=device, requires_grad=True)
    settings = RenderSettings.from_flags(
        True, russian_roulette=rr, max_path_length=16, bsdf_kind=bsdf)
    img = render_diff(d, a, DIFF_SEED, SceneSpec(scale=4.0),
                      CameraSpec(res_x=16, res_y=16, fov_x_deg=0.5), settings,
                      DIFF_RES, DIFF_SPP, two_level)
    img.backward(torch.tensor(g_img, device=device))
    return tuple(x.detach().cpu().numpy() for x in (img, d.grad, a.grad))


def grad_share(got, want) -> float:
    """Share of entries within rtol 1e-3, atol 1e-4 x max|want|."""
    return float(np.isclose(got, want, rtol=1e-3,
                            atol=1e-4 * np.abs(want).max()).mean())


def gradient_on_card() -> None:
    """Phase 13: render_diff's image and both cotangents on the card
    against the CPU, the pass-A elision bit for bit on the card, and a
    central finite difference of one albedo voxel."""
    import torch

    from cudavolumerenderer_tpu_torch.models import differentiable as td
    from cudavolumerenderer_tpu_torch.models.differentiable import (
        CameraSpec, SceneSpec, render_diff,
    )
    from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

    for bsdf in ("null", "ggx"):
        for two in (False, True):
            t0 = time.perf_counter()
            card_out = diff_case("cuda", bsdf, two)
            t_card = time.perf_counter() - t0
            (ci, cdd, cda), (pi, pdd, pda) = card_out, diff_case("cpu", bsdf, two)
            pixels = float(np.all(np.isclose(ci, pi, rtol=1e-4, atol=1e-4),
                                  axis=-1).mean())
            shares = (grad_share(cdd, pdd), grad_share(cda, pda))
            sums = [abs(c.sum() - p.sum()) / np.abs(p).sum()
                    for c, p in ((cdd, pdd), (cda, pda))]
            log(f"[13] render_diff {bsdf} two_level={two} 16^3, 16^2 x "
                f"{DIFF_SPP}: card {t_card:.2f} s fwd+bwd; card vs CPU pixels "
                f"within 1e-4 {pixels:.4f} (max |diff| {np.abs(ci - pi).max():.3g}"
                f"), voxels within tolerance density {shares[0]:.4f} albedo "
                f"{shares[1]:.4f}, sums apart {max(sums):.2e}")
            check(np.isfinite(ci).all() and np.isfinite(cdd).all()
                  and np.isfinite(cda).all(), "render_diff on the card: "
                  "not finite")
            # GGX: a path that leaves on another branch (the last bits of
            # CUDA's float32 math) carries ~1/1,024 of the image and sums
            sum_tol = 1e-3 if bsdf == "null" else 1e-2
            check(max(sums) <= sum_tol and min(shares) >= 0.99,
                  f"render_diff {bsdf} two_level={two}: the card's "
                  "cotangents disagree with the CPU's")
            if bsdf == "null":
                np.testing.assert_allclose(ci, pi, rtol=1e-4, atol=1e-4)
            else:
                check(pixels >= 0.9 and abs(ci.mean() - pi.mean())
                      <= sum_tol * pi.mean(), f"render_diff {bsdf} "
                      f"two_level={two}: the card's image disagrees")

    # the pass-A elision: the forward's saved radiance is pass A's, bit
    # for bit (GGX, RR on, the fused cascaded replay)
    rs = np.random.RandomState(1)
    density = torch.tensor((rs.rand(16, 16, 16) * 0.8).astype(np.float32),
                           device="cuda")
    albedo = torch.tensor((0.3 + 0.6 * rs.rand(16, 16, 16, 4))
                          .astype(np.float32), device="cuda")
    spec, cam_spec = SceneSpec(scale=4.0), CameraSpec(res_x=64, res_y=64,
                                                      fov_x_deg=0.5)
    settings = RenderSettings.from_flags(True, max_path_length=16)
    scene, cam = spec.build(density, albedo, "cuda"), cam_spec.build("cuda")
    _, saved = td._primal_2l(scene, cam, settings, (64, 64), 4, 9, density,
                             albedo)
    n, _, o0, d0, rng = td._lane_setup(cam, (64, 64), 4, 9)
    zeros = torch.zeros(n, device="cuda")
    pass_a = td._replay(scene, settings, o0, d0, rng, zeros,
                        torch.zeros(n, 3, device="cuda"), False, None, None,
                        td._build_brick_tab(density), min_width=1024)
    check(torch.equal(pass_a.radiance, saved),
          "pass A's radiance differs from the forward's saved radiance")
    log(f"[13] pass-A elision on the card: {n} lanes (64^2 x 4, GGX, RR on, "
        "pools down to 1,024), the saved radiance equals pass A's bit for bit")

    # central finite difference of one albedo voxel (RR off: the paths do
    # not depend on the albedo, so same-seed differences are exact)
    w = torch.tensor(rs.rand(16, 16, 3).astype(np.float32), device="cuda")
    settings = RenderSettings.from_flags(True, russian_roulette=False,
                                         max_path_length=16)

    def loss(a):
        return torch.sum(render_diff(density, a, 5, spec,
                                     CameraSpec(res_x=16, res_y=16,
                                                fov_x_deg=0.5),
                                     settings, (16, 16), 8, True) * w)

    a = albedo.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(a), a)
    per_voxel = g[..., :3].sum(-1)
    v = np.unravel_index(int(torch.argmax(per_voxel.abs())), per_voxel.shape)
    e = torch.zeros_like(albedo)
    e[v][:3] = 1.0
    h = 1e-2
    with torch.no_grad():
        fd = float(loss(albedo + h * e) - loss(albedo - h * e)) / (2 * h)
    analytic = float(per_voxel[v])
    log(f"[13] albedo voxel {tuple(int(i) for i in v)}: dL/da {analytic:.6g}, "
        f"central difference (h {h}) {fd:.6g}")
    check(abs(analytic - fd) <= 2e-2 * abs(fd) + 1e-3,
          "the albedo gradient disagrees with its finite difference")


def training(tmp: str, card: str) -> dict:
    """Phase 14: inverse_256.main at the recipe's full width with depth
    cut, the replay kernels' counts set to 0 just before it and read just
    after, its checks, and one forward+backward program at the finest
    level with its launches, host reads, wall and device time per pass.
    Returns the main path's counts and the program's rows."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks import inverse_256
    from cudavolumerenderer_tpu_torch.models import inverse
    from cudavolumerenderer_tpu_torch.models.differentiable import render_diff
    from cudavolumerenderer_tpu_torch.ops import replaybody as rb

    ck = os.path.join(tmp, "inv256_ckpt")
    log(f"[14] inverse_256 {' '.join(TRAIN_ARGV)}; cut in depth only: "
        + ", ".join(TRAIN_CUTS))
    k = rb.KERNEL
    torch.cuda.synchronize()
    k.launches = k.drain_launches = k.reads = k.plain_evals = 0
    t0 = time.perf_counter()
    result = inverse_256.main(list(TRAIN_ARGV) + ["--ckpt-dir", ck])
    wall = time.perf_counter() - t0
    main_path = {"launches": k.launches, "drain_launches": k.drain_launches,
                 "reads": k.reads, "plain_evals": k.plain_evals}
    check(main_path["launches"] > 0 and main_path["drain_launches"] > 0
          and main_path["plain_evals"] == 0,
          f"inverse_256 did not replay through the kernels: {main_path}")
    log(f"[14] main path: {main_path['launches']} replay-kernel launches, "
        f"{main_path['drain_launches']} drain launches, {main_path['reads']} "
        f"host reads, {main_path['plain_evals']} eager evaluations")
    losses = [l for level in result["losses"] for l in level]
    check(len(losses) == 2 and np.isfinite(losses).all(),
          f"the losses are not finite: {losses}")
    for lvl, steps in result["step_s"].items():
        if not steps:
            log(f"[14] {lvl}: no step (the coarser grid upsampled through)")
            continue
        log(f"[14] {lvl}: {len(steps)} steps, seconds per step "
            f"{', '.join(f'{s:.3f}' for s in steps)}; seconds per fwd+bwd "
            f"program {', '.join(f'{s:.3f}' for s in result['program_s'][lvl])}"
            f"; replay iterations primal {result['primal_iters'][lvl]}, pass B "
            f"{result['pass_b_iters'][lvl]}; card {card}")
    log(f"[14] {wall:.1f} s in all (targets {result['target_render_s']} s), "
        f"peak allocated {result['max_memory_allocated'] / 2**20:.0f} MiB, "
        f"grid_mse_ratio {result['grid_mse_ratio']}")

    # the density moved at each level that took a step and stays in
    # clip_density; the step-less level holds the upsampled coarse grid;
    # the last checkpoint reloads with its Adam moments
    n = int(TRAIN_ARGV[1])
    lo, hi = inverse.InverseConfig().clip_density

    def upsampled(d, size):
        return torch.clamp(inverse.upsample_density(
            torch.tensor(d, device="cuda"), (size,) * 3), lo, hi).cpu().numpy()

    d64 = inverse.load_checkpoint(os.path.join(ck, f"L{n // 4}"), 1)[0]
    d128 = inverse.load_checkpoint(os.path.join(ck, f"L{n // 2}"), 0)[0]
    tpl = inverse.adam_init([torch.zeros((n, n, n), device="cuda")])
    d256, _, step, opt = inverse.load_checkpoint(os.path.join(ck, f"L{n}"), 1,
                                                 opt_state_like=tpl)
    check(np.array_equal(d128, upsampled(d64, n // 2)),
          "the step-less level does not hold the upsampled coarse grid")
    moved = (np.abs(d64 - 0.25).max(), np.abs(d256 - upsampled(d128, n)).max())
    check(d256.shape == (n,) * 3 and np.isfinite(d256).all()
          and lo <= d256.min() and d256.max() <= hi,
          "the final density is not finite or leaves clip_density")
    check(min(moved) > 0.0, f"the density did not move: {moved}")
    check(step == 1 and opt is not None and opt.count == 1
          and all(torch.isfinite(m).all() for m in opt.mu + opt.nu)
          and float(opt.nu[0].min()) >= 0.0 and float(opt.mu[0].abs().max()) > 0,
          "the last checkpoint's Adam moments did not reload")
    log(f"[14] density moved (max |change| {moved[0]:.4f} at {n // 4}^3, "
        f"{moved[1]:.4f} at {n}^3 over its level), within [{lo}, {hi}]; "
        f"L{n}/step_1 reloads with Adam count {opt.count}")

    # one forward+backward program at 256^3 through the replay kernel, run
    # twice: per pass its launches, host reads and wall, then its device
    # time and kernels under torch.profiler
    res = int(TRAIN_ARGV[3])
    spec = inverse_256.SceneSpec(scale=12.0, max_density=1.0)
    settings = inverse_256.RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=64)
    view = inverse.orbit_camera_specs(2, radius=100.0, res=(res, res),
                                      fov_x_deg=0.8)[0]
    target = torch.tensor(np.load(next(
        os.path.join(ck, f) for f in os.listdir(ck)
        if f.startswith("targets")))["targets"][0], device="cuda")
    albedo = torch.full((1, 1, 1, 4), 0.6, device="cuda")
    spp = int(TRAIN_ARGV[5]) // int(TRAIN_ARGV[7])
    k = rb.KERNEL
    rows = {}
    for profiled in (False, True):
        stats = {}
        d = torch.tensor(d256, device="cuda", requires_grad=True)
        passes = {}

        def primal():
            return render_diff(d, albedo, 12345, spec, view, settings,
                               (res, res), spp, True, stats=stats)

        def pass_b():
            torch.mean((img / spp - target) ** 2).backward()

        for name, fn in (("primal", primal), ("pass B", pass_b)):
            torch.cuda.synchronize()
            before = (k.launches, k.drain_launches, k.reads, k.plain_evals)
            t0 = time.perf_counter()
            if profiled:
                out, kernels, busy = device_time(fn)
            else:
                out, kernels, busy = fn(), None, None
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if name == "primal":
                img = out
            after = (k.launches, k.drain_launches, k.reads, k.plain_evals)
            counts = [x - y for x, y in zip(after, before)]
            passes[name] = {"wall_ms": wall, "launches": counts[0],
                            "drain_launches": counts[1], "reads": counts[2],
                            "plain_evals": counts[3], "device_ms": busy,
                            "device_kernels": kernels}
        primal_n, pass_b_n = stats["primal_iters"][0], stats["pass_b_iters"][0]
        check(pass_b_n == primal_n, f"pass B took {pass_b_n} evaluations, the "
              f"primal {primal_n}")
        for name, row in passes.items():
            check(row["launches"] > 0 and row["drain_launches"] > 0
                  and row["plain_evals"] == 0,
                  f"the {name} replay did not run through the kernels: {row}")
        rows["profiled" if profiled else "timed"] = passes
    timed, prof = rows["timed"], rows["profiled"]
    for name in ("primal", "pass B"):
        t, p = timed[name], prof[name]
        log(f"[14] {name} replay at {n}^3, {res}^2 x {spp} (65,536 lanes, "
            f"{primal_n} evaluations): {t['wall_ms']:.2f} ms wall with the "
            f"card synchronised, {t['launches']} replay-kernel launches "
            f"(gated) + {t['drain_launches']} drain, {t['reads']} host reads, "
            f"no eager evaluation; under torch.profiler {p['wall_ms']:.2f} ms "
            f"wall, device " + (f"{p['device_ms']:.3f} ms in "
                                f"{p['device_kernels']} kernels "
                                f"({p['device_ms'] / p['wall_ms']:.1%} busy)"
                                if p["device_ms"] else "time not in the trace")
            + f"; card {card}")
    return {"passes": rows, "evaluations": primal_n, "main_path": main_path,
            "step_s": result["step_s"]}


def native_and_vdb(tmp: str, card: str) -> str:
    """Phase 15: the native library (built in phase 2) and the VDB and
    NPZ round trips on the card's host; returns config 3's .vdb path."""
    from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc
    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.scene import vdb
    from cudavolumerenderer_tpu_torch.utils import native

    log(f"[15] native library {os.path.relpath(native.library_path())}: g++ "
        f"{native.build_seconds:.2f} s (0.00 = reused)")
    d, alb = bc.smoke_and_albedo()
    nz = np.nonzero(d)
    box = tuple(slice(a.min(), a.max() + 1) for a in nz)  # (z, y, x)
    checks = {}
    t0 = time.perf_counter()
    path = os.path.join(tmp, "hetvol_synth.vdb")
    vdb.write_vdb(path, d, alb)
    checks["vdb"] = (path, vdb.load_vdb_scene(path, device="cuda")[0],
                     d[box], alb[box], time.perf_counter() - t0)
    t0 = time.perf_counter()
    npz = os.path.join(tmp, "hetvol_synth.npz")
    vdb.save_npz(npz, d, alb)
    checks["npz"] = (npz, vdb.load_npz_scene(npz, device="cuda")[0], d, alb,
                     time.perf_counter() - t0)
    for kind, (file, scene, want_d, want_a, secs) in checks.items():
        med = scene.medium
        got_d = med.density.data.cpu().numpy()
        got_a = med.albedo.data.cpu().numpy()
        check(scene.device.type == "cuda", f"{kind} scene not on the card")
        check(np.array_equal(got_d, want_d),
              f"{kind}: density differs from the source on the active box")
        check(np.array_equal(got_a[..., :3], want_a),
              f"{kind}: albedo differs from the source on the active box")
        log(f"[15] {kind} round trip: {os.path.getsize(file)} bytes, written "
            f"and loaded in {secs:.2f} s, density {got_d.shape} and albedo "
            f"equal to the source on the active box; scale "
            f"{float(med.scale):.0f}, albedo mode {fast._albedo_mode(scene)}")
    return path


def config3(vdb_path: str, tmp: str, card: str) -> int:
    """Phase 16: BASELINE config 3 at its published size, through the
    port's baseline_configs driver and then the CLI's batch mode with the
    tail kernel, whose stage runs as the drain; returns the drain's
    launches in the second run."""
    import torch

    from cudavolumerenderer_tpu_torch import cli
    from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc
    from cudavolumerenderer_tpu_torch.ops import taildrain as td
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk
    from cudavolumerenderer_tpu_torch.utils.image import load_hdr

    out = os.path.join(tmp, "config3.json")
    t0 = time.perf_counter()
    bc.main(["--only", "3_", "--trials", "1", "--out", out, "--workdir", tmp])
    wall = time.perf_counter() - t0
    with open(out) as f:
        row = json.load(f)["3_hetvol_vdb_1024"]
    saved = load_hdr(os.path.join(tmp, "3_hetvol_vdb_1024.hdr"))
    check(saved.shape == (1024, 1024, 3) and np.isfinite(saved).all(),
          "config 3's image is not finite or has the wrong shape")
    check(0.05 < saved.mean() < 1.5, f"config 3 image mean {saved.mean()}")
    log(f"[16] baseline_configs config 3, 1024^2 x 4, 1 trial: {wall:.2f} s in "
        f"all; per trial {row['mean_time_with_copy_s']:.3f} s wall with the "
        f"image copy ({row['mean_time_s']:.3f} without), {row['n_rays']:.0f} "
        f"rays, {row['n_rays'] / row['mean_time_with_copy_s'] / 1e6:.4f} "
        f"Mrays/s with the copy ({row['mrays_per_sec']:.3f} without), image "
        f"mean {saved.mean():.5f}; card {card}")

    argv = [vdb_path, "-k", "fastSK", "--two-level", "--tail-pallas", "-i",
            "4", "-r", "1024", "1024", "-o", os.path.join(tmp, "config3_tail")]
    args = cli.build_parser().parse_args(argv)
    cfg = cli.config_from_args(args)
    torch.cuda.synchronize()
    tpk.KERNEL.launches = 0
    td.KERNEL.reset()
    result = cli.run_test(cfg, cli.device_of(args.platform))
    launches, reads = td.KERNEL.drain_launches, td.KERNEL.reads
    saved = load_hdr(cfg.output_name + ".hdr")
    check(launches > 0, "config 3 with --tail-pallas launched no drain")
    check(tpk.KERNEL.launches == 0, "config 3's drain render launched the "
          "tail kernel")
    check(saved.shape == (1024, 1024, 3) and np.isfinite(saved).all(),
          "config 3's tail-kernel image is not finite or has the wrong shape")
    check(abs(result["n_rays"] - row["n_rays"]) <= 0.02 * row["n_rays"],
          "the tail kernel changed config 3's ray count by more than 2%")
    log(f"[16] cli.run_test config 3 --tail-pallas, 1024^2 x 4: "
        f"{result['mean_time_with_copy']:.3f} s wall with the image copy "
        f"({result['mean_time']:.3f} without), {result['n_rays']:.0f} rays, "
        f"{result['n_rays'] / result['mean_time_with_copy'] / 1e6:.4f} "
        f"Mrays/s with the copy, {launches} drain launches and {reads} host "
        f"reads of the tail stage in the run's trials, image mean "
        f"{saved.mean():.5f}; card {card}")
    return launches


def config1(tmp: str, card: str) -> dict:
    """Phase 16: BASELINE config 1 at its published size (256^2 x 20, one
    tile, the RAW scene with its transfer-function albedo, so the 'full'
    table, fastSK two-level) through the port's baseline_configs driver,
    three trials, through the body kernel.  Returns its JSON row."""
    from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc
    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.ops import fastbody as fb
    from cudavolumerenderer_tpu_torch.scene.raw_builder import load_raw_scene
    from cudavolumerenderer_tpu_torch.utils.image import load_hdr

    name = "1_bucky_raw_256_20it"
    out = os.path.join(tmp, "config1.json")
    before = fb.KERNEL.launches, fb.KERNEL.drain_launches
    t0 = time.perf_counter()
    bc.main(["--only", "1_", "--trials", "3", "--out", out, "--workdir", tmp])
    wall = time.perf_counter() - t0
    launches = fb.KERNEL.launches - before[0]
    drains = fb.KERNEL.drain_launches - before[1]
    with open(out) as f:
        row = json.load(f)[name]
    saved = load_hdr(os.path.join(tmp, f"{name}.hdr"))
    scene, _ = load_raw_scene(os.path.join(tmp, "bucky_synth.raw"),
                              device="cuda")
    mode = fast._albedo_mode(scene)
    check(mode == "full", f"config 1's albedo is {mode!r}, not 'full'")
    check(launches > 0 and drains > 0, "config 1 launched no body kernel")
    check(saved.shape == (256, 256, 3) and np.isfinite(saved).all(),
          "config 1's image is not finite or has the wrong shape")
    check(row["iterations"] == 20 and row["n_rays"] > 0,
          f"config 1 rendered {row['iterations']} iterations, "
          f"{row['n_rays']} rays")
    log(f"[16] baseline_configs config 1, 256^2 x 20 ('full' albedo table), "
        f"3 trials: {wall:.2f} s in all; per trial "
        f"{row['mean_time_with_copy_s']:.3f} s wall with the image copy "
        f"({row['mean_time_s']:.3f} without), {row['n_rays']:.0f} rays, "
        f"{row['n_rays'] / row['mean_time_with_copy_s'] / 1e6:.4f} Mrays/s "
        f"with the copy ({row['mrays_per_sec']:.3f} without), "
        f"{launches} body-kernel and {drains} drain launches in all, image mean "
        f"{saved.mean():.5f}; card {card}")
    return row


class CascadeCounter:
    """Counts fast.render_tile calls (one cascade each) and their body
    evaluations (each stage's lane-rows over its pool width) while it is
    entered; the renderer looks render_tile up at each call."""

    def __enter__(self):
        from cudavolumerenderer_tpu_torch.models import fast

        self.fast, self.orig = fast, fast.render_tile
        self.calls = []
        self.images = []  # each call's image, the sum over its samples
        self.stages = []  # each call's body evaluations per stage
        self.table_bits = []  # each call's table precision
        self.stats = []  # each call's with_stats tuple

        def counted(*args, **kw):
            stats = self.orig(*args, with_stats=True, **kw)
            self.stats.append(stats)
            img, n_rays, _, _, rows = stats
            offsets = args[4]
            n_lanes = args[3][0] * args[3][1] * (
                offsets.shape[0] if offsets.ndim == 2 else 1)
            widths = fast._cascade_widths(
                n_lanes, kw.get("cascade_factor", fast._CASCADE_FACTOR),
                kw.get("min_width") or fast._MIN_WIDTH)
            stages = [float(r) / w for r, w in zip(rows.tolist(), widths)]
            self.calls.append((tuple(offsets.shape), sum(stages)))
            self.stages.append(stages)
            self.images.append(img)
            self.table_bits.append(kw.get("table_bits", 32))
            return img, n_rays

        fast.render_tile = counted
        return self

    def __exit__(self, *exc):
        self.fast.render_tile = self.orig


def sequential_render(renderer):
    """The renderer's tile loop, one tile after another (run_iterations),
    and its image copied to the host."""
    renderer.init_rendering()
    while not renderer.image_complete():
        renderer.run_iterations(spp=renderer.config.iterations)
    return renderer.get_image()


def config4(tmp: str, card: str, iters: int = CONFIG4_ITERS):
    """Phase 17: BASELINE config 4 at its published width (400^2, 10x10
    tiles of 40x40), iterations cut from 50 to `iters`; then multi-tile
    mode against the sequential tile loop at 2x2 tiles.  Returns the
    timed render's image and n_rays."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc
    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene

    xml = bc.write_mitsuba_xml(tmp)
    cfg = Config(scene_file=xml, kernel=Kernel.FAST_SK, two_level=True,
                 iterations=iters, resolution=(400, 400), n_tiles=(10, 10))
    scene, camera = load_scene(cfg, device="cuda")
    renderer = create_renderer(scene, camera, cfg)
    torch.cuda.synchronize()
    with CascadeCounter() as cascades:
        t0 = time.perf_counter()
        img = renderer.render()
        wall = time.perf_counter() - t0
    n_rays = renderer.n_rays
    check(img.shape == (400, 400, 3) and np.isfinite(img).all(),
          "config 4 image not finite or wrong shape")
    check(0.05 < img.mean() < 1.5, f"config 4 image mean {img.mean()}")
    check([shape for shape, _ in cascades.calls] == [(100, 2)],
          f"config 4 ran {len(cascades.calls)} cascades, not one "
          "over all 100 tiles")
    log(f"[17] config 4, 400^2 x {iters} in 10x10 tiles of 40x40: "
        f"{wall:.3f} s wall (incl. image copy), {n_rays:.0f} rays, "
        f"{n_rays / wall / 1e6:.4f} Mrays/s, one cascade over 100 tiles, "
        f"{cascades.calls[0][1]:.0f} body evaluations, image mean "
        f"{img.mean():.5f}; card {card}")

    small = Config(scene_file=xml, kernel=Kernel.FAST_SK, two_level=True,
                   iterations=1, resolution=(80, 80), n_tiles=(2, 2))
    scene, camera = load_scene(small, device="cuda")
    multi = create_renderer(scene, camera, small)
    with CascadeCounter() as cascades:
        t0 = time.perf_counter()
        multi_img = multi.render()
        multi_wall = time.perf_counter() - t0
    seq = create_renderer(scene, camera, small)
    with CascadeCounter() as seq_cascades:
        t0 = time.perf_counter()
        seq_img = sequential_render(seq)
        seq_wall = time.perf_counter() - t0
    check(len(cascades.calls) == 1 and len(seq_cascades.calls) == 4,
          "multi mode did not render the 2x2 tiles in one cascade")
    check(np.array_equal(multi_img, seq_img) and multi.n_rays == seq.n_rays,
          "multi-tile mode differs from the sequential tile loop on the card")
    log(f"[17] multi-tile mode at 2x2 tiles of 40x40, 1 iteration: image and "
        f"n_rays ({multi.n_rays:.0f}) bit-equal to the sequential loop; "
        f"{multi_wall:.3f} s and {cascades.calls[0][1]:.0f} body evaluations "
        f"in one cascade against {seq_wall:.3f} s and "
        f"{sum(e for _, e in seq_cascades.calls):.0f} in four; card {card}")
    return img, n_rays


def config4_sequential(tmp: str, card: str, want, iters: int = CONFIG4_ITERS):
    """Config 4 through the sequential tile loop (100 cascades), timed once,
    against phase 17's multi-tile render `want` = (image, n_rays): bit
    for bit.  Not in main (~100x the multi-tile time); run it alone."""
    from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc
    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene

    cfg = Config(scene_file=bc.write_mitsuba_xml(tmp), kernel=Kernel.FAST_SK,
                 two_level=True, iterations=iters, resolution=(400, 400),
                 n_tiles=(10, 10))
    scene, camera = load_scene(cfg, device="cuda")
    renderer = create_renderer(scene, camera, cfg)
    with CascadeCounter() as cascades:
        t0 = time.perf_counter()
        img = sequential_render(renderer)
        wall = time.perf_counter() - t0
    check(len(cascades.calls) == 100, f"{len(cascades.calls)} cascades")
    check(np.array_equal(img, want[0]) and renderer.n_rays == want[1],
          "config 4's sequential loop differs from multi-tile mode")
    log(f"[17] config 4 sequential loop, 400^2 x {iters}: {wall:.3f} s wall "
        f"(incl. image copy), 100 cascades, "
        f"{sum(e for _, e in cascades.calls):.0f} body evaluations, image and "
        f"n_rays ({renderer.n_rays:.0f}) bit-equal to multi-tile mode; "
        f"card {card}")


def interactive_modes(tmp: str, card: str) -> None:
    """Phase 18: the CLI's interactive modes at 64^2 on config 4's scene."""
    import contextlib
    import io

    from cudavolumerenderer_tpu_torch import cli
    from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc

    xml = bc.write_mitsuba_xml(tmp)
    base = [xml, "--interactive", "1", "-i", "2", "-r", "64", "64",
            "--two-level"]
    script = os.path.join(tmp, "path.txt")
    with open(script, "w") as f:
        f.write("render 1\nrotate 30 10\nrender 1\n")
    modes = (
        ("orbit", ["--orbit", "2"], ("_orbit0000.png", "_orbit0001.png")),
        ("camera path", ["--camera-path", script],
         ("_path0001.png", "_path0002.png")),
        ("progressive", [], ("_frame0001.png", ".hdr")),
    )
    for label, extra, files in modes:
        out = os.path.join(tmp, label.replace(" ", "_"))
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(base + extra + ["-o", out])
        wall = time.perf_counter() - t0
        text = printed.getvalue()
        sys.stdout.write(text)
        check(rc == 0, f"--interactive {label} returned {rc}")
        for suffix in files:
            check(os.path.getsize(out + suffix) > 0,
                  f"--interactive {label} wrote no {out + suffix}")
        if label == "camera path":
            check(text.count("accumulation reset") == 1,
                  "the camera path's rotate did not reset the accumulation")
        log(f"[18] --interactive {label} at 64^2: {wall:.2f} s, wrote "
            f"{', '.join(os.path.basename(out) + s for s in files)}; card {card}")


def representable_on_card() -> None:
    """Phase 19's exactness check: a density on the 255-level grid (k/256
    with max_density 255/256, tests/test_fast.py's packed-table scene)
    renders bit-identically with table_bits 8 and 32 on the card, one-
    and two-level."""
    import torch

    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.ops.camera import make_camera
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene import types

    d = np.round(procedural.medical_volume((16, 16, 16), n_blobs=4) * 255) / 256
    alb = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], axis=-1)
    scene = types.make_scene(types.make_medium(
        d.astype(np.float32), alb, scale=20.0, max_density=255.0 / 256.0,
        device="cuda"))
    camera = make_camera(16, 16, device="cuda")
    settings = types.RenderSettings.from_flags(True)
    for two_level in (False, True):
        a, b = (fast.render_tile(
            scene, camera, settings, (16, 16), torch.zeros(2, device="cuda"),
            (16, 16), 4, 7, 0, two_level=two_level, table_bits=bits)
            for bits in (32, 8))
        check(torch.equal(a[0], b[0]) and float(a[1]) == float(b[1]),
              f"table_bits 8 differs from 32 on a representable grid "
              f"(two_level={two_level})")
    log("[19] a density on the 255-level grid renders bit-identically with "
        "table_bits 8 and 32 on the card, one- and two-level")


def config2_row(bc, name: str, label: str, extra, tmp: str, card: str):
    """One phase 19 row: config 2 through baseline_configs.main with the
    flags `extra`, one trial.  Returns (its JSON row, the image mean, and
    for the f32 row option_render's dict of the render, with the device
    kernels per evaluation over the whole render)."""
    from cudavolumerenderer_tpu_torch.utils.image import load_hdr

    out = os.path.join(tmp, "config2.json")
    t0 = time.perf_counter()
    # the f32 row (defer_ggx 0) also counts its kernels per evaluation
    prof = contextlib.nullcontext() if extra else RenderWindow()
    with CascadeCounter() as cascades, prof:
        bc.main([*extra, "--only", "2_", "--trials", "1", "--out", out,
                 "--workdir", tmp])
    wall = time.perf_counter() - t0
    with open(out) as f:
        row = json.load(f)[name]
    img = load_hdr(os.path.join(tmp, f"{name}.hdr"))
    bits = 4 if extra else 32
    check(cascades.table_bits == [bits],
          f"config 2 {label} rendered with table_bits {cascades.table_bits}")
    check(row["precision"] == ("q4-reduced" if extra else "f32"),
          f"config 2 {label} labelled {row['precision']}")
    check(row["iterations"] == CONFIG2_ITERS,
          f"config 2 {label} rendered {row['iterations']} iterations")
    check(img.shape == (512, 512, 3) and np.isfinite(img).all(),
          f"config 2 {label}: image not finite or of the wrong shape")
    check(row["n_rays"] > 0, f"config 2 {label} traced no rays")
    inline = None
    if not extra:
        prof.per_evaluation(cascades.calls[0][1])
        inline = {"img": cascades.images[0], "n_rays": row["n_rays"],
                  "evals": cascades.calls[0][1], "kernels": prof.kernels}
        log_window("f32 (defer_ggx 0)", prof, card)
    log(f"[19] baseline_configs config 2 {label}, 512^2 x {CONFIG2_ITERS}, "
        f"1 trial: {wall:.2f} s in all (scene file written and loaded); the "
        f"render {row['mean_time_with_copy_s']:.3f} s wall with the image "
        f"copy ({row['mean_time_s']:.3f} without), {row['n_rays']:.0f} rays, "
        f"{row['n_rays'] / row['mean_time_with_copy_s'] / 1e6:.4f} Mrays/s "
        f"with the copy, {cascades.calls[0][1]:.0f} body evaluations, "
        f"image mean {img.mean():.5f}; card {card}")
    return row, float(img.mean()), inline


def champion_config2(tmp: str, card: str) -> dict:
    """Phase 19: the exactness check on the card (16^2 renders, which also
    warm the packed path up), then BASELINE config 2 with --champion (q4
    packed tables, min_width 64, 512 bricks, cascade factor 1.25) at its
    published width, CONFIG2_ITERS iterations, through the port's
    baseline_configs driver, then the f32 row in the same call.  The f32
    row is config 2 at defer_ggx 0, so it also counts the device kernels
    per evaluation over its whole render and is returned as phase 20's
    first row (option_render's dict)."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc
    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.scene.mhd import load_mhd_scene

    name = "2_medical_mhd_512"
    t0 = time.perf_counter()
    representable_on_card()  # the packed path's first renders: the warm-up
    log(f"[19] warm-up and exactness check took "
        f"{time.perf_counter() - t0:.1f} s")
    published = bc.rows  # config 2 cut to CONFIG2_ITERS iterations here
    bc.rows = lambda quick: [
        r[:4] + (CONFIG2_ITERS,) + r[5:] if r[0] == name else r
        for r in published(quick)]
    try:
        (q4, q4_mean, _), (f32, f32_mean, inline) = (
            config2_row(bc, name, label, extra, tmp, card)
            for label, extra in (("q4 --champion", ["--champion"]),
                                 ("f32", [])))
    finally:
        bc.rows = published
    check(abs(q4_mean - f32_mean) <= 0.05 * f32_mean,
          f"q4 image mean {q4_mean} against f32 {f32_mean}")
    scene, _ = load_mhd_scene(os.path.join(tmp, "medical_synth.mhd"),
                              device="cuda")
    med = scene.medium
    words = fast.pack_density(med.density.data.reshape(-1), med.max_density, 4)
    log(f"[19] density tables: f32 {med.density.data.numel() * 4} B, q4 "
        f"{words.numel() * 4} B; rays q4 {q4['n_rays']:.0f} against f32 "
        f"{f32['n_rays']:.0f}, image means {q4_mean:.5f} / {f32_mean:.5f}")
    del scene, words
    torch.cuda.empty_cache()
    return inline


class RenderWindow:
    """torch.profiler over the one fast.render_tile call made while it is
    entered (a render through the body kernels, whose evaluations make no
    Python call each): after `per_evaluation(evals)`, kernels is the device
    kernels per evaluation (None when the trace holds no device time),
    busy_us and window_us the device's busy time and the call's wall."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from cudavolumerenderer_tpu_torch.models import fast

        self.fast, self.orig = fast, fast.render_tile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.calls, self.kernels = 0, None

        def windowed(*args, **kw):
            self.calls += 1
            check(self.calls == 1, "RenderWindow profiles one render_tile call")
            torch.cuda.synchronize()
            self.prof.start()
            t0 = time.perf_counter()
            try:
                return self.orig(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.window_us = (time.perf_counter() - t0) * 1e6
                self.prof.stop()

        fast.render_tile = windowed
        return self

    def __exit__(self, *exc):
        from torch.autograd import DeviceType

        self.fast.render_tile = self.orig
        if exc[0] is not None:
            return
        # the trace is read here, after the caller's timed render
        on_card = [e for e in self.prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        self.busy_us = sum(e.self_device_time_total for e in on_card)
        self.n_kernels = sum(e.count for e in on_card)

    def per_evaluation(self, evals: float) -> None:
        self.kernels = self.n_kernels / evals if self.busy_us else None


def log_window(tag: str, prof, card: str) -> None:
    if prof.kernels is None:
        log(f"[20] {tag}: no device time in the profiler's trace; kernels "
            "per evaluation not measured")
        return
    log(f"[20] {tag}: the whole render under torch.profiler: "
        f"{prof.kernels:.3f} device kernels per evaluation, "
        f"{prof.window_us / 1e3:.2f} ms of wall, device busy "
        f"{prof.busy_us / 1e3:.3f} ms "
        f"({prof.busy_us / prof.window_us:.1%}); card {card}")


def option_render(scene, camera, fields: dict, tag: str, card: str,
                  window: bool = False, eager: bool = False, res: int = 512,
                  iters: int = CONFIG2_ITERS) -> dict:
    """One res^2 x iters fastSK two-level render of config 2's scene (512^2
    x CONFIG2_ITERS unless told) through create_renderer(...).render() with
    Config `fields`
    (with eager, render_tile's eager body: eager_body=True); prints its
    wall (image copy included), rays, body evaluations per stage, the body
    kernels' launches and host reads (their counts set to 0 just before
    the render and read just after) and, with window, the device kernels
    per evaluation.  Returns render_tile's image (the sum over samples,
    on the card), the renderer's image, n_rays, n_rows, evaluations,
    kernels per evaluation, the wall and the counts."""
    import functools

    import torch

    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.ops import fastbody as fb

    cfg = Config(kernel=Kernel.FAST_SK, two_level=True, resolution=(res, res),
                 iterations=iters, n_tiles=(1, 1), **fields)
    renderer = create_renderer(scene, camera, cfg)
    torch.cuda.synchronize()
    prof = RenderWindow() if window else contextlib.nullcontext()
    k = fb.KERNEL
    k.launches = k.drain_launches = k.reads = 0
    k.by_mode = dict.fromkeys(fb.MODES, 0)
    real = fast.render_tile
    if eager:
        fast.render_tile = functools.partial(real, eager_body=True)
    try:
        with CascadeCounter() as cascades, prof:
            t0 = time.perf_counter()
            host = renderer.render()
            wall = time.perf_counter() - t0
    finally:
        fast.render_tile = real
    counts = {"launches": k.launches, "drains": k.drain_launches,
              "reads": k.reads, "by_mode": dict(k.by_mode)}
    n_rays = renderer.n_rays
    check(len(cascades.calls) == 1, f"{tag}: {len(cascades.calls)} cascades")
    check(host.shape == (res, res, 3) and np.isfinite(host).all(),
          f"{tag}: image not finite or of the wrong shape")
    check(n_rays > 0, f"{tag}: no rays traced")
    evals = cascades.calls[0][1]
    if isinstance(prof, RenderWindow):
        prof.per_evaluation(evals)
    stages = " / ".join(f"{e:.0f}" for e in cascades.stages[0])
    log(f"[20] {tag} at {res}^2 x {iters}"
        f"{' (eager body)' if eager else ''}: "
        f"{wall:.3f} s wall (incl. image copy), {n_rays:.0f} "
        f"rays, {evals:.0f} body evaluations ({stages} per stage), body "
        f"kernels {counts['launches']} launches + {counts['drains']} drain "
        f"launches ({counts['by_mode']} by mode), {counts['reads']} host "
        f"reads, image mean {float(host.mean()):.5f}; card {card}")
    if window:
        log_window(tag, prof, card)
    return {"img": cascades.images[0], "host": host, "n_rays": n_rays,
            "n_rows": float(cascades.stats[0][2]), "evals": evals,
            "kernels": prof.kernels if window else None, "wall": wall,
            **counts}


def tail_furnace_on_card() -> None:
    """Phase 20: tests/test_fast.py:51-70's tail configurations give the
    white furnace exactly on the card (unit albedo, null boundary)."""
    import torch

    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.ops.camera import make_camera
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import (
        RenderSettings, make_medium, make_scene,
    )

    scene = make_scene(make_medium(procedural.blob_volume(), 1.0, scale=40.0,
                                   max_density=1.0, device="cuda"))
    settings = RenderSettings.from_flags(True, bsdf_kind="null")
    for kw in FURNACE_TAILS:
        img, _ = fast.render_tile(
            scene, make_camera(16, 16, device="cuda"), settings, (16, 16),
            torch.zeros(2, device="cuda"), (16, 16), 4, 3, 0, two_level=True,
            **kw)
        img = img.cpu().numpy() / 4
        check(np.array_equal(img, np.ones_like(img)),
              f"white furnace {kw}: max |img - 1| {np.abs(img - 1).max()}")
    log(f"[20] white furnace exact on the card (16^2 x 4) for "
        f"{len(FURNACE_TAILS)} tail configurations")


def per_voxel_albedo_scene(n: int, seed: int):
    """A random density and a per-voxel random albedo (not affine in
    density) of side n, made on the card from a seeded generator."""
    import torch

    from cudavolumerenderer_tpu_torch.scene.types import make_medium, make_scene

    gen = torch.Generator("cuda")
    gen.manual_seed(seed)
    density = torch.empty((n, n, n), device="cuda")
    albedo = torch.empty((n, n, n, 4), device="cuda")
    step = max(1, (1 << 28) // (n * n * 4))  # slabs of at most 2^28 values
    for z in range(0, n, step):
        density[z:z + step] = torch.rand(density[z:z + step].shape,
                                         generator=gen, device="cuda")
        albedo[z:z + step] = torch.rand(albedo[z:z + step].shape,
                                        generator=gen, device="cuda")
    albedo[..., 3] = 1.0
    return make_scene(make_medium(density, albedo, scale=20.0,
                                  max_density=1.0, device="cuda"))


def split_on_card(card: str) -> None:
    """Phase 20: 'split' bit-equal to 'full' at 64^3 under a budget cut to
    40 bytes per voxel, then at the side where plan_albedo_table picks
    'split' on this card."""
    import torch

    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.ops.camera import make_camera
    from cudavolumerenderer_tpu_torch.utils import occupancy

    def render(scene, res, spp):
        cfg = Config(kernel=Kernel.FAST_SK, two_level=True,
                     resolution=(res, res), iterations=spp, n_tiles=(1, 1))
        renderer = create_renderer(scene, make_camera(res, res, device="cuda"),
                                   cfg)
        return renderer.render(), renderer.n_rays

    small = per_voxel_albedo_scene(64, 21)
    check(fast._albedo_mode(small, allow_split=True) == "full",
          "the 64^3 per-voxel albedo is not planned 'full'")
    full, full_rays = render(small, 64, 4)
    budget = occupancy.device_memory_budget
    occupancy.device_memory_budget = lambda device=None: 40 * 64 ** 3
    try:
        check(fast._albedo_mode(small, allow_split=True) == "split",
              "a budget of 40 B per voxel does not plan 'split'")
        split, split_rays = render(small, 64, 4)
    finally:
        occupancy.device_memory_budget = budget
    check(np.array_equal(split, full) and split_rays == full_rays,
          "64^3 'split' differs from 'full' on the card")
    log(f"[20] 64^3 per-voxel albedo, 64^2 x 4: 'split' equals 'full' bit for "
        f"bit ({split_rays:.0f} rays)")
    del small

    total = torch.cuda.mem_get_info()[1]
    n = int(np.ceil((0.31 * total / 16) ** (1 / 3)))
    check(16 * n ** 3 > 0.3 * total and 20 * n ** 3 < 0.8 * total,
          f"side {n} is not a 'split' size for {total} B")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene = per_voxel_albedo_scene(n, 22)
    made = time.perf_counter() - t0
    mode = fast._albedo_mode(scene, allow_split=True)
    check(mode == "split", f"{n}^3 planned {mode!r}, not 'split'")
    t0 = time.perf_counter()
    img, n_rays = render(scene, 128, 1)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(img.shape == (128, 128, 3) and np.isfinite(img).all() and n_rays > 0,
          f"{n}^3 split render: image not finite or no rays")
    log(f"[20] 'split' at {n}^3 ({n ** 3 * 20 / 1e9:.1f} GB of grids made on "
        f"the card in {made:.1f} s; {total / 2**30:.1f} GiB on the card): "
        f"128^2 x 1 two-level {wall:.3f} s wall (incl. image copy), "
        f"{n_rays:.0f} rays, peak allocated {peak / 2**30:.2f} GiB, image "
        f"mean {float(img.mean()):.5f}; card {card}")
    del scene
    torch.cuda.empty_cache()


def options_config2(tmp: str, card: str, scene=None, camera=None,
                    inline: dict = None) -> dict:
    """Phase 20: fastSK's options on config 2's scene (see the module
    docstring): phase 5's scene and camera when given, else written to
    `tmp` and loaded.  `inline` is the defer_ggx 0 row (phase 19's f32
    render, the same render_tile call); without it this renders the
    row.  Returns the defer_ggx 4 row and the spec rows (walls, counts)
    for the kernels line."""
    import torch

    from cudavolumerenderer_tpu_torch.scene.mhd import load_mhd_scene

    if scene is None:
        scene, camera = load_mhd_scene(write_medical_mhd(tmp), device="cuda")
    if inline is None:
        inline = option_render(scene, camera, {}, "defer_ggx 0", card,
                               window=True)
    defer = option_render(scene, camera, {"defer_ggx": 4}, "defer_ggx 4",
                          card, window=True)
    check(torch.equal(defer["img"], inline["img"])
          and defer["n_rays"] == inline["n_rays"],
          "defer_ggx 4 differs from defer_ggx 0")
    check(defer["by_mode"]["defer"] > 0 and defer["by_mode"]["defer"] ==
          defer["launches"] + defer["drains"],
          f"defer_ggx 4 launched {defer['by_mode']} deferred-mode kernels of "
          f"{defer['launches']} + {defer['drains']}")
    check(defer["kernels"] is not None
          and defer["kernels"] <= DEFER_KERNELS_MAX,
          f"defer_ggx 4 ran {defer['kernels']} device kernels per evaluation "
          f"(None: the profiler's trace held no device time)")
    log(f"[20] defer_ggx 4 through the kernels equals 0 bit for bit "
        f"({defer['n_rays']:.0f} rays); {defer['wall']:.3f} s wall, "
        f"evaluations {defer['evals']:.0f} against {inline['evals']:.0f}; "
        f"{defer['launches']} body + {defer['drains']} drain launches, "
        f"{defer['reads']} host reads; kernels per evaluation "
        f"{defer['kernels']} against {inline['kernels']}; card {card}")
    bm = option_render(scene, camera, {"brick_major": True}, "brick_major",
                       card)
    check(torch.equal(bm["img"], inline["img"])
          and bm["n_rays"] == inline["n_rays"],
          "brick_major differs from the row-major render")
    log("[20] brick_major equals the row-major render bit for bit")
    del bm, inline
    tail_furnace_on_card()
    rows = {label: option_render(scene, camera, fields, label, card)
            for label, fields in TAIL_ROWS}
    for label, fields in TAIL_ROWS:
        spec = rows[label]["by_mode"]["spec"]
        check((spec > 0) == (fields.get("tail_spec", 1) > 1),
              f"{label}: {spec} speculative-mode launches")
    # the eager comparison at SPEC_EAGER_RES^2 x 1 (its body takes ~40 ms
    # an evaluation, ~1,500 evaluations at 512^2 x 4)
    small = dict(res=SPEC_EAGER_RES, iters=1)
    got = option_render(scene, camera, dict(TAIL_ROWS)[SPEC_EAGER],
                        SPEC_EAGER, card, **small)
    eager = option_render(scene, camera, dict(TAIL_ROWS)[SPEC_EAGER],
                          SPEC_EAGER, card, eager=True, **small)
    check(got["by_mode"]["spec"] > 0,
          f"{SPEC_EAGER} at {SPEC_EAGER_RES}^2 launched no speculative stage")
    check(torch.equal(got["img"], eager["img"])
          and got["n_rays"] == eager["n_rays"]
          and got["n_rows"] == eager["n_rows"],
          f"{SPEC_EAGER} through the kernels differs from its eager body")
    check(eager["launches"] + eager["drains"] == 0,
          f"{SPEC_EAGER}'s eager render launched the body kernels")
    log(f"[20] {SPEC_EAGER} through the kernels equals its eager-body render "
        f"bit for bit at {SPEC_EAGER_RES}^2 x 1 (image, {got['n_rays']:.0f} "
        f"rays, n_rows {got['n_rows']:.0f}): {got['wall']:.3f} s against "
        f"{eager['wall']:.3f} s wall; card {card}")
    ref = rows[TAIL_ROWS[0][0]]
    ref_mean = float(ref["host"].mean())
    for label, _ in TAIL_ROWS[1:]:
        mean_off = abs(float(rows[label]["host"].mean()) - ref_mean) / ref_mean
        rays_off = abs(rows[label]["n_rays"] - ref["n_rays"]) / ref["n_rays"]
        log(f"[20] {label} against {TAIL_ROWS[0][0]}: image mean off by "
            f"{mean_off:.3%}, n_rays by {rays_off:.3%}")
        check(mean_off < 0.02 and rays_off < 0.05,
              f"{label}: image mean off by {mean_off:.3%}, rays by "
              f"{rays_off:.3%}")
    keep = ("wall", "evals", "n_rays", "n_rows", "launches", "drains",
            "reads", "by_mode", "kernels")
    out = {"defer": {k: defer[k] for k in keep},
           "spec": {label: {k: rows[label][k] for k in keep}
                    for label, fields in TAIL_ROWS
                    if fields.get("tail_spec", 1) > 1},
           "spec_eager_wall": eager["wall"],
           "spec_eager_kernel_wall": got["wall"],
           "spec_eager_res": SPEC_EAGER_RES}
    del rows, defer, eager
    split_on_card(card)
    return out


# phase 22: the body evaluations whose states are kept (0: every lane
# regenerates; 20: the 262,144-lane pool tracking; 100: a 65,536-lane pool)
BODY_KEEP = (0, 20, 100)
BODY_TAIL_WIDTHS = (16384, 4096)  # and the first of each of these pool widths
BODY_PLAIN_REPS = 5  # eager evaluations timed per kept state
DRAIN_BLOCKS = (32, 64, 128, 256)  # phase 22's drain threads per block
CONFIG2_RAYS = 6056452  # config 2's n_rays (512^2 x 4, no tail kernel)
CONFIG2_EVALS = 3002  # and its body evaluations (n_rows over pool widths)


def clone_state(s):
    """A FastState with every tensor copied (the kernel updates in place)."""
    return type(s)(*(type(v)(v.state.clone(), v.inc.clone())
                     if hasattr(v, "inc") else v.clone() for v in s))


def state_diff(a, b):
    """{field: lanes that differ} between two FastStates (NaN equals NaN),
    and the largest absolute difference of their float fields."""
    import torch

    out, err = {}, 0.0
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "rng":
            x, y = torch.stack([x.state, x.inc]), torch.stack([y.state, y.inc])
        if x.is_floating_point():
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
            fin = torch.isfinite(x) & torch.isfinite(y)
            if bool(fin.any()):
                err = max(err, float((x - y)[fin].abs().max()))
        else:
            same = x == y
        if not bool(same.all()):
            out[name] = int((~same).reshape(x.shape[0], -1).any(-1).sum()
                            if x.ndim else 1)
    return out, err


def device_time(fn):
    """(result of fn(), device kernels, device busy ms) from torch.profiler
    around one call (None for both when the trace holds no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    if not busy:
        return out, None, None
    return out, sum(e.count for e in on_card), busy


def stage_run(fn, fb):
    """One stage run, fn(): (its result, wall ms with the card synchronised,
    body launches, drain launches, host reads)."""
    import torch

    k = fb.KERNEL
    torch.cuda.synchronize()
    before = (k.launches, k.drain_launches, k.reads)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return (out, wall, k.launches - before[0], k.drain_launches - before[1],
            k.reads - before[2])


def counted_render(renderer, fb) -> dict:
    """renderer.render() with the body kernels' counts set to 0 just before
    and read just after: render_tile's with_stats tuple, the wall in s
    with the image copy, body and drain launches, host reads, the host's
    seconds enqueueing gated launches, and the last drain's L, E,
    launches and threads."""
    import torch

    k = fb.KERNEL
    torch.cuda.synchronize()
    k.launches = k.drain_launches = k.reads = 0
    k.enqueue_s, k.last_drain = 0.0, None
    with CascadeCounter() as cascades:
        t0 = time.perf_counter()
        renderer.render()
        wall = time.perf_counter() - t0
    check(len(cascades.stats) == 1, f"{len(cascades.stats)} cascades")
    return {"stats": cascades.stats[0], "wall": wall,
            "launches": k.launches, "drains": k.drain_launches,
            "reads": k.reads, "enqueue_s": k.enqueue_s,
            "drain": k.last_drain}


def per_evaluation_render(renderer, fb, keep_body=None, keep_stage=None):
    """renderer.render() through the per-evaluation loop (fastbody's
    loop_stage, one run_body launch and one pending-count read per
    evaluation), optionally wrapping run_body and keeping each stage's
    entry; returns counted_render's tuple."""
    run_stage, run_body = fb.run_stage, fb.run_body

    def stage(ctx, s, thresh, k_chain, last):
        if keep_stage is not None:
            keep_stage(ctx, s, thresh, k_chain, last)
        return fb.loop_stage(ctx, s, thresh, k_chain)

    fb.run_stage = stage
    if keep_body is not None:
        fb.run_body = keep_body
    try:
        return counted_render(renderer, fb)
    finally:
        fb.run_stage, fb.run_body = run_stage, run_body


def body_states(scene, camera, card: str) -> dict:
    """Phase 22: config 2 (phase 5's scene and camera, 512^2 x 4, one tile,
    two-level, no tail kernel).  (a) Rendered through the per-evaluation
    loop, keeping the states at evaluations BODY_KEEP, at the first
    evaluation of each BODY_TAIL_WIDTHS pool and at each stage's entry;
    then through the stage path (gated chains, the drain), its counts set
    to 0 just before: render_tile's image, n_rays, n_rows, n_busy and
    per-stage rows equal bit for bit, n_rays CONFIG2_RAYS and
    CONFIG2_EVALS evaluations; the two renders again in turns (loop,
    stage, stage, loop: wall with the image copy).  (b) On each stage's
    entry state the per-evaluation loop against the stage path, in turns:
    every FastState field equal, wall, device kernels and busy ms
    (torch.profiler), launches and host reads.  (c) The drain's block
    sizes (CUDA events around one drain each, twice in turns) and its
    plain version (the eager body's loop, timed, its taps giving the
    drain's byte bound).  (d) On each kept evaluation state, one kernel
    evaluation against one eager evaluation: every FastState field and
    the pending count equal; the kernel's device time per evaluation
    (replays of a CUDA graph of GRAPH_CALLS out-of-place evaluations),
    the eager body's (CUDA events) and the byte bound."""
    import torch

    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.ops import fastbody as fb

    cfg = Config(kernel=Kernel.FAST_SK, two_level=True, resolution=(512, 512),
                 iterations=4, n_tiles=(1, 1))
    renderer = create_renderer(scene, camera, cfg)
    run = fb.run_body
    kept, evals, widths, stages = {}, [0], set(), []

    def keeping(ctx, s, out=None):
        width = s.alive.shape[0]
        tag = None
        if evals[0] in BODY_KEEP:
            tag = f"evaluation {evals[0]}"
        elif width in BODY_TAIL_WIDTHS and width not in widths:
            tag = f"first {width}-lane evaluation"
        if tag is not None:
            widths.add(width)
            kept[tag] = (ctx, clone_state(s), evals[0])
        evals[0] += 1
        return run(ctx, s, out)

    def keep_stage(ctx, s, thresh, k_chain, last):
        stages.append((ctx, clone_state(s), thresh, k_chain, last))

    # -- (a) whole renders: the per-evaluation loop against the stage path
    loop = per_evaluation_render(renderer, fb, keeping, keep_stage)
    stage = counted_render(renderer, fb)
    _, n_rays, _, _, rows = stage["stats"]
    launches, drains, reads, info = (stage[k] for k in (
        "launches", "drains", "reads", "drain"))
    for name, x, y in zip(("image", "n_rays", "n_rows", "n_busy",
                           "stage_rows"), stage["stats"], loop["stats"]):
        check(torch.equal(x, y), f"phase 22: the stage path's {name} differs "
              "from the per-evaluation loop's")
    n_evals = sum(float(r) / w for r, w in zip(rows.tolist(), (
        s.alive.shape[0] for _, s, *_ in stages)))
    check(float(n_rays) == CONFIG2_RAYS and n_evals == CONFIG2_EVALS,
          f"config 2 traced {float(n_rays):.0f} rays in {n_evals} "
          f"evaluations, not {CONFIG2_RAYS} in {CONFIG2_EVALS}")
    check(launches > 0 and drains > 0, f"config 2 made {launches} body and "
          f"{drains} drain launches")
    walls = {"loop": [loop["wall"]], "stage": [stage["wall"]]}
    for mode in ("stage", "loop"):
        again = (counted_render(renderer, fb) if mode == "stage"
                 else per_evaluation_render(renderer, fb))
        walls[mode].append(again["wall"])
    enqueue_us = stage["enqueue_s"] * 1e6 / launches
    log(f"[22] config 2 512^2 x 4 (no tail kernel): {float(n_rays):.0f} rays, "
        f"{n_evals:.0f} evaluations; per-evaluation loop {loop['launches']} "
        f"launches, {loop['reads']} pending-count reads; stage path "
        f"{launches} body launches ({enqueue_us:.2f} us of host time "
        f"enqueueing each), "
        f"{drains} drain launch(es), {reads} host reads (batches of "
        f"{fb.GATED_BATCH} and drain launches {launches / fb.GATED_BATCH + drains:.0f}"
        f" + stages {len(stages)}); the drain's longest "
        f"lane L = {info['L']}, E = {info['E']} evaluations, "
        f"{info['threads']} threads per block; every output bit-equal; wall "
        f"with the image copy in turns (loop, stage, stage, loop): "
        f"{walls['loop'][0]:.4f} / {walls['stage'][0]:.4f} / "
        f"{walls['stage'][1]:.4f} / {walls['loop'][1]:.4f} s; card {card}")
    check(len(kept) == len(BODY_KEEP) + len(BODY_TAIL_WIDTHS),
          f"kept {list(kept)}")

    # -- (b) each stage: the per-evaluation loop against the stage path ---
    stage_rows = []
    for ctx, s, thresh, k_chain, last in stages:
        width = s.alive.shape[0]
        mode = fb.stage_mode("cuda", 1, thresh)
        runs = {}
        for which in ("loop", "stage", "stage", "loop"):
            fn = ((lambda: fb.loop_stage(ctx, clone_state(s), thresh, k_chain))
                  if which == "loop" else
                  (lambda: fb.run_stage(ctx, clone_state(s), thresh, k_chain,
                                        last)))
            runs.setdefault(which, []).append(stage_run(fn, fb))
        for which in ("loop", "stage"):
            _, kernels, busy = device_time(
                (lambda: fb.loop_stage(ctx, clone_state(s), thresh, k_chain))
                if which == "loop" else
                (lambda: fb.run_stage(ctx, clone_state(s), thresh, k_chain,
                                      last)))
            runs[which].append((kernels, busy))
        (want, n_want), (got, n) = runs["loop"][0][0], runs["stage"][0][0]
        diff, _ = state_diff(got, want)
        check(not diff and n == n_want, f"phase 22, {width}-lane stage: the "
              f"stage path differs from the per-evaluation loop in {diff}, "
              f"or runs {n} evaluations against {n_want}")
        row = {"width": width, "mode": mode, "evaluations": n}
        for which in ("loop", "stage"):
            (_, w1, l1, d1, r1), (_, w2, *_), (kernels, busy) = (
                runs[which][0], runs[which][1], runs[which][2])
            row[which] = {"wall_ms": [w1, w2], "launches": l1,
                          "drain_launches": d1, "reads": r1,
                          "device_kernels": kernels, "device_ms": busy}
        stage_rows.append(row)
        lo, st = row["loop"], row["stage"]
        log(f"[22] {width}-lane stage ({mode}, {n} evaluations): per-"
            f"evaluation loop {lo['wall_ms'][0]:.3f} / {lo['wall_ms'][1]:.3f} "
            f"ms wall, {lo['launches']} launches, {lo['reads']} reads, device "
            f"{lo['device_ms']} ms in {lo['device_kernels']} kernels; stage "
            f"path {st['wall_ms'][0]:.3f} / {st['wall_ms'][1]:.3f} ms wall, "
            f"{st['launches']} body + {st['drain_launches']} drain launches, "
            f"{st['reads']} reads, device {st['device_ms']} ms in "
            f"{st['device_kernels']} kernels; bit-equal; card {card}")

    # -- (c) the drain: block sizes, and its plain version -----------------
    ctx, s, thresh, k_chain, _ = stages[-1]
    check(thresh == 0, "config 2's last stage does not drain")
    width = s.alive.shape[0]
    want, _ = fb.loop_stage(ctx, clone_state(s), 0, k_chain)
    drain_ms, drain_err = {}, 0.0
    for threads in DRAIN_BLOCKS + DRAIN_BLOCKS[::-1]:
        t = clone_state(s)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        got, _ = fb.KERNEL.drain(ctx, t, k_chain, threads=threads)
        stop.record()
        torch.cuda.synchronize()
        diff, err = state_diff(got, want)
        drain_err = max(drain_err, err)
        check(not diff, f"phase 22: the drain in blocks of {threads} differs "
              f"from the per-evaluation loop in {diff}")
        drain_ms.setdefault(threads, []).append(start.elapsed_time(stop))
    longest = fb.KERNEL.last_drain["L"]
    default = fb.DRAIN_THREADS
    taps, t = [], clone_state(s)
    spp = int(ctx.iparams[fb.IP_SPP])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while fb.pending_count(t, spp) > 0:
        for _ in range(k_chain):
            t = ctx.plain(t, taps=taps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    diff, _ = state_diff(t, want)
    check(not diff, f"phase 22: the eager drain differs in {diff}")
    n_bytes = fb.body_bytes(ctx, taps)
    bound, bound_by = bound_ms(n_bytes)
    ms = min(drain_ms[default])
    log(f"[22] drain of the {width}-lane stage: longest lane L = {longest} "
        f"evaluations; " + ", ".join(
            f"{k} threads {v[0]:.3f} / {v[1]:.3f} ms" for k, v in
            drain_ms.items()) + f" (CUDA events, one launch each, in turns); "
        f"at {default} threads {ms * 1e3 / longest:.3f} us per step of the "
        f"longest lane; its plain version (the eager body's loop) "
        f"{plain_ms:.1f} ms; bound {n_bytes} B = {bound * 1e3:.3f} us "
        f"({bound / ms:.2%} of the drain); card {card}")
    drain = {"launches": drains, "ms": ms, "plain_ms": plain_ms,
             "max_abs_err": drain_err,
             "bound_ms": bound, "bound_by": bound_by, "bytes": n_bytes,
             "L": longest, "E": info["E"], "threads": default,
             "us_per_step": ms * 1e3 / longest,
             "ms_by_threads": drain_ms}

    # -- (d) one evaluation: the kernel against the eager body -------------
    rows, max_err = {}, 0.0
    for tag, (ctx, s, at) in kept.items():
        width = s.alive.shape[0]
        spp = int(ctx.iparams[fb.IP_SPP])
        got, pending = fb.run_body(ctx, clone_state(s))
        taps = []
        want = ctx.plain(clone_state(s), taps=taps)
        diff, err = state_diff(got, want)
        max_err = max(max_err, err)
        pend = int((want.alive | (want.samples_done < spp)).sum())
        check(not diff and int(pending) == pend,
              f"phase 22, {tag}: the kernel's evaluation differs from the "
              f"eager body's in {diff}; pending {int(pending)} against {pend}")
        out = clone_state(s)
        ms = graph_ms([lambda: fb.KERNEL.launch(ctx, s, out)] * GRAPH_CALLS)
        plain_ms = cuda_ms(lambda: ctx.plain(clone_state(s)), BODY_PLAIN_REPS,
                           1)
        n_bytes = fb.body_bytes(ctx, taps)
        bound, bound_by = bound_ms(n_bytes)
        rows[tag] = {"width": width, "evaluation": at, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "bytes": n_bytes,
                     "tracking": int(s.tracking.sum()),
                     "alive": int(s.alive.sum())}
        log(f"[22] {tag} ({width} lanes, {rows[tag]['alive']} alive, "
            f"{rows[tag]['tracking']} tracking): kernel equals the eager body "
            f"in every FastState field (pending {pend}); kernel "
            f"{ms * 1e3:.2f} us per evaluation (graph of {GRAPH_CALLS}), eager "
            f"body {plain_ms:.3f} ms (the copy of its input included); bound "
            f"{n_bytes} B = {bound * 1e3:.2f} us ({bound / ms:.1%} of the "
            f"kernel's time); card {card}")
    return {"rows": rows, "max_abs_err": max_err, "evals": evals[0],
            "launches": launches, "reads": reads, "walls": walls,
            "enqueue_us": enqueue_us,
            "stages": stage_rows, "drain": drain}


# phase 22 (e): the kept pools of the two modes: (mode, Config fields, the
# kept stage's pool width); the defer pool is advanced to an evaluation that
# flushes with lanes waiting
MODE_POOLS = (("spec", dict(TAIL_ROWS)[SPEC_EAGER], 512),
              ("defer", {"defer_ggx": 4}, 16384))
MODE_DRAIN_CAP = 32  # (e): the capped drain's evaluations per lane
SPEC_SWEEP = (1, 8, 16, 32)  # (e): the spec pool's drain timed at each K
#: the JAX code each mode's kernel path replaces (render_tile's body under
#: the cascade's lax.while_loop): the speculative steps, the flush
MODE_REPLACES = {"spec": "cudavolumerenderer_tpu/models/fast.py:907",
                 "defer": "cudavolumerenderer_tpu/models/fast.py:712"}
MODE_DESIGN = {
    "spec": "speculate in the body and drain kernels: K flight draws find "
            "the valid prefix n_v, a second pass re-derives each candidate "
            "from the saved stream with its tap and acceptance draws from "
            "two streams n_v apart (no per-candidate array, any K to "
            "MAX_SPEC_K); the table loads of 4 candidates issued before "
            "their tests",
    "defer": "the deferred GGX flush in the body and drain kernels: the "
             "flag round(n_rows / width) % G == 0 from the evaluation's "
             "float32 n_rows (IEEE division, rintf), which a drain thread "
             "carries in registers, so lanes stay independent and the last "
             "stage stays one launch; pend_b read and written only under "
             "defer_ggx",
}


def mode_pool(scene, camera, mode: str, fields: dict, width: int, card: str):
    """Phase 22 (e), one mode: config 2 with Config `fields` through the
    stage path, keeping the entry of its `width`-lane stage; the defer pool
    advanced (kernel evaluations) to one that flushes with lanes waiting.
    On that pool one kernel evaluation against one eager evaluation (every
    FastState field and the pending count), the kernel's device time per
    evaluation (a CUDA graph of GRAPH_CALLS out-of-place evaluations), the
    eager evaluation's (CUDA events) and the byte bound; then one drain
    launch capped at MODE_DRAIN_CAP evaluations against as many eager
    evaluations (bit for bit), both timed, and its bound; the spec pool
    also drained to its end at each K of SPEC_SWEEP."""
    import torch

    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.ops import fastbody as fb

    cfg = Config(kernel=Kernel.FAST_SK, two_level=True, resolution=(512, 512),
                 iterations=CONFIG2_ITERS, n_tiles=(1, 1), **fields)
    kept, run = [], fb.run_stage

    def keep(ctx, s, thresh, k_chain, last):
        if s.alive.shape[0] == width and not kept:
            kept.append((ctx, clone_state(s), k_chain))
        return run(ctx, s, thresh, k_chain, last)

    fb.run_stage = keep
    try:
        create_renderer(scene, camera, cfg).render()
    finally:
        fb.run_stage = run
    check(len(kept) == 1, f"phase 22 (e), {mode}: no {width}-lane stage")
    ctx, s, k_chain = kept[0]
    check(mode in fb.modes_of(ctx), f"phase 22 (e): the {width}-lane stage "
          f"runs {fb.modes_of(ctx)}, not {mode}")
    defer = int(ctx.iparams[fb.IP_DEFER])
    for _ in range(2 * max(defer, 1)):
        if mode == "spec" or (bool(s.pend_b.any()) and fb.flush_due(
                float(s.n_rows), width, defer)):
            break
        s = fb.run_body(ctx, s)[0]
    check(mode == "spec" or fb.flush_due(float(s.n_rows), width, defer),
          f"phase 22 (e): no flushing {width}-lane evaluation found")
    spp = int(ctx.iparams[fb.IP_SPP])
    got, pending = fb.run_body(ctx, clone_state(s))
    taps = []
    want = ctx.plain(clone_state(s), taps=taps)
    diff, err = state_diff(got, want)
    pend = int((want.alive | (want.samples_done < spp)).sum())
    check(not diff and int(pending) == pend,
          f"phase 22 (e), {mode}: the kernel's evaluation differs from the "
          f"eager body's in {diff}; pending {int(pending)} against {pend}")
    out = clone_state(s)
    ms = graph_ms([lambda: fb.KERNEL.launch(ctx, s, out)] * GRAPH_CALLS)
    plain_ms = cuda_ms(lambda: ctx.plain(clone_state(s)), BODY_PLAIN_REPS, 1)
    n_bytes = fb.body_bytes(ctx, taps)
    bound, bound_by = bound_ms(n_bytes)
    row = {"width": width, "spec_k": int(ctx.iparams[fb.IP_SPEC]),
           "defer_ggx": defer, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": bound_by, "bytes": n_bytes,
           "alive": int(s.alive.sum()), "tracking": int(s.tracking.sum()),
           "waiting": int(s.pend_b.sum())}
    log(f"[22] (e) {mode} pool ({width} lanes, spec_k {row['spec_k']}, "
        f"defer_ggx {defer}; {row['alive']} alive, {row['tracking']} "
        f"tracking, {row['waiting']} waiting for the flush): kernel equals "
        f"the eager body in every FastState field (pending {pend}); kernel "
        f"{ms * 1e3:.2f} us per evaluation (graph of {GRAPH_CALLS}), eager "
        f"body {plain_ms:.3f} ms; bound {n_bytes} B = {bound * 1e3:.2f} us "
        f"({bound / ms:.1%} of the kernel's time); card {card}")

    # one drain launch capped at MODE_DRAIN_CAP against as many evaluations
    t = clone_state(s)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    got, _ = fb.KERNEL.drain(ctx, t, k_chain, cap=MODE_DRAIN_CAP, once=True)
    stop.record()
    torch.cuda.synchronize()
    drain_ms = start.elapsed_time(stop)
    info = fb.KERNEL.last_drain
    n = MODE_DRAIN_CAP if info["left"] else info["E"]
    taps, want = [], clone_state(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        want = ctx.plain(want, taps=taps)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    diff, derr = state_diff(got, want)
    check(not diff, f"phase 22 (e), {mode}: the drain capped at "
          f"{MODE_DRAIN_CAP} differs from {n} eager evaluations in {diff}")
    n_bytes = fb.body_bytes(ctx, taps)
    dbound, dbound_by = bound_ms(n_bytes)
    row["drain"] = {"cap": MODE_DRAIN_CAP, "evaluations": n,
                    "left": info["left"], "ms": drain_ms, "plain_ms": eager_ms,
                    "bound_ms": dbound, "bound_by": dbound_by,
                    "bytes": n_bytes}
    row["max_abs_err"] = max(err, derr)
    if mode == "spec":
        # the drain of the kept stage to its end at each K of phase 20's
        # rows (speculation is memoryless, so any K may take over a pool)
        row["drain_by_k"] = {}
        for k in SPEC_SWEEP:
            ctx_k = dataclasses.replace(ctx, iparams=ctx.iparams.copy())
            ctx_k.iparams[fb.IP_SPEC] = k
            t = clone_state(s)
            torch.cuda.synchronize()
            start.record()
            fb.KERNEL.drain(ctx_k, t, k_chain)
            stop.record()
            torch.cuda.synchronize()
            info = fb.KERNEL.last_drain
            row["drain_by_k"][k] = {"ms": start.elapsed_time(stop),
                                    "L": info["L"], "E": info["E"]}
        log(f"[22] (e) the {width}-lane stage drained to its end at spec_k "
            + ", ".join(f"{k}: {v['ms']:.3f} ms (L = {v['L']}, "
                        f"{v['ms'] * 1e3 / v['L']:.2f} us a step)"
                        for k, v in row["drain_by_k"].items())
            + f" (CUDA events, one launch each); card {card}")
    log(f"[22] (e) {mode} pool: one drain launch capped at "
        f"{MODE_DRAIN_CAP} ({row['drain']['left']} lanes left) equals {n} "
        f"eager evaluations in every FastState field; drain {drain_ms:.3f} ms "
        f"(CUDA events), eager {eager_ms:.1f} ms; bound {n_bytes} B = "
        f"{dbound * 1e3:.2f} us ({dbound / drain_ms:.1%} of the drain); "
        f"card {card}")
    return row


def mode_pools(scene, camera, card: str) -> dict:
    """Phase 22 (e): mode_pool for each of MODE_POOLS."""
    return {mode: mode_pool(scene, camera, mode, fields, width, card)
            for mode, fields, width in MODE_POOLS}


# phase 23: the replay evaluations whose states are kept (0: every lane
# starts a segment, no tracking step yet; 4: tracking in the 65,536-lane
# pool, the widest; 20 and 100 in narrower pools, 32,768 and 4,096 lanes),
# and the first evaluation of each of these pool widths
REPLAY_KEEP = (0, 4, 20, 100)
#: the kept state whose primal row the kernels line reports
REPLAY_HEAD = "evaluation 4"
REPLAY_WIDTHS = (16384, 4096)
REPLAY_PLAIN_REPS = 5  # eager evaluations timed per kept state
# atomic pass B against the eager body: per voxel, and the sums
GRAD_RTOL, GRAD_ATOL, GRAD_SUM = 1e-4, 1e-5, 1e-6


def grads_apart(got, want) -> float:
    """The largest per-voxel excess over GRAD_RTOL |want| + GRAD_ATOL
    max|want| (<= 0 within tolerance), checked with the sums' GRAD_SUM."""
    got, want = got.double(), want.double()
    excess = float(((got - want).abs() - GRAD_RTOL * want.abs()
                    - GRAD_ATOL * want.abs().max()).max())
    check(abs(float(got.sum() - want.sum()))
          <= GRAD_SUM * float(want.abs().sum()),
          "phase 23: the cotangents' sums disagree")
    return excess


def replay_problem(card: str):
    """Phase 14's 256^3 problem: inverse_256's phantom (medical_volume, 40
    blobs), albedo 0.6, scale 12, RR off, max_path_length 64, its first
    orbit view at 128^2 x 4 (65,536 lanes); pass B's weights from the
    kernel's primal and an image cotangent made with numpy from a seed."""
    import torch

    from cudavolumerenderer_tpu_torch.models import differentiable as td
    from cudavolumerenderer_tpu_torch.models import inverse
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

    n, res, spp = int(TRAIN_ARGV[1]), int(TRAIN_ARGV[3]), 4
    gt = procedural.medical_volume((n,) * 3, n_blobs=40)
    spec = td.SceneSpec(scale=12.0, max_density=1.0)
    scene = spec.build(gt, np.full((1, 1, 1, 4), 0.6, np.float32), "cuda")
    view = inverse.orbit_camera_specs(2, radius=100.0, res=(res, res),
                                      fov_x_deg=0.8)[0]
    cam = view.build("cuda")
    settings = RenderSettings.from_flags(True, russian_roulette=False,
                                         max_path_length=64)
    tables = td._build_brick_tab(scene.medium.density.data)
    lanes, image_id, o0, d0, rng = td._lane_setup(cam, (res, res), spp, 12345)
    prim = td._replay(scene, settings, o0, d0, rng,
                      torch.zeros(lanes, device="cuda"),
                      torch.zeros((lanes, 3), device="cuda"), False, None,
                      None, tables)
    g_img = torch.tensor(np.random.RandomState(23).rand(res, res, 3)
                         .astype(np.float32), device="cuda")
    g_lane = g_img.reshape(-1, 3)[image_id] * prim.radiance
    return (scene, settings, tables, o0, d0, rng, torch.sum(g_lane, dim=-1),
            g_lane)


def cotangent_buffers(scene):
    import torch

    alb = scene.medium.albedo.data
    return (torch.zeros(scene.medium.density.data.numel(), device="cuda"),
            torch.zeros((alb.numel() // alb.shape[-1], alb.shape[-1]),
                        device="cuda"))


def replay_states(card: str) -> dict:
    """Phase 23: render_diff's replay kernels on phase 14's 256^3 problem
    (65,536 lanes, pools 65,536 to 4,096).  (a) Pass B through the eager
    body (eager_body), keeping the pool at evaluations REPLAY_KEEP, at the
    first evaluation of each REPLAY_WIDTHS pool and at each stage's entry;
    the whole replay through the kernels against it, primal and pass B:
    wall, launches, host reads, outputs (radiance bit for bit, cotangents
    within GRAD_*).  (b) On each kept pool one kernel evaluation against
    one eager evaluation: every _Lanes field and the alive count bit for
    bit for the primal and pass B, pass B's cotangents bit for bit under
    deterministic algorithms and within GRAD_* with atomics; the kernel's
    device time per evaluation (replays of a CUDA graph of GRAPH_CALLS
    out-of-place evaluations), the eager body's (CUDA events) and the byte
    bound (ops/replaybody.replay_bytes).  (c) On each stage's entry the
    per-evaluation loop (loop_stage, the kernel per evaluation) against the
    stage path (gated chains, the drain): every field and the evaluations
    equal, walls, launches and reads, primal and pass B.  (d) The drain of
    the last stage timed by CUDA events around one launch (primal and pass
    B, twice each in turns), the longest lane L and us per step, its plain
    version (the eager loop over the stage, wall) and its byte bound over
    every evaluation's taps."""
    import torch

    from cudavolumerenderer_tpu_torch.models import differentiable as td
    from cudavolumerenderer_tpu_torch.ops import replaybody as rb

    problem = replay_problem(card)
    scene, settings, tables, o0, d0, rng, s_lane, g_lane = problem
    k = rb.KERNEL
    lanes = o0.shape[0]

    # -- (a) pass B through the eager body, keeping pools; whole replays ---
    kept, stages, count, seen = {}, [], [0], set()
    plain, loop = rb.plain_body, rb.loop_stage

    def keep_body(ctx, s):
        width = s.alive.shape[0]
        if count[0] in REPLAY_KEEP:
            kept[f"evaluation {count[0]}"] = (clone_state(s), count[0])
        elif width in REPLAY_WIDTHS and width not in seen:
            seen.add(width)
            kept[f"first {width}-lane evaluation"] = (clone_state(s), count[0])
        count[0] += 1
        return plain(ctx, s)

    def keep_stage(ctx, s, thresh, k_chain, body=rb.run_body):
        stages.append((clone_state(s), thresh, k_chain))
        return loop(ctx, s, thresh, k_chain, body)

    def replay(record, eager, dd=None, da=None):
        """(output, wall ms, launches, drain launches, reads, evaluations)"""
        stats = {}
        torch.cuda.synchronize()
        before = (k.launches, k.drain_launches, k.reads)
        t0 = time.perf_counter()
        out = td._replay(scene, settings, o0, d0, rng, s_lane, g_lane, record,
                         dd, da, tables, eager_body=eager, stats=stats)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return (out, wall, k.launches - before[0],
                k.drain_launches - before[1], k.reads - before[2],
                stats["iterations"])

    walls = {}
    de, ae = cotangent_buffers(scene)
    rb.plain_body, rb.loop_stage = keep_body, keep_stage
    try:
        eager_b = replay(True, True, de, ae)
    finally:
        rb.plain_body, rb.loop_stage = plain, loop
    walls["eager pass B"] = eager_b[1]
    check(len(kept) == len(REPLAY_KEEP) + len(REPLAY_WIDTHS),
          f"kept {list(kept)}")
    head_pool = kept[REPLAY_HEAD][0]
    check(head_pool.alive.shape[0] == lanes
          and bool((head_pool.seg & head_pool.alive & head_pool.in_med).any()),
          f"phase 23: {REPLAY_HEAD} is not a tracking evaluation of the "
          f"{lanes}-lane pool")
    eager_p = replay(False, True)
    walls["eager primal"] = eager_p[1]
    kernel_p = replay(False, False)
    dk, ak = cotangent_buffers(scene)
    kernel_b = replay(True, False, dk, ak)
    walls["kernel primal"], walls["kernel pass B"] = kernel_p[1], kernel_b[1]
    check(torch.equal(kernel_p[0].radiance, eager_p[0].radiance)
          and torch.equal(kernel_b[0].radiance, eager_b[0].radiance),
          "phase 23: the kernels' radiance differs from the eager body's")
    check(kernel_p[5] == eager_p[5] == kernel_b[5] == eager_b[5],
          "phase 23: the replays' evaluations differ")
    err = max(grads_apart(dk, de), grads_apart(ak, ae))
    check(err <= 0.0, f"phase 23: pass B's cotangents exceed GRAD_* by {err}")
    log(f"[23] replay at 256^3, {lanes} lanes, {kernel_p[5]} evaluations: "
        f"eager body {walls['eager primal']:.1f} / {walls['eager pass B']:.1f}"
        f" ms (primal / pass B), kernels {walls['kernel primal']:.2f} / "
        f"{walls['kernel pass B']:.2f} ms ({kernel_p[2]} / {kernel_b[2]} "
        f"gated launches, {kernel_p[3]} / {kernel_b[3]} drain launches, "
        f"{kernel_p[4]} / {kernel_b[4]} host reads); radiance bit-equal, "
        f"cotangents within rtol {GRAD_RTOL}, atol {GRAD_ATOL} x max, sums "
        f"{GRAD_SUM}; card {card}")

    # -- (b) one evaluation on each kept pool -------------------------------
    rows, max_err = {}, 0.0
    was = torch.are_deterministic_algorithms_enabled()
    for tag, (s, at) in kept.items():
        width = s.alive.shape[0]
        row = {"width": width, "evaluation": at,
               "alive": int(s.alive.sum()), "tracking": int(
                   (s.seg & s.alive & s.in_med).sum())}
        for record in (False, True):
            name = "pass B" if record else "primal"
            dk, ak = cotangent_buffers(scene)
            de, ae = cotangent_buffers(scene)
            ctx_k = td.replay_context(scene, settings, tables, record, dk, ak)
            ctx_e = td.replay_context(scene, settings, tables, record, de, ae)
            got, alive = rb.run_body(ctx_k, clone_state(s))
            taps = []
            want = ctx_e.plain(clone_state(s), taps=taps)
            diff, e = state_diff(got, want)
            max_err = max(max_err, e)
            check(not diff and int(alive) == int(want.alive.sum()),
                  f"phase 23, {tag}, {name}: the kernel's evaluation differs "
                  f"from the eager body's in {diff}")
            if record:
                err = max(grads_apart(dk, de), grads_apart(ak, ae))
                check(err <= 0.0, f"phase 23, {tag}: pass B's cotangents "
                      f"exceed GRAD_* by {err}")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    dk, ak = cotangent_buffers(scene)
                    de, ae = cotangent_buffers(scene)
                    got, _ = rb.run_body(td.replay_context(
                        scene, settings, tables, True, dk, ak), clone_state(s))
                    want = td.replay_context(scene, settings, tables, True, de,
                                          ae).plain(clone_state(s))
                finally:
                    torch.use_deterministic_algorithms(was)
                diff, _ = state_diff(got, want)
                check(not diff and torch.equal(dk, de) and torch.equal(ak, ae),
                      f"phase 23, {tag}: deterministic pass B differs in "
                      f"{diff} or its cotangents")
            out = clone_state(s)
            ms = graph_ms([lambda: k.launch(ctx_k, s, out)] * GRAPH_CALLS)
            plain_ms = cuda_ms(lambda: ctx_e.plain(clone_state(s)),
                               REPLAY_PLAIN_REPS, 1)
            n_bytes = rb.replay_bytes(ctx_k, taps)
            bound, bound_by = bound_ms(n_bytes)
            row[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": bound_by, "bytes": n_bytes}
            log(f"[23] {tag} ({width} lanes, {row['alive']} alive, "
                f"{row['tracking']} tracking), {name}: the kernel equals the "
                "eager body in every _Lanes field and the alive count"
                + (", its cotangents bit for bit under deterministic "
                   "algorithms" if record else "") + f"; kernel "
                f"{ms * 1e3:.2f} us per evaluation (graph of {GRAPH_CALLS}), "
                f"eager body {plain_ms:.3f} ms (the copy of its input "
                f"included); bound {n_bytes} B = {bound * 1e3:.2f} us "
                f"({bound / ms:.1%} of the kernel's time); card {card}")
        rows[tag] = row

    # -- (c) each stage: the per-evaluation loop against the stage path ------
    stage_rows = []
    for i, (s, thresh, k_chain) in enumerate(stages):
        width = s.alive.shape[0]
        last = i == len(stages) - 1
        for record in (False, True):
            name = "pass B" if record else "primal"
            runs = {}
            for which in ("loop", "stage", "stage", "loop"):
                dd, da = cotangent_buffers(scene)
                ctx = td.replay_context(scene, settings, tables, record,
                                        dd, da)
                fn = rb.loop_stage if which == "loop" else (
                    lambda c, p, t, kc: rb.run_stage(c, p, t, kc, last))
                torch.cuda.synchronize()
                before = (k.launches, k.drain_launches, k.reads)
                t0 = time.perf_counter()
                got, n = fn(ctx, clone_state(s), thresh, k_chain)
                torch.cuda.synchronize()
                runs.setdefault(which, []).append((
                    got, n, (time.perf_counter() - t0) * 1e3,
                    k.launches - before[0], k.drain_launches - before[1],
                    k.reads - before[2], dd, da))
            want, n_want = runs["loop"][0][:2]
            got, n_got = runs["stage"][0][:2]
            diff, _ = state_diff(got, want)
            check(not diff and n_got == n_want, f"phase 23, {width}-lane "
                  f"stage, {name}: the stage path differs from the loop in "
                  f"{diff} or its evaluations ({n_got} against {n_want})")
            if record:
                err = max(grads_apart(runs["stage"][0][6], runs["loop"][0][6]),
                          grads_apart(runs["stage"][0][7], runs["loop"][0][7]))
                check(err <= 0.0, f"phase 23, {width}-lane stage: pass B's "
                      f"cotangents exceed GRAD_* by {err}")
            row = {"width": width, "pass": name, "evaluations": n_want,
                   "mode": "drain" if thresh == 0 else "gated"}
            for which in ("loop", "stage"):
                (_, _, w1, l1, d1, r1, *_), (_, _, w2, *_) = runs[which]
                row[which] = {"wall_ms": [w1, w2], "launches": l1,
                              "drain_launches": d1, "reads": r1}
            stage_rows.append(row)
            lo, st = row["loop"], row["stage"]
            log(f"[23] {width}-lane stage ({row['mode']}, {n_want} "
                f"evaluations), {name}: per-evaluation loop {lo['wall_ms'][0]:.3f} / "
                f"{lo['wall_ms'][1]:.3f} ms wall, {lo['launches']} launches, "
                f"{lo['reads']} reads; stage path {st['wall_ms'][0]:.3f} / "
                f"{st['wall_ms'][1]:.3f} ms wall, {st['launches']} gated + "
                f"{st['drain_launches']} drain launches, {st['reads']} reads; "
                f"equal; card {card}")

    # -- (d) the drain: CUDA events around one launch, and its plain version
    s, thresh, k_chain = stages[-1]
    check(thresh == 0, "phase 23: the last stage does not drain")
    width = s.alive.shape[0]
    drain = {}
    for record in (False, True, True, False):
        name = "pass B" if record else "primal"
        dd, da = cotangent_buffers(scene)
        ctx = td.replay_context(scene, settings, tables, record, dd, da)
        t = clone_state(s)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        k.drain(ctx, t, k_chain)
        stop.record()
        torch.cuda.synchronize()
        drain.setdefault(name, []).append(start.elapsed_time(stop))
    longest, total = k.last_drain["L"], k.last_drain["E"]
    ctx = td.replay_context(scene, settings, tables, False)
    taps, t = [], clone_state(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while bool(t.alive.any()):
        for _ in range(k_chain):
            t = ctx.plain(t, taps=taps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_bytes = rb.replay_bytes(ctx, taps)
    bound, bound_by = bound_ms(n_bytes)
    ms = min(drain["primal"])
    log(f"[23] drain of the {width}-lane stage: L = {longest}, E = {total} "
        "evaluations; " + ", ".join(
            f"{k_} {v[0]:.3f} / {v[1]:.3f} ms" for k_, v in drain.items())
        + f" (CUDA events, one launch each, in turns); "
        f"{ms * 1e3 / max(longest, 1):.3f} us per step of the longest lane; "
        f"its plain version (the eager loop) {plain_ms:.1f} ms; bound "
        f"{n_bytes} B = {bound * 1e3:.3f} us ({bound / ms:.2%} of the drain); "
        f"card {card}")
    head = rows[REPLAY_HEAD]["primal"]
    return {"rows": rows, "max_abs_err": max_err, "walls": walls,
            "launches": {"primal": kernel_p[2], "pass B": kernel_b[2]},
            "reads": {"primal": kernel_p[4], "pass B": kernel_b[4]},
            "evaluations": kernel_p[5], "stages": stage_rows,
            "head": head,
            "drain": {"ms": ms, "ms_by_pass": drain, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by,
                      "bytes": n_bytes, "L": longest, "E": total,
                      "us_per_step": ms * 1e3 / max(longest, 1),
                      "max_abs_err": max_err}}


def north_star(card: str) -> dict:
    """Phase 24: bench_1024.main at its defaults with --bwd (1024^3 plume,
    the forward at 1024^2 x 4, the fwd+bwd at 256^2 x 1), the replay
    kernels' counts set to 0 just before and read just after: its
    forward Mrays/s, primal replay and two fwd+bwd times, peak memory;
    finite numbers, pass B as long as the primal, and every replay through
    the kernels."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks import bench_1024
    from cudavolumerenderer_tpu_torch.ops import replaybody as rb

    k = rb.KERNEL
    torch.cuda.synchronize()
    k.launches = k.drain_launches = k.reads = k.plain_evals = 0
    t0 = time.perf_counter()
    result = bench_1024.main(["--bwd"])
    wall = time.perf_counter() - t0
    counts = {"launches": k.launches, "drain_launches": k.drain_launches,
              "reads": k.reads, "plain_evals": k.plain_evals}
    reps = result["fwdbwd"]
    check(result["n_rays"] > 0 and all(np.isfinite(result["fwd_mrays"]))
          and np.isfinite([r["s"] for r in reps] + [r["gsum"] for r in reps]
                          + [result["primal_s"]]).all(),
          f"bench_1024: numbers not finite: {result}")
    check(all(r["primal_iters"] == r["pass_b_iters"] > 0 for r in reps),
          "bench_1024: pass B's evaluations differ from the primal's")
    check(counts["launches"] > 0 and counts["drain_launches"] > 0
          and counts["plain_evals"] == 0,
          f"bench_1024 did not replay through the kernels: {counts}")
    log(f"[24] bench_1024 --bwd at its defaults: {wall:.1f} s in all; "
        f"forward {', '.join(f'{x:.3f}' for x in result['fwd_s'])} s "
        f"({result['best_mrays']:.2f} Mrays/s best, {result['n_rays']:.0f} "
        f"rays); primal replay {result['primal_s']:.3f} s; fwd+bwd "
        f"{', '.join(f'{r['s']:.3f}' for r in reps)} s; peak allocated "
        f"{result['max_memory_allocated'] / 2**30:.2f} GiB; replay kernels "
        f"{counts['launches']} gated + {counts['drain_launches']} drain "
        f"launches, {counts['reads']} host reads; card {card}")
    return {**result, "counts": counts, "wall_s": wall}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_mesh():
    """Phase 21's group: one rank over NCCL (the backend a CUDA device
    gets by default) at a free localhost port."""
    import torch.distributed as dist

    from cudavolumerenderer_tpu_torch.parallel import mesh as pm

    pm.initialize_distributed(init_method=f"tcp://127.0.0.1:{free_port()}",
                              world_size=1, rank=0)
    mesh = pm.make_mesh(1)
    check(dist.get_backend() == "nccl" and mesh.device.type == "cuda",
          f"the 1-rank group is {dist.get_backend()} on {mesh.device}")
    return mesh


def sharded_config2(mesh, scene, camera, cfg, want, card: str) -> int:
    """Phase 21 (a): phase 5's render (config 2, 512^2 x 4, fastSK
    two-level with the tail kernel) through render_sharded on a 1-rank
    NCCL mesh.  create_renderer renders phase 5's one tile with one
    fast.render_tile call of all spp from path id 0, so image and n_rays
    must equal phase 5's `want` = (image, n_rays) bit for bit, and the
    tail stage's drain must launch.  Returns its launches."""
    import torch
    import torch.distributed as dist

    from cudavolumerenderer_tpu_torch.models.renderer import fast_keywords
    from cudavolumerenderer_tpu_torch.ops import taildrain as td
    from cudavolumerenderer_tpu_torch.parallel.shard import render_sharded

    torch.cuda.synchronize()
    td.KERNEL.reset()
    t0 = time.perf_counter()
    img, n_rays = render_sharded(
        scene, camera, cfg.settings, cfg.resolution, cfg.iterations,
        cfg.seed, mesh, kernel="fast", path_id_base=0, **fast_keywords(cfg))
    host = img.cpu().numpy() / cfg.iterations
    wall = time.perf_counter() - t0
    launches = td.KERNEL.drain_launches
    check(launches > 0, "the sharded config-2 render launched no drain")
    check(np.array_equal(host, want[0]) and float(n_rays) == want[1],
          f"sharded config 2: {float(n_rays):.0f} rays against phase 5's "
          f"{want[1]:.0f}, max |image diff| "
          f"{float(np.abs(host - want[0]).max()):.3g}")
    buf = img.clone()
    ar_ms = cuda_ms(lambda: dist.all_reduce(buf), ALL_REDUCE_REPS, 3)
    log(f"[21] render_sharded on 1 NCCL rank, config 2 512^2 x "
        f"{cfg.iterations}: {wall:.3f} s wall (incl. image copy), "
        f"{float(n_rays):.0f} rays, {launches} drain launch(es); image "
        f"and n_rays equal phase 5's bit for bit; all_reduce of the "
        f"{tuple(img.shape)} image {ar_ms * 1e3:.1f} us (CUDA events, mean "
        f"of {ALL_REDUCE_REPS}); card {card}")
    return launches


def gloo_rank(rank: int, port: int, scene_file: str, out: str,
              device: str = "cuda") -> int:
    """Phase 21 (b), run in a process of its own: rank `rank` of a
    2-rank gloo group whose ranks share the card (NCCL refuses two ranks
    on one device, so the backend is named), rendering phase 21 (b)'s
    settings with render_sharded; rank 0 writes the image and n_rays to
    `out`."""
    import torch.distributed as dist

    from cudavolumerenderer_tpu_torch.config import Config
    from cudavolumerenderer_tpu_torch.parallel import mesh as pm
    from cudavolumerenderer_tpu_torch.parallel.shard import render_sharded
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene

    pm.initialize_distributed(backend="gloo",
                              init_method=f"tcp://127.0.0.1:{port}",
                              world_size=2, rank=rank, device=device)
    try:
        mesh = pm.make_mesh(2, device=device)
        cfg = Config(scene_file=scene_file, resolution=GLOO_RES)
        scene, camera = load_scene(cfg, device=mesh.device)
        t0 = time.perf_counter()
        img, n_rays = render_sharded(
            scene, camera, cfg.settings, GLOO_RES, GLOO_SPP, cfg.seed, mesh,
            kernel="fast", **GLOO_KNOBS)
        host = img.cpu().numpy()
        wall = time.perf_counter() - t0
        check(img.device.type == device, f"rank {rank} image on {img.device}")
        log(f"[21] gloo rank {rank} of 2 on {mesh.device}: "
            f"{wall:.3f} s wall (incl. image copy), {float(n_rays):.0f} rays")
        if rank == 0:
            np.savez(out, img=host, n_rays=float(n_rays), wall=wall)
    finally:
        dist.destroy_process_group()
    return 0


def two_ranks_on_one_card(mesh, tmp: str, card: str) -> None:
    """Phase 21 (b): two processes of a gloo group on the one card
    render GLOO_RES x GLOO_SPP (odd spp: rank 0 also renders the
    remainder) of config 2's scene with fastSK two-level, q4 tables and
    cascade 1.25; meanwhile this process renders the same on its 1-rank
    NCCL mesh.  Images allclose at 1e-5, n_rays equal."""
    from cudavolumerenderer_tpu_torch.config import Config
    from cudavolumerenderer_tpu_torch.parallel.shard import render_sharded
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene

    scene_file = write_medical_mhd(tmp)
    out = os.path.join(tmp, "gloo_rank0.npz")
    port = free_port()
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.gloo_rank("
         f"{rank}, {port}, {scene_file!r}, {out!r}, "
         f"{mesh.device.type!r}))"],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    ) for rank in (0, 1)]
    try:
        cfg = Config(scene_file=scene_file, resolution=GLOO_RES)
        scene, camera = load_scene(cfg, device=mesh.device)
        t0 = time.perf_counter()
        want, want_rays = render_sharded(
            scene, camera, cfg.settings, GLOO_RES, GLOO_SPP, cfg.seed, mesh,
            kernel="fast", **GLOO_KNOBS)
        want = want.cpu().numpy()
        wall = time.perf_counter() - t0
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            if line.startswith("[21]"):
                log(line)
        check(p.returncode == 0, f"gloo rank {rank} failed:\n{text[-3000:]}")
    got = np.load(out)
    err = float(np.abs(got["img"] - want).max())
    check(float(got["n_rays"]) == float(want_rays),
          f"2 gloo ranks traced {float(got['n_rays']):.0f} rays, 1 rank "
          f"{float(want_rays):.0f}")
    np.testing.assert_allclose(got["img"], want, rtol=1e-5, atol=1e-5)
    log(f"[21] 2 gloo ranks on one card against 1 NCCL rank, {GLOO_RES[0]}^2 "
        f"x {GLOO_SPP}, {GLOO_KNOBS}: n_rays {float(want_rays):.0f} equal, "
        f"max |image diff| {err:.3g} (allclose 1e-5); 1 rank {wall:.3f} s, "
        f"2 ranks {float(got['wall']):.3f} s (rank 0's wall, incl. image "
        f"copy); card {card}")


def inverse_one_rank(mesh, card: str) -> None:
    """Phase 21 (c): make_inverse_step on the 1-rank NCCL mesh (SGD)
    against an unsharded render_diff + SGD step with the same seed (at
    rank 0 the salted seed is the seed itself): loss and both updated
    grids bit for bit.  Both run under
    torch.use_deterministic_algorithms, since index_add_'s atomics would
    otherwise add the cotangents in a different order in each call."""
    import torch

    from cudavolumerenderer_tpu_torch.models.differentiable import (
        CameraSpec, SceneSpec, render_diff,
    )
    from cudavolumerenderer_tpu_torch.parallel.shard import make_inverse_step
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

    dev = mesh.device
    d = procedural.blob_volume((INV_N,) * 3, n_blobs=5)
    spec = SceneSpec(scale=10.0)
    cam_spec = CameraSpec(res_x=INV_RES[0], res_y=INV_RES[1], fov_x_deg=0.4)
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=8, bsdf_kind="null")
    target = torch.full((INV_RES[1], INV_RES[0], 3), float(np.exp(-3.0)),
                        device=dev)
    start = torch.tensor(d, device=dev)

    def leaves():
        return (torch.tensor(d, device=dev).requires_grad_(),
                torch.full((INV_N,) * 3 + (3,), 0.5, device=dev)
                .requires_grad_())

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        step = make_inverse_step(
            spec, cam_spec, settings, INV_RES, INV_SPP, mesh,
            lambda p: torch.optim.SGD(p, lr=INV_LR), two_level=True)
        t0 = time.perf_counter()
        params, loss = step(leaves(), target, INV_SEED)
        loss = float(loss)
        wall = time.perf_counter() - t0
        ref = leaves()
        opt = torch.optim.SGD(ref, lr=INV_LR)
        img = render_diff(*ref, INV_SEED, spec, cam_spec, settings, INV_RES,
                          INV_SPP, True) / float(INV_SPP)
        ref_loss = torch.mean((img - target) ** 2)
        ref_loss.backward()
        opt.step()
        ref_loss = float(ref_loss.detach())
    finally:
        torch.use_deterministic_algorithms(was)
    moved = float((params[0].detach() - start).abs().max())
    check(np.isfinite(loss) and moved > 0,
          f"inverse step: loss {loss}, density moved by {moved}")
    check(loss == ref_loss, f"inverse step loss {loss!r} against the "
          f"unsharded {ref_loss!r}")
    for name, got, want in zip(("density", "albedo"), params, ref):
        check(torch.equal(got, want),
              f"inverse step {name}: max |diff| "
              f"{float((got - want).abs().max()):.3g} against the unsharded "
              "step")
    log(f"[21] make_inverse_step on 1 NCCL rank, {INV_N}^3, "
        f"{INV_RES[0]}^2 x {INV_SPP}, two-level, SGD {INV_LR}: loss "
        f"{loss:.6g}, density moved by up to {moved:.3g}; loss and both "
        f"grids equal the unsharded step bit for bit; {wall:.3f} s per step; "
        f"card {card}")


def scaling_rows(card: str) -> dict:
    """Phase 21 (d): benchmarks/scaling_efficiency --compare-plain at its
    default width (128^2 x 4 per rank), SCALING_REPS timed reps after the
    warm-up, in a group of one (the 1-rank NCCL mesh is destroyed first):
    the N = 1 row and the plain fast.render_tile beside it."""
    from cudavolumerenderer_tpu_torch.benchmarks import scaling_efficiency

    out = scaling_efficiency.main(["--compare-plain", "--reps",
                                   str(SCALING_REPS)])
    row, plain = out["rows"][0], out["plain_comparison"]
    check(out["platform"] == "cuda" and row["n"] == 1 and row["s"] > 0,
          f"scaling rows: {out['rows']}")
    log(f"[21] scaling_efficiency --compare-plain, {out['res']}^2 x "
        f"{out['spp_per_device']} per rank: N=1 {row['s']:.3f} s, "
        f"{row['rays_per_s'] / 1e6:.4f} Mrays/s; plain fast.render_tile "
        f"{plain['plain_s']:.3f} s, sharded dispatch overhead "
        f"{plain['sharded_dispatch_overhead']:+.2%}; card {card}")
    return out


def sharded(tmp: str, card: str, slice_result=None, scene=None, camera=None,
            cfg=None) -> int:
    """Phase 21: the port's parallel/ on the card, (a)-(d) above.  Given
    phase 5's (image, n_rays), scene, camera and Config, (a) holds the
    sharded render to them; alone it writes config 2's scene to `tmp`
    and renders phase 5's image first.  Returns (a)'s tail-kernel
    launches."""
    import torch.distributed as dist

    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene

    if slice_result is None:
        cfg = Config(scene_file=write_medical_mhd(tmp), kernel=Kernel.FAST_SK,
                     two_level=True, tail_pallas=True, resolution=(512, 512),
                     iterations=4, n_tiles=(1, 1))
        scene, camera = load_scene(cfg, device="cuda")
        renderer = create_renderer(scene, camera, cfg)
        slice_result = (renderer.render(), renderer.n_rays)
    mesh = nccl_mesh()
    try:
        t0 = time.perf_counter()
        launches = sharded_config2(mesh, scene, camera, cfg, slice_result,
                                   card)
        log(f"[21] (a) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        two_ranks_on_one_card(mesh, tmp, card)
        log(f"[21] (b) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        inverse_one_rank(mesh, card)
        log(f"[21] (c) took {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    scaling_rows(card)
    log(f"[21] (d) took {time.perf_counter() - t0:.1f} s")
    return launches


def family_pool(fam, ctx, width: int, kind: str):
    """Phase 25's kept pool of `width` lanes (its tensors its own) on phase
    11's scene, its paths from the image's middle rows: "refill" a
    regenerationSK pool (PathState, image_id,
    paths_issued) after one iteration, with lanes to refill; "bounce" the
    same after one more refill, every lane alive; "extend" a streamingSK
    pool after 6 iterations, lanes tracking; "flush" a sortingSK pool
    (extend with the stall) after 7, lanes pending."""
    import torch

    from cudavolumerenderer_tpu_torch.models import integrator, regeneration
    from cudavolumerenderer_tpu_torch.models import streaming

    dev = torch.device("cuda")
    accum = torch.zeros((ctx.tile_dim[0] * ctx.tile_dim[1], 3), device=dev)
    # the queue starts with the image's middle rows, where rays meet the
    # medium (its top rows miss it)
    issued = torch.tensor(max(0, ctx.n_paths // 2 - width // 2), device=dev)
    if kind in ("refill", "bounce"):
        p = integrator.PathState(**regeneration.empty_pool(width, ctx.seed,
                                                           dev))
        img = torch.zeros(width, dtype=torch.int64, device=dev)
        for op in ("refill", "bounce", "refill")[:2 + (kind == "bounce")]:
            if op == "refill":
                p, img, issued = fam.plain_body(ctx, op, p, image_id=img,
                                                issued=issued)
            else:
                p, _ = fam.plain_body(ctx, op, p, image_id=img, accum=accum)
        return fam.own(p), img, issued, accum
    s = streaming.initial_stream_state(width, ctx.seed, dev)
    for _ in range(6 if kind == "extend" else 7):
        s, _, issued = fam.plain_body(ctx, "refill", s, issued=issued)
        s, _ = fam.plain_body(ctx, "extend", s, accum=accum,
                              defer=kind == "flush")
    return fam.own(s), None, issued, accum


def family_entry(fam, ctx, op: str, pool, card: str, width: int,
                 label: str = None) -> dict:
    """Phase 25, one entry point on a kept pool: one kernel evaluation
    against one eager evaluation (every lane field bit for bit, the splat's
    image within 1e-5), the kernel's device time per evaluation over graph
    replays of 16 out-of-place evaluations, the eager function's (its
    input's copy included) and the byte bound from its taps."""
    import torch

    from cudavolumerenderer_tpu_torch.ops.stages import lane_field

    s, img, issued, accum = pool
    stream = img is None
    defer = op == "flush" or (op == "extend" and bool(s.pending.any()))
    kw = {"defer": defer} if op == "extend" else {}
    if op == "refill":
        kw.update(issued=issued)
    if not stream:
        kw.update(image_id=img)
    if op != "refill":
        kw.update(accum=accum.clone())

    def args():
        return {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}

    got = fam.run_body(ctx, op, fam.own(s), **args())
    taps = []
    want = fam.plain_body(ctx, op, fam.own(s), taps=taps, **args())
    names = fam.LANE_FIELDS if stream else fam.PATH_FIELDS
    err, bad = 0.0, []
    for n in names:
        x, y = lane_field(got[0], n), lane_field(want[0], n)
        if x.dtype == torch.float32:
            fin = torch.isfinite(x) & torch.isfinite(y)
            if bool(fin.any()):
                err = max(err, float((x - y)[fin].abs().max()))
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(n)
    if op == "refill":
        bad += [] if torch.equal(got[1], want[1]) else ["image_id"]
        bad += [] if int(got[2]) == int(want[2]) else ["paths_issued"]
    check(not bad, f"phase 25, {op} at {width} lanes: the kernel differs "
          f"from the eager function in {bad}")
    n_bytes = fam.family_bytes(ctx, taps)
    bound, bound_by = bound_ms(n_bytes)
    src = fam.own(s)
    out = fam.own(s)
    fixed = args()
    ms = graph_ms([lambda: fam.run_body(ctx, op, src, out=out, **fixed)]
                  * GRAPH_CALLS)
    plain = cuda_ms(lambda: fam.plain_body(ctx, op, fam.own(s), **args()),
                    reps=3, warmup=1)
    alive = int(torch.count_nonzero(s.pending if op == "flush" else
                                    s.alive))
    log(f"[25] {label or op:6s} {width:6d} lanes ({alive} "
        f"{'pending' if op == 'flush' else 'alive'}): kernel "
        f"{ms * 1e3:8.2f} us per evaluation, eager {plain:8.3f} ms; bound "
        f"{n_bytes} B = {bound * 1e3:.3f} us ({bound / ms:.1%}); bit-equal; "
        f"card {card}")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "bytes": n_bytes, "alive": alive,
            "max_abs_err": err}


def fastq_differs(a, b) -> list:
    """The lane fields and counters of two fastQ states that differ bit for
    bit."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import fastqbody as fqb
    from cudavolumerenderer_tpu_torch.ops.stages import lane_field

    bad = []
    for n in (*fqb.LANE_FIELDS, "paths_issued", "n_rays", "n_iters",
              "n_busy"):
        x = lane_field(a, n) if n in fqb.LANE_FIELDS else getattr(a, n)
        y = lane_field(b, n) if n in fqb.LANE_FIELDS else getattr(b, n)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(n)
    return bad


def fastq_pool(ctx, width: int, its=None):
    """Phase 25's kept fastQ state of `width` lanes on phase 11's scene, its
    queue starting at the image's middle rows (its top rows miss the
    medium), after `its` eager iterations, or (None) once every path is
    issued: (state, the next iteration, the image)."""
    import torch

    from cudavolumerenderer_tpu_torch.models import fastq

    dev = torch.device("cuda")
    s = fastq.initial_state(width, ctx.seed, dev)
    s = s._replace(paths_issued=torch.tensor(
        max(0, ctx.n_paths // 2 - width // 2), device=dev))
    accum = torch.zeros((ctx.tile_dim[0] * ctx.tile_dim[1], 3), device=dev)
    it = 0
    while (it < its) if its is not None else (
            int(s.paths_issued) < ctx.n_paths):
        s = fastq.plain_body(ctx, s, accum, it)
        it += 1
    return s, it, accum


def fastq_entry(ctx, s, it: int, accum, card: str, width: int,
                tag: str) -> dict:
    """Phase 25, one fastQ iteration on a kept state: body_kernel against
    the eager body (every lane field and counter bit for bit, the image
    within 1e-5), the kernel's device time per iteration over graph
    replays of 16 out-of-place launches, the eager body's (its input's
    copy included) and the byte bound (fastq_bytes over its taps)."""
    import torch

    from cudavolumerenderer_tpu_torch.models import fastq
    from cudavolumerenderer_tpu_torch.ops import fastqbody as fqb

    own = fqb.own
    a_acc, b_acc = accum.clone(), accum.clone()
    got = fqb.run_body(ctx, own(s), a_acc, it)
    taps = []
    want = fastq.plain_body(ctx, own(s), b_acc, it, taps=taps)
    bad = fastq_differs(got, want)
    check(not bad and torch.allclose(a_acc, b_acc, rtol=1e-5, atol=1e-6),
          f"phase 25, fastQ {tag} at {width} lanes: the kernel differs from "
          f"the eager body in {bad}")
    n_bytes = fqb.fastq_bytes(ctx, taps)
    bound, bound_by = bound_ms(n_bytes)
    # the launch's tensors, kept alive while the graph replays it
    src, out, acc = own(s), own(s), accum.clone()
    counts = torch.stack([s.n_rays, s.n_iters, s.n_busy])
    issued_out = torch.empty((), dtype=torch.int64, device="cuda")
    counts_out = torch.empty(3, device="cuda")
    prep = fqb.KERNEL.prepare(ctx, src, acc, counts, out=out, it=it,
                              issued_out=issued_out, counts_out=counts_out)
    dev = torch.device("cuda")
    ms = graph_ms([lambda: fqb.KERNEL.launch_one(prep.args, dev)]
                  * GRAPH_CALLS)
    plain = cuda_ms(lambda: fastq.plain_body(ctx, own(s), accum.clone(), it),
                    reps=3, warmup=1)
    alive = int(torch.count_nonzero(s.alive))
    log(f"[25] fastQ {ctx.two_level and 'two-level' or 'one-level'} {tag:6s}"
        f" (iteration {it}) {width:6d} lanes ({alive} alive): kernel "
        f"{ms * 1e3:8.2f} us per iteration, eager {plain:8.3f} ms; bound "
        f"{n_bytes} B = {bound * 1e3:.3f} us ({bound / ms:.1%}); bit-equal; "
        f"card {card}")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "bytes": n_bytes, "alive": alive,
            "max_abs_err": float((a_acc - b_acc).abs().max())}


def fastq_drain_row(ctx, card: str, width: int = FAMILY_WIDTHS[0]) -> dict:
    """Phase 25, fastQ's drain: a `width`-lane state kept where every path
    is issued, drained twice (CUDA events around one launch, each on a
    fresh copy), against the eager loop from there to the end (every lane
    field and counter bit for bit, the loop's wall); the longest lane's
    iterations; the bound over every iteration's taps of the eager loop."""
    import torch

    from cudavolumerenderer_tpu_torch.models import fastq
    from cudavolumerenderer_tpu_torch.ops import fastqbody as fqb
    from cudavolumerenderer_tpu_torch.ops.stages import C_LMAX, C_TOTAL

    s, e0, accum = fastq_pool(ctx, width)
    runs = []
    for _ in range(2):
        got, acc = fqb.own(s), accum.clone()
        counts = torch.stack([got.n_rays, got.n_iters, got.n_busy])
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        words = fqb.KERNEL.drain_stage(ctx, got, acc, counts, e0)
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop))
    got = got._replace(n_rays=counts[0], n_iters=counts[1], n_busy=counts[2])
    want, it, b_acc = fqb.own(s), e0, accum.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while bool(fastq.more(ctx, want)):
        want = fastq.plain_body(ctx, want, b_acc, it)
        it += 1
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad = fastq_differs(got, want)
    check(not bad and words[C_TOTAL] == it and torch.allclose(
        acc, b_acc, rtol=1e-5, atol=1e-6),
          f"phase 25: fastQ's drain differs from the eager loop in {bad} "
          f"(trip count {words[C_TOTAL]} / {it})")
    traffic, t, e = fqb.Traffic(ctx), fqb.own(s), e0
    while bool(fastq.more(ctx, t)):
        taps = []
        t = fastq.plain_body(ctx, t, accum.clone(), e, taps=taps)
        traffic.add(taps)
        e += 1
    n_bytes = traffic.total()
    bound, bound_by = bound_ms(n_bytes)
    ms, length = min(runs), words[C_LMAX] - e0
    log(f"[25] fastQ drain, {width} lanes from iteration {e0}: {runs[0]:.3f} "
        f"and {runs[1]:.3f} ms (one launch each), the longest lane "
        f"{length} iterations, {ms * 1e3 / max(length, 1):.2f} us per "
        f"iteration of it; bit-equal to the eager loop ({plain_ms:.1f} ms "
        f"wall, trip count {it}); bound {n_bytes} B = {bound * 1e3:.3f} us "
        f"({bound / ms:.3%}); card {card}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "bytes": n_bytes, "L": length,
            "ms_runs": runs, "us_per_step": ms * 1e3 / max(length, 1),
            "max_abs_err": float((acc - b_acc).abs().max())}


def family_kernels(xml: str, card: str) -> dict:
    """Phase 25: the family's entry points per evaluation on kept pools of
    phase 11's scene, then naiveSK's drain at 400^2 x 1 against trace's
    eager loop; fastQ's iteration (one- and two-level, a refill and a step)
    and its drain; the bounce under --boundary variable."""
    import torch

    from cudavolumerenderer_tpu_torch.config import Config
    from cudavolumerenderer_tpu_torch.models import naive
    from cudavolumerenderer_tpu_torch.ops import familybody as fam
    from cudavolumerenderer_tpu_torch.ops.stages import lane_field
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene

    cfg = Config(scene_file=xml, iterations=1, resolution=(400, 400),
                 n_tiles=(1, 1))
    scene, camera = load_scene(cfg, device="cuda")
    settings = cfg.settings
    zero = torch.zeros(2, device="cuda")
    ctx = fam.make_context(scene, settings, camera, (400, 400), zero,
                           (400, 400), 400 * 400, cfg.seed, 0)
    rows = {op: {} for op in fam.OPS}
    for width in FAMILY_WIDTHS:
        for op in fam.OPS:
            pool = family_pool(fam, ctx, width, op)
            rows[op][width] = family_entry(fam, ctx, op, pool, card, width)

    # naiveSK's drain: 160,000 lanes, each to its death in one launch
    _, s = naive.start_batch(camera, (400, 400), zero, (400, 400), 1,
                             cfg.seed, 0)
    drains = []
    for _ in range(2):
        pool = fam.own(s)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        got = fam.KERNEL.drain(ctx, pool)
        stop.record()
        torch.cuda.synchronize()
        drains.append(start.elapsed_time(stop))
    length = fam.KERNEL.last_drain["L"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fam.trace(ctx, s, False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bad = []
    for n in fam.PATH_FIELDS:
        x, y = lane_field(got, n), lane_field(want, n)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(n)
    check(not bad and float(got.n_rays) == float(want.n_rays),
          f"phase 25: the drain differs from trace's eager loop in {bad} "
          f"(n_rays {float(got.n_rays):.0f} / {float(want.n_rays):.0f})")
    # the drain's bound: every bounce's taps, in order
    traffic, t, bounces = fam.Traffic(ctx), s, 0
    while bounces < settings.max_path_length and bool(torch.any(t.alive)):
        taps = []
        t, _ = fam.plain_body(ctx, "bounce", t, taps=taps)
        traffic.add(taps)
        bounces += 1
    n_bytes = traffic.total()
    bound, bound_by = bound_ms(n_bytes)
    ms = min(drains)
    log(f"[25] naiveSK drain, 160,000 lanes: {drains[0]:.3f} and "
        f"{drains[1]:.3f} ms (one launch each), longest lane L = {length} "
        f"bounces ({bounces} in the eager loop), {ms * 1e3 / length:.2f} us "
        f"per bounce of it; n_rays {float(got.n_rays):.0f} bit-equal to "
        f"trace's eager loop ({plain_ms:.1f} ms wall); bound {n_bytes} B = "
        f"{bound * 1e3:.3f} us ({bound / ms:.3%}); card {card}")
    check(bounces == length, f"the drain's L = {length}, the loop "
          f"{bounces} bounces")
    drain = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": bound_by, "bytes": n_bytes, "L": length,
             "ms_runs": drains, "us_per_step": ms * 1e3 / length,
             "max_abs_err": 0.0}

    # fastQ: one iteration per width (a refill and a step), then the drain
    from cudavolumerenderer_tpu_torch.models import fastq

    fq = {}
    for two in (False, True):
        fctx = fastq.make_context(scene, camera, settings, (400, 400), zero,
                                  (400, 400), 400 * 400, cfg.seed, 0, two)
        for width in FAMILY_WIDTHS:
            for tag, it in FASTQ_ITS.items():
                s, _, acc = fastq_pool(fctx, width, it)
                fq[two, tag, width] = fastq_entry(fctx, s, it, acc, card,
                                                  width, tag)
        if not two:  # fastQ's default; the card tests drain both
            fq["drain"] = fastq_drain_row(fctx, card)

    # the bounce under the variable boundary (its isosurface march)
    import dataclasses

    vctx = fam.make_context(scene, dataclasses.replace(
        settings, boundary="variable"), camera, (400, 400), zero, (400, 400),
        400 * 400, cfg.seed, 0)
    march = {}
    # the default threshold (1e-8), and a threshold the smoke's edges stay
    # under (LONG_MARCH), whose marches run long while their warps wait
    for width, long in [(w, False) for w in FAMILY_WIDTHS] + [
            (FAMILY_WIDTHS[0], True)]:
        if long:
            vctx = fam.make_context(scene, dataclasses.replace(
                settings, boundary="variable", boundary_threshold=LONG_MARCH),
                camera, (400, 400), zero, (400, 400), 400 * 400, cfg.seed, 0)
        key = f"{width} long" if long else width
        pool = family_pool(fam, vctx, width, "bounce")
        march[key] = row = family_entry(
            fam, vctx, "bounce", pool, card, width,
            label=f"march (threshold {LONG_MARCH})" if long else "march")
        # the same pool through the AABB bounce, and the eager march's
        # iterations (its longest lane's: the loop's count)
        src, out = fam.own(pool[0]), fam.own(pool[0])
        fixed = dict(image_id=pool[1].clone(), accum=pool[3].clone())
        row["aabb_ms"] = graph_ms([lambda: fam.run_body(
            ctx, "bounce", src, out=out, **fixed)] * GRAPH_CALLS)
        row["longest"] = march_iterations(fam, vctx, pool[0])
        log(f"[25] the march's cost at {key} lanes: the bounce "
            f"{row['ms'] * 1e3:.2f} us with it, {row['aabb_ms'] * 1e3:.2f} us "
            f"without on the same pool ({row['ms'] / row['aabb_ms']:.2f}x; the "
            f"AABB pool's {rows['bounce'][width]['ms'] * 1e3:.2f} us), the "
            f"longest march {row['longest']} iterations of six density "
            f"lookups; card {card}")
    return {"rows": rows, "drain": drain, "fastq": fq, "march": march}


def march_iterations(fam, ctx, pool) -> int:
    """The iterations of the eager isosurface march in one plain bounce of
    `pool` (the loop's, which are its longest lane's): the calls of
    gradient_cd less the march's first."""
    from cudavolumerenderer_tpu_torch.ops import gradient

    calls, plain = [0], gradient.gradient_cd

    def counted(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    gradient.gradient_cd = counted
    try:
        fam.plain_body(ctx, "bounce", fam.own(pool))
    finally:
        gradient.gradient_cd = plain
    return calls[0] - 1


FAMILY_DESIGN = {
    "bounce": "one thread per lane and evaluation, the whole Woodcock chain "
              "in registers; the pool's tensors read and written in place; "
              "counts reduced per block and by the last block; regeneration"
              "SK's iterations enqueued in batches behind the refill, each "
              "launch gated on the loop's control words",
    "refill": "1,024 lanes per block (a refill group inside a block, its "
              "all-dead test a ballot); ranks by a block scan and a "
              "decoupled look-back over the blocks in start-ticket order; "
              "a separate gated launch before each bounce or extend",
    "extend": "one thread per lane and step; the StreamState tensors read "
              "and written in place; streamingSK's and sortingSK's "
              "iterations enqueued in gated chains of 8, the Morton sort in "
              "torch between them",
    "flush": "sortingSK's deferred albedo fetches and roulette after each "
             "sort, a mode of the extend kernel",
}


FASTQ_DESIGN = {
    "body": "one thread per lane and iteration; the flush, the refill (a "
            "block scan and a decoupled look-back in start-ticket order, "
            "common.cuh queue_rank, every 4th iteration) and the rest of the "
            "iteration in one launch; the QState tensors read and written in "
            "place; counts by the last block; iterations enqueued in gated "
            "batches while the queue holds paths, the index the stage's "
            "C_EVAL",
    "drain": "once every path is issued, one launch: each lane runs its "
             "iterations to its end in registers, flushing its own pending "
             "result; per-iteration counts by warp-aggregated atomics, "
             "folded in order by the last block",
}


def fastq_lines(family: dict, k: dict, fq2: dict) -> list:
    """The `kernels` JSON entries of csrc/fastqbody.cu: launches from phase
    11's fastQ kernel renders (the main path), the rest from phase 25, and
    phase 28's config-2 renders beside them."""
    source = "cudavolumerenderer_tpu_torch/csrc/fastqbody.cu"
    fq = k["fastq"]
    states = {key: row for key, row in fq.items() if isinstance(key, tuple)}
    head = fq[False, "step", FAMILY_WIDTHS[0]]
    rows = family["rows"]
    walls = {label: {x: rows[label].get(x) for x in (
        "wall", "eager_wall", "passes", "launches", "reads", "eager_reads")}
        for label in FASTQ_LABELS}
    config2 = {x: fq2[x] for x in ("walls", "n_rays", "n_lanes", "body",
                                   "drain", "reads", "passes", "rel_mean",
                                   "rel_rays")}
    d = fq["drain"]
    return [{
        "name": "fastqbody", "route": "cuda", "source": source,
        "replaces": FASTQ_REPLACES["body"],
        "launches": family["launches"]["fastq_body"],
        "max_abs_err": max(r["max_abs_err"] for r in states.values()),
        **{x: head[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "design": FASTQ_DESIGN["body"],
        "per_state": {f"{'two' if two else 'one'}-level {tag} {w}": {
            x: r[x] for x in ("ms", "plain_ms", "bound_ms", "bytes",
                              "alive")} for (two, tag, w), r in
            states.items()},
        "walls_400": walls, "config2_512x4": config2,
    }, {
        "name": "fastqbody_drain", "route": "cuda", "source": source,
        "replaces": FASTQ_REPLACES["drain"],
        "launches": family["launches"]["fastq_drain"],
        **{x: d[x] for x in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "L", "us_per_step", "ms_runs")},
        "library_ms": None, "design": FASTQ_DESIGN["drain"],
    }]


def family_lines(family: dict, k: dict, cli_drains: int) -> list:
    """The `kernels` JSON entries of csrc/familybody.cu: launches from
    phase 11's kernel renders (the main path), the rest from phase 25; the
    bounce under --boundary variable (the march) from phase 11's variable
    rows and phase 25."""
    lines = []
    source = "cudavolumerenderer_tpu_torch/csrc/familybody.cu"
    for op, rows in k["rows"].items():
        head = rows[FAMILY_WIDTHS[0]]
        lines.append({
            "name": f"familybody_{op}", "route": "cuda", "source": source,
            "replaces": FAMILY_REPLACES[op],
            "launches": family["launches"][op],
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            **{x: head[x] for x in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            "library_ms": None, "design": FAMILY_DESIGN[op],
            "per_width": {w: {x: r[x] for x in ("ms", "plain_ms", "bound_ms",
                                                "bytes", "alive")}
                          for w, r in rows.items()},
        })
    d = k["drain"]
    lines.append({
        "name": "familybody_drain", "route": "cuda", "source": source,
        "replaces": "cudavolumerenderer_tpu/models/integrator.py:350",
        "launches": family["launches"]["drain"],
        **{x: d[x] for x in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "L", "us_per_step", "ms_runs")},
        "library_ms": None, "launches_cli": cli_drains,
        "design": "naiveSK's trace in one launch: each lane bounces in "
                  "registers until it dies; its bounce count into a "
                  "histogram, folded into n_rays in order by the last block",
        "walls_400": {label: {x: row.get(x) for x in (
            "wall", "eager_wall", "passes", "launches", "reads",
            "eager_reads")} for label, row in family["rows"].items()
            if label not in FASTQ_LABELS},
    })
    march, var = k["march"], family["variable"]
    head = march[FAMILY_WIDTHS[0]]
    lines.append({
        "name": "familybody_march", "route": "cuda", "source": source,
        "replaces": FAMILY_REPLACES["march"],
        "launches": sum(var["launches"].values()),
        "max_abs_err": max(r["max_abs_err"] for r in march.values()),
        **{x: head[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "design": "variable_boundary_adjust inside the bounce (bounce_kernel, "
                  "regenerationSK's gated chains, naiveSK's drain): one "
                  "thread marches its lane in registers, up to 4,096 steps of "
                  "a draw and six density lookups; ms is the bounce with it",
        "per_width": {w: {x: r[x] for x in ("ms", "plain_ms", "bound_ms",
                                            "bytes", "alive")}
                      for w, r in march.items()},
        "bounce_without_ms": {w: r["aabb_ms"] for w, r in march.items()},
        "longest_march": {w: r["longest"] for w, r in march.items()},
        "walls_400": {label: {x: row.get(x) for x in (
            "wall", "passes", "launches", "reads", "eager_res", "eager_wall",
            "kernel_wall_at_eager_res", "eager_reads")}
            for label, row in var["rows"].items()},
    })
    return lines


def brick_lines(bslice: dict, bkern: dict) -> list:
    """The `kernels` JSON entries of csrc/brickbody.cu: launches from phase
    8's kernel render (the main path), the rest from phase 26: ms and the
    bound over the 100 profiled rounds of the 160,000-lane render (in
    place, as the render runs them), the plain version's time on the
    state kept at round 100."""
    head = bkern["rows"]["160000"][100]
    prof = bkern["profile"]
    k = bslice["kernels"]
    lines = []
    for op in ("phase_a", "round"):
        lines.append({
            "name": f"brickbody_{op}", "route": "cuda",
            "source": "cudavolumerenderer_tpu_torch/csrc/brickbody.cu",
            "replaces": BRICK_REPLACES[op], "launches": k["launches"][op],
            "max_abs_err": bkern["max_abs_err"],
            **{x: prof[op][x] for x in ("ms", "bound_ms", "bound_by")},
            "plain_ms": head[op]["plain_ms"],
            "library_ms": None, "design": BRICK_DESIGN[op],
            "ms_out_of_place_round_100": head[op]["ms"],
            "sort_ms": prof["sort_ms"],
            "per_state": {f"{label} lanes, round {r}": {
                x: row[op][x] for x in ("ms", "plain_ms", "bound_ms",
                                        "bytes")} | {"sort_ms": row["sort_ms"]}
                for label, rows in bkern["rows"].items()
                for r, row in rows.items()},
            "slice_400": {x: k[x] for x in ("wall", "rounds", "reads",
                                            "sorts", "n_rays", "mrays")},
            "slice_400_eager": {x: bslice["eager"][x] for x in (
                "wall", "rounds", "reads", "track_launches", "mrays")},
            "profile_100_rounds": bkern["profile"],
        })
    return lines


# -- phase 29: render_diff's bounce-lockstep replays (csrc/nestedreplay.cu) ---

# the one-level problem of benchmarks/results_inverse64.json (inverse_256's
# recipe at n 64: medical_volume, 40 blobs, scale 12, albedo 0.6, RR off,
# max_path_length 64, the GGX boundary), the first of its 6 orbit views
# (radius 100, fov 0.8) at InverseConfig's size, 32^2 x 64 spp (65,536 lanes)
NESTED_N, NESTED_VIEWS, NESTED_RES, NESTED_SPP = 64, 6, 32, 64
NESTED_SEED = 12345
#: the nested two-level deterministic pass B (the lockstep against the eager
#: loop) at 32^2 x 8 (8,192 lanes), cut from 64 spp: each index_add_ call
#: under deterministic algorithms sorts its arrays; the one-level lockstep
#: runs at the full 65,536 lanes
NESTED_DET_SPP = 8
NESTED_STEPS = 10  # (b): run_inverse's n_steps, cut from InverseConfig's 200
MULTIHOST_STEPS = 10  # (d): run_multihost --inverse --steps, cut from 100
SCALE100_STEPS = ("2", "1", "1")  # (f): inverse_scale100 --steps, cut from 30 20 15
#: float operations of one tracking step, a lower count for the bound: the
#: flight (log, scale, add), the point and its box coordinates (12), the
#: trilinear lerp's weights and seven lerps (~24; two-level the stochastic
#: tap's ~12), the acceptance test (3)
NESTED_STEP_OPS = {False: 40, True: 28}
NESTED_REPLACES = {
    "one-level": "cudavolumerenderer_tpu/models/differentiable.py:204",
    "two-level": "cudavolumerenderer_tpu/models/differentiable.py:344",
}
NESTED_FIELDS = ("o", "d", "throughput", "radiance", "alive", "rng")
#: the float lane fields, whose largest absolute difference max_abs_err takes
NESTED_FLOATS = ("o", "d", "throughput", "radiance")


def nested_differs(a, b) -> list:
    """The _ReplayState lane fields in which two replays differ."""
    import torch

    return [name for name in NESTED_FIELDS if not torch.equal(
        *(x.rng.state if name == "rng" else getattr(x, name)
          for x in (a, b)))]


def nested_abs_err(lanes=(), cotangents=()) -> float:
    """The largest absolute difference over two replays' float lane fields
    (`lanes`: (got, want) _ReplayState pairs) and over (got, want)
    cotangent pairs."""
    pairs = [(getattr(a, name), getattr(b, name)) for a, b in lanes
             for name in NESTED_FLOATS] + list(cotangents)
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def nested_apart(got, want, sums: bool = True) -> float:
    """The largest per-entry excess over GRAD_RTOL |want| + GRAD_ATOL
    max|want| (<= 0 within tolerance); with `sums`, the sums are held to
    GRAD_SUM of the absolute sum too (not for a constant albedo's one row,
    which the drain adds once and the eager loop once per bounce)."""
    got, want = got.double(), want.double()
    if sums:
        check(abs(float(got.sum() - want.sum()))
              <= GRAD_SUM * float(want.abs().sum()),
              "phase 29: the cotangents' sums disagree")
    largest = float(want.abs().max())
    log(f"[29] cotangents of {want.numel()} entries: the largest |want| "
        f"{largest:.6g} (GRAD_ATOL x it = {GRAD_ATOL * largest:.3g}), the "
        f"largest |got - want| {float((got - want).abs().max()):.3g}")
    return float(((got - want).abs() - GRAD_RTOL * want.abs()
                  - GRAD_ATOL * largest).max())


def nested_problem():
    """(ground-truth grid, albedo, SceneSpec, settings, view, image
    cotangent made with numpy from a seed)."""
    from cudavolumerenderer_tpu_torch.models import differentiable as td
    from cudavolumerenderer_tpu_torch.models import inverse
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

    gt = procedural.medical_volume((NESTED_N,) * 3, n_blobs=40)
    albedo = np.full((1, 1, 1, 4), 0.6, np.float32)
    spec = td.SceneSpec(scale=12.0, max_density=1.0)
    settings = RenderSettings.from_flags(True, russian_roulette=False,
                                         max_path_length=64)
    view = inverse.orbit_camera_specs(
        NESTED_VIEWS, radius=100.0, res=(NESTED_RES, NESTED_RES),
        fov_x_deg=0.8)[0]
    g_img = np.random.RandomState(29).rand(NESTED_RES, NESTED_RES, 3).astype(
        np.float32)
    return gt, albedo, spec, settings, view, g_img


def nested_counts() -> dict:
    from cudavolumerenderer_tpu_torch.ops import nestedreplay as nr

    k = nr.KERNEL
    return {"drain_launches": k.drain_launches, "lockstep_launches": k.launches,
            "reads": k.reads, "plain_passes": k.plain_passes,
            "plain_reads": k.plain_reads}


def nested_replay_run(scene, settings, lanes, record, eager, tables=None,
                      weights=None):
    """One _replay (fused=False) on the card: (state, d_density, d_albedo,
    wall ms with the card synchronised, count deltas)."""
    import torch

    from cudavolumerenderer_tpu_torch.models import differentiable as td

    o0, d0, rng = lanes
    n = o0.shape[0]
    s, g = weights if weights is not None else (
        torch.zeros(n, device="cuda"), torch.zeros((n, 3), device="cuda"))
    dd, da = cotangent_buffers(scene)
    torch.cuda.synchronize()
    before = nested_counts()
    t0 = time.perf_counter()
    out = td._replay(scene, settings, o0, d0, rng, s, g, record, dd, da,
                     tables, fused=False, eager_body=eager)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    after = nested_counts()
    return out, dd, da, wall, {k: after[k] - before[k] for k in after}


def nested_drain_timed(scene, settings, lanes, weights, tables, plain: dict,
                       card: str, tag: str) -> dict:
    """The drain alone on a context built once: CUDA events around one
    launch of pass A and of pass B, in turns (A, B, B, A), its stats (the
    longest lane), torch.profiler's device time of pass B, and the bound
    (nested_bytes over the eager loop's distinct taps, and the operations of
    every lane's steps); `plain` holds the eager loop's walls of both
    passes."""
    import torch

    from cudavolumerenderer_tpu_torch.models import differentiable as td
    from cudavolumerenderer_tpu_torch.ops import nestedreplay as nr

    o0, d0, rng = lanes
    n = o0.shape[0]
    zero_w = (torch.zeros(n, device="cuda"), torch.zeros((n, 3), device="cuda"))
    ctxs = {}
    for record in (False, True):
        dd, da = cotangent_buffers(scene)
        ctxs[record] = td.nested_context(scene, settings, tables, record, dd, da)
    times = {"pass A": [], "pass B": []}
    stats = None
    for record in (False, True, True, False):
        w = weights if record else zero_w
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        end = nr.run(ctxs[record], o0, d0, rng, *w)
        stop.record()
        torch.cuda.synchronize()
        times["pass B" if record else "pass A"].append(start.elapsed_time(stop))
        if not record:
            stats = nr.drain_stats(nr.KERNEL.last_drain)
    _, kernels, busy = device_time(lambda: nr.run(ctxs[True], o0, d0, rng,
                                                  *weights))
    # the plain version's taps for the bound
    taps = nr.DistinctTaps()
    ctxs[True].plain(o0, d0, rng, *weights, taps=taps)
    bound = {}
    two = tables is not None
    n_ops = NESTED_STEP_OPS[two] * stats["steps"]
    for record in (False, True):
        n_bytes = nr.nested_bytes(ctxs[record], taps, o0, d0, rng, end)
        b, by = bound_ms(n_bytes, n_ops)
        bound["pass B" if record else "pass A"] = {
            "bound_ms": b, "bound_by": by, "bytes": n_bytes, "ops": n_ops}
    ms = min(times["pass A"])
    log(f"[29] {tag} drain, {n} lanes: CUDA events around one launch, pass A "
        + " and ".join(f"{t:.3f}" for t in times["pass A"]) + " ms, pass B "
        + " and ".join(f"{t:.3f}" for t in times["pass B"])
        + f" ms (in turns A, B, B, A); pass B under torch.profiler "
        + (f"{busy:.3f} ms of device time in {kernels} kernels" if busy else
           "no device time in the trace")
        + f"; the longest lane {stats['longest_steps']} tracking steps in "
        f"{stats['longest_bounces']} bounces (most bounces "
        f"{stats['max_bounces']}; {stats['steps']} steps, {stats['bounces']} "
        f"bounces over all lanes), {ms * 1e3 / max(stats['longest_steps'], 1):.3f}"
        f" us per step of it; the eager loop {plain['pass A']:.1f} / "
        f"{plain['pass B']:.1f} ms (A / B); bound A "
        f"{bound['pass A']['bytes']} B, {n_ops} ops = "
        f"{bound['pass A']['bound_ms'] * 1e3:.3f} us ({bound['pass A']['bound_by']}"
        f", {bound['pass A']['bound_ms'] / ms:.2%} of the drain), B "
        f"{bound['pass B']['bytes']} B = {bound['pass B']['bound_ms'] * 1e3:.3f}"
        f" us; card {card}")
    return {"ms": ms, "ms_by_pass": times, "device_ms_pass_b": busy,
            "device_kernels_pass_b": kernels, "plain_ms": plain["pass A"],
            "plain_ms_by_pass": plain, "bound_ms": bound["pass A"]["bound_ms"],
            "bound_by": bound["pass A"]["bound_by"], "bound": bound,
            "L": stats["longest_steps"], "L_bounces": stats["longest_bounces"],
            "stats": stats}


def nested_render_diff(problem, eager: bool):
    """render_diff(two_level=False) forward and backward on the card: (image,
    d density, d albedo, all on the host; wall seconds with that copy;
    count deltas)."""
    import torch

    from cudavolumerenderer_tpu_torch.models.differentiable import render_diff

    gt, albedo, spec, settings, view, g_img = problem
    d = torch.tensor(gt, device="cuda", requires_grad=True)
    a = torch.tensor(albedo, device="cuda", requires_grad=True)
    g = torch.tensor(g_img, device="cuda")
    torch.cuda.synchronize()
    before = nested_counts()
    t0 = time.perf_counter()
    img = render_diff(d, a, NESTED_SEED, spec, view, settings,
                      (NESTED_RES, NESTED_RES), NESTED_SPP, False,
                      eager_body=eager)
    img.backward(g)
    out = [x.detach().cpu() for x in (img, d.grad, a.grad)]
    wall = time.perf_counter() - t0
    after = nested_counts()
    return out, wall, {k: after[k] - before[k] for k in after}


def nested_one_level(problem, card: str) -> dict:
    """Phase 29 (a): the one-level replays kernel against eager loop, the
    drain timed and bounded, and render_diff end to end."""
    import torch

    from cudavolumerenderer_tpu_torch.models import differentiable as td
    from cudavolumerenderer_tpu_torch.ops import nestedreplay as nr

    gt, albedo, spec, settings, view, g_img = problem
    scene = spec.build(gt, albedo, "cuda")
    cam = view.build("cuda")
    res = (NESTED_RES, NESTED_RES)
    n, image_id, o0, d0, rng = td._lane_setup(cam, res, NESTED_SPP,
                                              NESTED_SEED)
    lanes = (o0, d0, rng)
    rows = {}
    t_start = time.perf_counter()

    def took(what):
        log(f"[29] (a) {what} done at {time.perf_counter() - t_start:.1f} s")

    ka, *_ = nested_replay_run(scene, settings, lanes, False, False)  # warm
    ka, _, _, wall_ka, cka = nested_replay_run(scene, settings, lanes, False,
                                               False)
    ea, _, _, wall_ea, cea = nested_replay_run(scene, settings, lanes, False,
                                               True)
    diff = nested_differs(ka, ea)
    check(not diff, f"phase 29: pass A through the drain differs from the "
          f"eager loop in {diff}")
    check(bool(ka.radiance.abs().max() > 0), "phase 29: pass A is black")
    g_lane = torch.tensor(g_img, device="cuda").reshape(-1, 3)[image_id] \
        * ka.radiance
    weights = (torch.sum(g_lane, dim=-1), g_lane)
    eb, de, ae, wall_eb, ceb = nested_replay_run(scene, settings, lanes, True,
                                                 True, weights=weights)
    kb, dk, ak, wall_kb, ckb = nested_replay_run(scene, settings, lanes, True,
                                                 False, weights=weights)
    diff = nested_differs(kb, eb)
    check(not diff, f"phase 29: pass B's lanes differ in {diff}")
    err = max(nested_apart(dk, de), nested_apart(ak, ae, sums=False))
    check(err <= 0.0, f"phase 29: pass B's cotangents exceed GRAD_* by {err}")
    abs_err = nested_abs_err([(ka, ea), (kb, eb)], [(dk, de), (ak, ae)])
    # the eager loop's device launches per pass (torch.profiler)
    _, eager_kernels, eager_busy = device_time(
        lambda: nested_replay_run(scene, settings, lanes, False, True))
    _, kernel_kernels, _ = device_time(
        lambda: nested_replay_run(scene, settings, lanes, False, False))
    took("the passes against the eager loop and their profiles")
    rows["passes"] = {
        "pass A": {"kernel_wall_ms": wall_ka, "eager_wall_ms": wall_ea,
                   "kernel": cka, "eager": cea,
                   "kernel_device_kernels": kernel_kernels,
                   "eager_device_kernels": eager_kernels,
                   "eager_device_ms": eager_busy},
        "pass B": {"kernel_wall_ms": wall_kb, "eager_wall_ms": wall_eb,
                   "kernel": ckb, "eager": ceb}}
    for name, row in rows["passes"].items():
        log(f"[29] (a) one-level {name}, {n} lanes: drain {row['kernel_wall_ms']:.2f}"
            f" ms wall ({row['kernel']['drain_launches']} drain launch, "
            f"{row['kernel']['reads']} host reads, {row['kernel']['plain_passes']}"
            f" eager passes), eager loop {row['eager_wall_ms']:.1f} ms "
            f"({row['eager']['plain_reads']} host reads"
            + (f", {row['eager_device_kernels']} device kernels against the "
               f"drain path's {row['kernel_device_kernels']}"
               if "eager_device_kernels" in row else "")
            + f"); lane fields bit for bit" + (
                f", cotangents within GRAD_* (excess {err:.3g})"
                if name == "pass B" else "") + f"; card {card}")
    rows["drain"] = nested_drain_timed(
        scene, settings, lanes, weights, None,
        {"pass A": wall_ea, "pass B": wall_eb}, card, "(a) one-level")
    took("the drain's timing and bound")
    rows["lockstep"] = nested_deterministic(scene, settings, cam, g_img, None,
                                            card, "(a) one-level", NESTED_SPP)
    took("deterministic pass B")
    # render_diff end to end: the main path, counts from 0
    nr.KERNEL.reset()
    got, wall_k, ck = nested_render_diff(problem, False)
    want, wall_e, ce = nested_render_diff(problem, True)
    check(ck["drain_launches"] == 2 and ck["plain_passes"] == 0
          and ce["plain_passes"] == 2 and ce["drain_launches"] == 0,
          f"phase 29: render_diff's replays: kernel path {ck}, eager {ce}")
    # both forwards run the one naive.render_tile kernel, so the images are
    # not compared; the cotangents come through the replays
    err = max(nested_apart(got[1], want[1]),
              nested_apart(got[2], want[2], sums=False))
    check(err <= 0.0, f"phase 29: render_diff's cotangents exceed GRAD_* by "
          f"{err}")
    abs_err = max(abs_err, nested_abs_err(cotangents=[(got[1], want[1]),
                                                      (got[2], want[2])]))
    check(all(bool(torch.isfinite(x).all()) for x in got)
          and got[0].shape == (NESTED_RES, NESTED_RES, 3),
          "phase 29: render_diff's outputs not finite or wrong shape")
    rows["render_diff"] = {"wall_s": wall_k, "eager_wall_s": wall_e,
                           "counts": ck, "eager": ce}
    rows["max_abs_err"] = abs_err
    log(f"[29] (a) render_diff(two_level=False) {NESTED_N}^3, "
        f"{NESTED_RES}^2 x {NESTED_SPP}, forward + backward, the gradients "
        f"copied to the host: {wall_k:.3f} s through the drains "
        f"({ck['drain_launches']} launches, {ck['reads']} host reads, no eager "
        f"pass) against {wall_e:.3f} s through the eager loop "
        f"({ce['plain_reads']} host reads); cotangents within GRAD_* (excess "
        f"{err:.3g}); the largest absolute difference from the eager loop in "
        f"(a)'s lane fields and cotangents {abs_err:.6g}; card {card}")
    return rows


def nested_deterministic(scene, settings, cam, g_img, tables, card: str,
                         tag: str, spp: int) -> dict:
    """Deterministic pass B at 32^2 x spp (the counts set to 0 just before
    the kernel's run): the lockstep against the eager loop, every lane
    field and both cotangents bit for bit; L the longest lane's steps in
    the primal drain on the same lanes."""
    import torch

    from cudavolumerenderer_tpu_torch.models import differentiable as td
    from cudavolumerenderer_tpu_torch.ops import nestedreplay as nr

    res = (NESTED_RES, NESTED_RES)
    n, image_id, o0, d0, rng = td._lane_setup(cam, res, spp, NESTED_SEED)
    lanes = (o0, d0, rng)
    prim, *_ = nested_replay_run(scene, settings, lanes, False, False, tables)
    stats = nr.drain_stats(nr.KERNEL.last_drain)
    g_lane = torch.tensor(g_img, device="cuda").reshape(-1, 3)[image_id] \
        * prim.radiance
    weights = (torch.sum(g_lane, dim=-1), g_lane)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eb, de, ae, wall_e, ce = nested_replay_run(
            scene, settings, lanes, True, True, tables, weights)
        nr.KERNEL.reset()
        kb, dk, ak, wall_k, ck = nested_replay_run(
            scene, settings, lanes, True, False, tables, weights)
    finally:
        torch.use_deterministic_algorithms(was)
    diff = nested_differs(kb, eb)
    check(not diff and torch.equal(dk, de) and torch.equal(ak, ae)
          and ck["lockstep_launches"] > 0 and ck["plain_passes"] == 0,
          f"phase 29, {tag}: deterministic pass B differs from the eager loop "
          f"in {diff} or its cotangents, or ran no lockstep: {ck}")
    abs_err = nested_abs_err([(kb, eb)], [(dk, de), (ak, ae)])
    # the bound of the same pass B: the eager loop's taps, every lane's steps
    dd, da = cotangent_buffers(scene)
    ctx = td.nested_context(scene, settings, tables, True, dd, da)
    taps = nr.DistinctTaps()
    ctx.plain(o0, d0, rng, *weights, taps=taps)
    end = (kb.o, kb.d, kb.throughput, kb.radiance, kb.alive, kb.rng.state)
    n_bytes = nr.nested_bytes(ctx, taps, o0, d0, rng, end)
    bound, bound_by = bound_ms(n_bytes,
                               NESTED_STEP_OPS[tables is not None]
                               * stats["steps"])
    cut = f"; cut from {NESTED_SPP} spp" if spp < NESTED_SPP else ""
    log(f"[29] {tag} deterministic pass B at {res[0]}^2 x {spp} "
        f"({n} lanes{cut}): lockstep {wall_k:.1f} ms "
        f"wall ({ck['lockstep_launches']} launches, {ck['reads']} host reads)"
        f", eager loop {wall_e:.1f} ms ({ce['plain_reads']} host reads); every "
        f"lane field and both cotangents bit for bit (largest absolute "
        f"difference {abs_err:.6g}); the longest lane {stats['longest_steps']}"
        f" tracking steps in {stats['longest_bounces']} bounces; bound "
        f"{n_bytes} B = {bound * 1e3:.3f} us ({bound_by}); card {card}")
    return {"lanes": n, "wall_ms": wall_k, "eager_wall_ms": wall_e,
            "counts": ck, "eager": ce, "bound_ms": bound,
            "bound_by": bound_by, "bytes": n_bytes, "max_abs_err": abs_err,
            "L": stats["longest_steps"],
            "L_bounces": stats["longest_bounces"]}


def nested_run_inverse(problem, card: str) -> dict:
    """Phase 29 (b): run_inverse at InverseConfig's defaults (one-level, 32^2
    x 64, lr 0.5) on (a)'s problem, n_steps cut to NESTED_STEPS, from a
    0.25 grid toward a 64-spp fastSK target of the ground truth."""
    import torch

    from cudavolumerenderer_tpu_torch.models import inverse
    from cudavolumerenderer_tpu_torch.ops import nestedreplay as nr

    gt, albedo, spec, settings, view, _ = problem
    res = (NESTED_RES, NESTED_RES)
    target = inverse.render_view_targets(gt, albedo, spec, [view], settings,
                                         res, 64, True, device="cuda")[0]
    config = inverse.InverseConfig(n_steps=NESTED_STEPS)
    check(not config.two_level and config.resolution == res
          and config.spp == NESTED_SPP, f"InverseConfig's defaults: {config}")
    stamps = []

    def progress(step, loss):
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    nr.KERNEL.reset()
    t0 = time.perf_counter()
    density, _, losses = inverse.run_inverse(
        target, np.full(gt.shape, 0.25, np.float32), albedo, spec, view,
        settings, config, progress=progress, device="cuda")
    wall = time.perf_counter() - t0
    counts = nested_counts()
    steps = np.diff([t0] + stamps)
    check(counts["drain_launches"] == 2 * NESTED_STEPS
          and counts["plain_passes"] == 0,
          f"phase 29: run_inverse's replays: {counts}")
    check(len(losses) == NESTED_STEPS and np.isfinite(losses).all()
          and bool(torch.isfinite(density).all()),
          f"phase 29: run_inverse's losses {losses}")
    log(f"[29] (b) run_inverse at InverseConfig's defaults, n_steps cut from "
        f"200 to {NESTED_STEPS}: {wall:.3f} s, seconds per step "
        + ", ".join(f"{s:.4f}" for s in steps) + "; losses "
        + ", ".join(f"{l:.6f}" for l in losses)
        + f"; {counts['drain_launches']} drain launches (pass A and B per "
        f"step), {counts['reads']} kernel host reads, no eager pass; card "
        f"{card}")
    return {"wall_s": wall, "step_s": steps.tolist(), "losses": losses,
            "counts": counts}


def nested_two_level(problem, card: str) -> dict:
    """Phase 29 (c): the nested two-level replay (fused=False) through the
    kernels against the eager loop on (a)'s problem (pass A, pass B with
    atomics, deterministic pass B), its drain timed; then on phase 23's
    256^3 problem the nested kernels against the fused replay kernels."""
    import torch

    from cudavolumerenderer_tpu_torch.models import differentiable as td
    from cudavolumerenderer_tpu_torch.ops import nestedreplay as nr

    gt, albedo, spec, settings, view, g_img = problem
    scene = spec.build(gt, albedo, "cuda")
    cam = view.build("cuda")
    res = (NESTED_RES, NESTED_RES)
    n, image_id, o0, d0, rng = td._lane_setup(cam, res, NESTED_SPP,
                                              NESTED_SEED)
    lanes = (o0, d0, rng)
    tables = td._build_brick_tab(scene.medium.density.data)
    nr.KERNEL.reset()
    ka, _, _, wall_ka, cka = nested_replay_run(scene, settings, lanes, False,
                                               False, tables)
    ea, _, _, wall_ea, cea = nested_replay_run(scene, settings, lanes, False,
                                               True, tables)
    diff = nested_differs(ka, ea)
    check(not diff, f"phase 29: the nested two-level pass A differs in {diff}")
    g_lane = torch.tensor(g_img, device="cuda").reshape(-1, 3)[image_id] \
        * ka.radiance
    weights = (torch.sum(g_lane, dim=-1), g_lane)
    eb, de, ae, wall_eb, ceb = nested_replay_run(scene, settings, lanes, True,
                                                 True, tables, weights)
    kb, dk, ak, wall_kb, ckb = nested_replay_run(scene, settings, lanes, True,
                                                 False, tables, weights)
    launches = nr.KERNEL.drain_launches
    diff = nested_differs(kb, eb)
    err = max(nested_apart(dk, de), nested_apart(ak, ae, sums=False))
    check(not diff and err <= 0.0, f"phase 29: the nested two-level pass B "
          f"differs in {diff} or its cotangents by {err}")
    abs_err = nested_abs_err([(ka, ea), (kb, eb)], [(dk, de), (ak, ae)])
    log(f"[29] (c) nested two-level replay, {n} lanes: pass A drain "
        f"{wall_ka:.2f} ms / eager {wall_ea:.1f} ms ({cea['plain_reads']} "
        f"host reads), pass B drain {wall_kb:.2f} ms / eager {wall_eb:.1f} ms"
        f" ({ceb['plain_reads']} reads); every lane field bit for bit, "
        f"cotangents within GRAD_* (excess {err:.3g}; the largest absolute "
        f"difference {abs_err:.6g}); card {card}")
    det = nested_deterministic(scene, settings, cam, g_img, tables, card,
                               "(c) nested two-level", NESTED_DET_SPP)
    drain = nested_drain_timed(
        scene, settings, lanes, weights, tables,
        {"pass A": wall_ea, "pass B": wall_eb}, card, "(c) nested two-level")
    # phase 23's 256^3 problem: nested kernels against the fused kernels
    big = replay_problem(card)
    bscene, bsettings, btables, bo0, bd0, brng, bs, bg = big
    outs = {}
    for fused in (False, True):
        dd, da = cotangent_buffers(bscene)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = td._replay(bscene, bsettings, bo0, bd0, brng, bs, bg, True, dd,
                         da, btables, fused=fused)
        torch.cuda.synchronize()
        outs[fused] = (out, dd, da, (time.perf_counter() - t0) * 1e3)
    (nest, ndd, nda, nwall), (fus, fdd, fda, fwall) = outs[False], outs[True]
    check(torch.equal(nest.radiance, fus.radiance)
          and torch.equal(nest.throughput, fus.throughput),
          "phase 29: the nested replay's radiance differs from the fused's")
    err256 = max(nested_apart(ndd, fdd), nested_apart(nda, fda, sums=False))
    check(err256 <= 0.0, f"phase 29: nested and fused cotangents at 256^3 "
          f"exceed GRAD_* by {err256}")
    log(f"[29] (c) 256^3 (phase 23's problem, {bo0.shape[0]} lanes), pass B: "
        f"the nested two-level drain {nwall:.2f} ms wall against the fused "
        f"replay's kernels {fwall:.2f} ms; radiance and throughput bit-equal, "
        f"cotangents within GRAD_* (excess {err256:.3g}); card {card}")
    return {"launches": launches, "drain": drain, "max_abs_err": abs_err,
            "walls_ms": {"pass A": [wall_ka, wall_ea],
                         "pass B": [wall_kb, wall_eb]},
            "deterministic": det,
            "at_256": {"nested_ms": nwall, "fused_ms": fwall,
                       "excess": err256}}


def nested_multihost(tmp: str, card: str) -> dict:
    """Phase 29 (d): scripts/run_multihost.py on one NCCL rank: render mode
    at its defaults (512^2 x 32) on BASELINE config 1's bucky 32^3 RAW, then
    --inverse on that image at the same resolution and spp with --steps
    cut to MULTIHOST_STEPS, each step timed."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import nestedreplay as nr
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scripts import run_multihost as rm

    raw = os.path.join(tmp, "bucky_synth.raw")
    procedural.write_raw_uchar(raw, procedural.blob_volume((32, 32, 32)))
    prefix = os.path.join(tmp, "multihost")
    t0 = time.perf_counter()
    check(rm.main([raw, "-o", prefix]) == 0, "run_multihost render failed")
    render_s = time.perf_counter() - t0
    step_s = []
    orig = rm.make_inverse_step

    def timed_factory(*args, **kw):
        step = orig(*args, **kw)

        def timed(*a):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            return out

        return timed

    rm.make_inverse_step = timed_factory
    nr.KERNEL.reset()
    try:
        t0 = time.perf_counter()
        check(rm.main([raw, "--inverse", prefix + ".hdr", "--steps",
                       str(MULTIHOST_STEPS), "-o", prefix]) == 0,
              "run_multihost --inverse failed")
        wall = time.perf_counter() - t0
    finally:
        rm.make_inverse_step = orig
    counts = nested_counts()
    rec = np.load(prefix + "_recovered.npz")["density"]
    check(counts["drain_launches"] == 2 * MULTIHOST_STEPS
          and counts["plain_passes"] == 0 and len(step_s) == MULTIHOST_STEPS,
          f"phase 29: run_multihost --inverse's replays: {counts}")
    check(rec.shape == (32, 32, 32) and np.isfinite(rec).all(),
          "phase 29: run_multihost's recovered density")
    log(f"[29] (d) run_multihost on one NCCL rank: render 512^2 x 32 "
        f"{render_s:.2f} s; --inverse at 512^2 x 32 (8,388,608 lanes a pass), "
        f"--steps cut from 100 to {MULTIHOST_STEPS}: {wall:.2f} s, seconds "
        "per step " + ", ".join(f"{s:.3f}" for s in step_s)
        + f"; {counts['drain_launches']} drain launches, {counts['reads']} "
        f"kernel host reads, no eager pass; card {card}")
    return {"render_s": render_s, "step_s": step_s, "wall_s": wall,
            "counts": counts}


def nested_scale100(card: str) -> dict:
    """Phase 29 (f): benchmarks/inverse_scale100 at its defaults but for
    --steps, cut to SCALE100_STEPS."""
    from cudavolumerenderer_tpu_torch.benchmarks import inverse_scale100

    t0 = time.perf_counter()
    res = inverse_scale100.main(["--steps", *SCALE100_STEPS])
    wall = time.perf_counter() - t0
    split = res["observability_split"]
    check(res["platform"] == "cuda" and np.isfinite(res["loss_last"])
          and "shell" in split and "interior" in split,
          f"phase 29: inverse_scale100 {res}")
    log(f"[29] (f) inverse_scale100 at its defaults, --steps cut from 30 20 "
        f"15 to {' '.join(SCALE100_STEPS)}: {wall:.1f} s, loss "
        f"{res['loss_first']} -> {res['loss_last']}, grid_mse_ratio_overall "
        f"{res['grid_mse_ratio_overall']}, shell "
        f"{split['shell'].get('mse_ratio')}, interior "
        f"{split['interior'].get('mse_ratio')}; card {card}")
    return res


def nested_replays(card: str) -> dict:
    """Phase 29: (a)-(d) and (f) above; (e), the kernels line's entries, is
    nested_lines."""
    problem = nested_problem()
    out = {}
    for key, fn in (("one_level", lambda: nested_one_level(problem, card)),
                    ("run_inverse", lambda: nested_run_inverse(problem, card)),
                    ("two_level", lambda: nested_two_level(problem, card))):
        t0 = time.perf_counter()
        out[key] = fn()
        log(f"[29] {key} took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["multihost"] = nested_multihost(tmp, card)
        log(f"[29] multihost took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["scale100"] = nested_scale100(card)
    log(f"[29] scale100 took {time.perf_counter() - t0:.1f} s")
    return out


def nested_lines(nested: dict) -> list:
    """The kernels line's entries of csrc/nestedreplay.cu: launches from the
    main path's runs (render_diff one-level fwd + bwd, run_inverse,
    run_multihost --inverse; the nested two-level from (c); the lockstep
    from (a)'s deterministic render_diff), the rest from phase 29."""
    one, two = nested["one_level"], nested["two_level"]
    rd = one["render_diff"]
    common = {"route": "cuda",
              "source": "cudavolumerenderer_tpu_torch/csrc/nestedreplay.cu",
              "library_ms": None}

    def drain_keys(d):
        return {k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "L", "L_bounces", "ms_by_pass",
                                  "plain_ms_by_pass", "device_ms_pass_b",
                                  "bound")}

    return [{
        "name": "nestedreplay_drain", **common,
        "replaces": NESTED_REPLACES["one-level"],
        "launches": (rd["counts"]["drain_launches"]
                     + nested["run_inverse"]["counts"]["drain_launches"]
                     + nested["multihost"]["counts"]["drain_launches"]),
        "max_abs_err": one["max_abs_err"], **drain_keys(one["drain"]),
        "design": "the one-level replay in one launch: each lane runs its "
                  "bounces to its end in registers (slab test, Woodcock "
                  "chain under the global majorant, GGX or HG event, RR); "
                  "pass B's adjoints by atomics, a constant albedo summed "
                  "in double per block and added once",
        "passes": one["passes"], "render_diff": rd,
        "run_inverse": nested["run_inverse"],
        "run_multihost": nested["multihost"],
    }, {
        "name": "nestedreplay_drain_2l", **common,
        "replaces": NESTED_REPLACES["two-level"],
        "launches": two["launches"], "max_abs_err": two["max_abs_err"],
        **drain_keys(two["drain"]),
        "design": "the nested two-level replay in one launch: common.cuh's "
                  "track_step_2l (shared with replaybody.cu) per step, one "
                  "tap per score",
        "walls_ms": two["walls_ms"], "at_256": two["at_256"],
    }, {
        "name": "nestedreplay_lockstep", **common,
        "replaces": NESTED_REPLACES["one-level"],
        "launches": one["lockstep"]["counts"]["lockstep_launches"],
        "max_abs_err": max(one["lockstep"]["max_abs_err"],
                           two["deterministic"]["max_abs_err"]),
        "ms": one["lockstep"]["wall_ms"],
        "plain_ms": one["lockstep"]["eager_wall_ms"],
        "bound_ms": one["lockstep"]["bound_ms"],
        "bound_by": one["lockstep"]["bound_by"],
        "L": one["lockstep"]["L"], "L_bounces": one["lockstep"]["L_bounces"],
        "lanes": one["lockstep"]["lanes"],
        "timing": "wall of the one-level deterministic pass B at 32^2 x 64 "
                  "with the card synchronised (its index_add_ calls "
                  "included), not device time; plain_ms the eager loop's, "
                  "bound_ms that pass's; max_abs_err over it and (c)'s "
                  "two-level one",
        "design": "pass B under deterministic algorithms: per bounce a start "
                  "launch, a launch per chain of 4 steps writing the eager "
                  "loop's (index, value) arrays, an end launch; index_add_ "
                  "in the eager order",
        "counts": one["lockstep"]["counts"],
    }]


# phases 30-41: the measurement drivers (cudavolumerenderer_tpu_torch/
# benchmarks), each main at its published size: (phase, module, argv)
DRIVERS = (
    (30, "run_suite", []),
    (31, "run_suite", ["--tiling"]),
    (32, "micro_classes", []),
    (33, "micro_stats", []),
    (34, "micro_ablate", []),
    (34, "micro_ablate", ["--regen-levels"]),
    (35, "micro_driver_overhead", []),
    (36, "micro_medical", []),
    (37, "micro_medical2", []),
    (38, "micro_smoke2", []),
    (39, "micro_bucky_r5", []),
    (40, "micro_config3", []),
    (41, "micro_smoke_brick", []),
)
#: the drivers whose JAX scripts only print (no --out)
PRINT_ONLY = ("micro_classes", "micro_stats", "micro_ablate",
              "micro_driver_overhead", "micro_medical")
#: run_suite's integrator-family rows, which trace the same paths
SUITE_FAMILY = ("naiveSK", "regenerationSK", "streamingSK")


def driver_rows(out: dict, path: str = ""):
    """(name, row) for every row of a driver's result: the dicts that carry
    the kernels' counts (scene_classes.RowCounts)."""
    for key, value in out.items():
        if isinstance(value, dict):
            name = f"{path}/{key}" if path else str(key)
            if "eager" in value:
                yield name, value
            else:
                yield from driver_rows(value, name)


def family_rays(phase: int, scene: str, out: dict) -> None:
    """run_suite's family rows of one scene trace the same paths:
    regenerationSK and streamingSK the same n_rays exactly, and naiveSK
    too unless its trace hit max_path_length (the JAX package's
    integrator.trace bounds the wavefront at max_path_length bounces,
    integrator.py:344; the queue-fed schedulers bound no path), when it
    traces fewer."""
    from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

    rows = {k: out[f"{scene}/{k}"] for k in SUITE_FAMILY}
    rays = {k: r["n_rays"] for k, r in rows.items()}
    check(rays["regenerationSK"] == rays["streamingSK"],
          f"[{phase}] {scene}: the family's rows traced {rays}")
    cap = RenderSettings().max_path_length
    longest = rows["naiveSK"]["family_longest_lane"]
    capped = longest is not None and longest >= cap
    check(rays["naiveSK"] == rays["streamingSK"]
          or (capped and rays["naiveSK"] < rays["streamingSK"]),
          f"[{phase}] {scene}: the family's rows traced {rays}, naiveSK's "
          f"longest lane {longest} bounces")
    log(f"[{phase}] {scene}: the family's rows trace {rays} rays; naiveSK's "
        f"longest lane {longest} bounces"
        + (f" (its trace stops at max_path_length {cap}: "
           f"{rays['streamingSK'] - rays['naiveSK']:.0f} rays fewer)"
           if capped else ""))


def all_keys(d) -> set:
    keys = set()
    for k, v in d.items():
        keys.add(k)
        if isinstance(v, dict):
            keys |= all_keys(v)
    return keys


def driver_phase(phase: int, module: str, argv: list, tmp: str,
                 card: str) -> dict:
    """One driver's main at its published size: its JSON keys; every row
    through its kernels (its counts set to 0 before the row and read after
    it: a launch of the row's body kernel, the tail stage's drain where the
    row opens the tail kernel's gate, no eager evaluation and no launch of
    the eager loops' tail or tracking kernels); run_suite's family rows of
    one scene the same n_rays.  Returns the result and its wall."""
    import importlib

    mod = importlib.import_module(
        f"cudavolumerenderer_tpu_torch.benchmarks.{module}")
    tag = " ".join([module, *argv])
    out_path = os.path.join(tmp, f"{module}{phase}.json")
    writes = module not in PRINT_ONLY
    t0 = time.perf_counter()
    out = mod.main([*argv, *(["--out", out_path] if writes else [])])
    wall = time.perf_counter() - t0
    if writes:
        with open(out_path) as f:
            check(json.load(f) == json.loads(json.dumps(out)),
                  f"[{phase}] {tag}: the JSON written differs from main's")
    missing = mod.KEYS[" ".join(argv)] - all_keys(out)
    check(not missing, f"[{phase}] {tag}: keys {missing} missing")
    rows = list(driver_rows(out))
    check(rows, f"[{phase}] {tag}: no rows")
    for name, row in rows:
        launched = {k: row[k] for k in row["kernels"]}
        check(launched and all(launched.values()) and row["eager"] == 0
              and row["tailpk"] == 0 and row["tracking"] == 0,
              f"[{phase}] {tag} {name}: kernels {launched} launched, "
              f"{row['eager']} eager evaluations, tail kernel "
              f"{row['tailpk']}, tracking kernel {row['tracking']}")
    if module == "run_suite" and not argv:
        for scene in sorted({k.split("/")[0] for k in out}):
            family_rays(phase, scene, out)
    if module in ("micro_classes", "micro_medical"):
        affine = {k: v["albedo_affine"] for k, v in out.items()
                  if isinstance(v, dict) and "albedo_affine" in v}
        affine = affine or {"medical": out["albedo_affine"]}
        want = {k: k != "bucky" for k in affine}
        check(affine == want, f"[{phase}] albedo_affine {affine}")
    counts = {k: sum(r[k] for _, r in rows) for k in (
        "fastbody", "familybody", "brickbody", "taildrain", "reads")}
    log(f"[{phase}] {tag} at its published size: {len(rows)} rows, every "
        f"row through its kernels, none eager ({counts}); {wall:.1f} s; "
        f"card {card}")
    for name, row in rows:
        times = row.get("times_s") or [row.get("time_s", row.get("time"))]
        log(f"[{phase}]   {name}: wall {min(times):.4f} s, n_rays "
            f"{row.get('n_rays', row.get('rays'))}, fastbody "
            f"{row['fastbody']}, familybody {row['familybody']}, brickbody "
            f"{row['brickbody']}, taildrain {row['taildrain']}, host reads "
            f"{row['reads']}")
    return {"out": out, "wall": wall}


def driver_overhead_device(card: str, walls: list) -> dict:
    """Phase 35's direct render (bucky, 256^2 x 20, fastSK two-level) once
    more under torch.profiler, started before the clock: its device
    kernels and busy ms against its wall, beside the phase's direct walls
    `walls`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cudavolumerenderer_tpu_torch.benchmarks import scene_classes as sc
    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

    scene = sc.scene("bucky", "cuda")
    res, iters = sc.size("bucky")
    cam = sc.camera(res, "cuda")
    off = torch.zeros(2, device="cuda")

    def direct(seed):
        _, nr = fast.render_tile(scene, cam, RenderSettings.from_flags(True),
                                 (res, res), off, (res, res), iters, seed, 0,
                                 two_level=True)
        return float(nr)

    direct(4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct(5)
        wall = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    kernels = sum(e.count for e in on_card)
    log(f"[35] the direct render under torch.profiler: {kernels} device "
        f"kernels, device busy {busy:.3f} ms of {wall:.2f} ms wall (the "
        f"phase's direct walls {[round(w * 1e3, 2) for w in walls]} ms); "
        f"card {card}")
    return {"device_kernels": kernels, "busy_ms": busy, "wall_ms": wall}


def driver_total(driven: dict, kernel: str) -> int:
    """A kernel's launches summed over every driver row of phases 30-41."""
    return sum(row[kernel] for d in driven.values()
               for _, row in driver_rows(d["out"]))


def drivers(card: str) -> dict:
    """Phases 30-41: every driver's main at its published size."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for phase, module, argv in DRIVERS:
            tag = " ".join([module, *argv])
            out[tag] = driver_phase(phase, module, argv, tmp, card)
            if module == "micro_driver_overhead":
                out[tag]["device"] = driver_overhead_device(
                    card, out[tag]["out"]["direct"]["times_s"])
    return out


def main() -> int:
    import torch

    # -- phase 1: the card --------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sqrt_on_card()
    torch_ops_on_card()

    from cudavolumerenderer_tpu_torch import cli
    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models import brick, fast
    from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
    from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as mpg
    from cudavolumerenderer_tpu_torch.ops import brickbody as bk
    from cudavolumerenderer_tpu_torch.ops import familybody as fam
    from cudavolumerenderer_tpu_torch.ops import fastbody as fb
    from cudavolumerenderer_tpu_torch.ops import fastqbody as fqb
    from cudavolumerenderer_tpu_torch.ops import nestedreplay as nr
    from cudavolumerenderer_tpu_torch.ops import pgather as pg
    from cudavolumerenderer_tpu_torch.ops import replaybody as rb
    from cudavolumerenderer_tpu_torch.ops import taildrain as td
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk
    from cudavolumerenderer_tpu_torch.ops import tracking as tk
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene
    from cudavolumerenderer_tpu_torch.utils.image import load_hdr

    # -- phase 2: build the nine libraries, one nvcc each, started together,
    # and the native data-path library (g++) beside them
    from cudavolumerenderer_tpu_torch.utils import native

    libraries = (tpk.KERNEL, tk.KERNEL, pg.LIBRARY, fb.KERNEL, rb.KERNEL,
                 fam.KERNEL, bk.KERNEL, fqb.KERNEL, nr.KERNEL)
    with ThreadPoolExecutor(len(libraries) + 1) as pool:
        native_build = pool.submit(native.load)
        builds = [pool.submit(k.library) for k in libraries]
        builds = [b.result() for b in builds]
        native_build.result()
    td.KERNEL.library()  # the drain: csrc/tailpk.cu's library, built above
    for built in builds:
        log(f"[2] built {os.path.relpath(built.path)} in {built.seconds:.2f} s")
        for line in built.log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                log(f"[2] ptxas: {line.strip()}")
    drain_ptxas = ptxas_of(builds[0].log, "drain_kernel")
    log(f"[2] the tail stage's drain_kernel (csrc/tailpk.cu): {drain_ptxas}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cfg = Config(
            scene_file=write_medical_mhd(tmp), kernel=Kernel.FAST_SK,
            two_level=True, tail_pallas=True, resolution=(512, 512),
            iterations=4, n_tiles=(1, 1),
        )
        scene, camera = load_scene(cfg, device="cuda")
        log(f"[5] medical scene written and loaded in "
            f"{time.perf_counter() - t0:.1f} s; albedo mode "
            f"{fast._albedo_mode(scene)}")

    # -- phase 3: kernel against plain version ------------------------------
    tables = tpk.dilated_tail_bricks(scene.medium.density.data)
    params = fast.tail_params(scene, cfg.settings)
    log(f"[3] dilated table {tuple(tables.tab.shape)} "
        f"({tables.tab.numel() * 4 / 1e6:.1f} MB)")
    log(f"[3] tail kernel ptxas: {ptxas_report(builds[0].log)}")
    errs, times = [], {}
    for n_paths in (128, 4096):
        err, *timed = kernel_vs_plain(tables, params, n_paths, card)
        errs.append(err)
        times[n_paths] = timed
    sweep = step_sweep(tables, params, card)

    # -- phase 4: white furnace and card-vs-CPU render ----------------------
    furnace_and_small_render()

    # -- phase 5: the slice -------------------------------------------------
    renderer = create_renderer(scene, camera, cfg)
    slice5 = slice_runs(renderer, card)
    drain5, eager5, img = slice5["drain"], slice5["eager"], slice5["img"]
    slice_ms = slice_round(slice5["round_inputs"], card)
    n_rays, wall = drain5["n_rays"], min(drain5["walls"])
    body_launches, body_reads = drain5["body_launches"], drain5["body_reads"]
    mean = float(img.mean())
    check(img.shape == (512, 512, 3) and np.isfinite(img).all(),
          "slice image not finite or wrong shape")
    check(0.05 < mean < 1.5, f"slice image mean {mean} implausible")
    check(n_rays > 0, "no rays traced")
    check(body_launches > 0, "the slice launched no body kernel")
    log(f"[5] slice 512^2 x 4 through the drain: {wall:.4f} s wall (the "
        f"least of {len(drain5['walls'])}, incl. image copy), {n_rays:.0f} "
        f"rays, {n_rays / wall / 1e6:.4f} Mrays/s, "
        f"{drain5['drain_launches']} drain launch, {body_launches} "
        f"body-kernel launches (gated chains), {body_reads} host reads of "
        f"the pending count, image mean {mean:.5f}; card {card}")
    log(f"[5] n_rays {n_rays:.0f} against {SLICE_RAYS} of the first tail kernel: "
        f"difference {n_rays - SLICE_RAYS:+.0f}")
    check(n_rays == eager5["n_rays"] == SLICE_RAYS,
          f"the slice traced {n_rays:.0f} rays through the drain and "
          f"{eager5['n_rays']:.0f} through the eager loop, not {SLICE_RAYS}")

    # -- phase 28 (run here, on phase 5's scene): fastQ at config 2 ----------
    t0 = time.perf_counter()
    fq2 = fastq_config2(scene, camera, img, n_rays, card)
    log(f"[28] phase 28 took {time.perf_counter() - t0:.1f} s")

    # -- phase 6: tracking kernel against plain version ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        argv = [write_smoke_xml(tmp), "-k", "brickSK", "-i", "4", "-r", "400",
                "400", "--trials", "1", "-o", os.path.join(tmp, "brick_slice")]
        args = cli.build_parser().parse_args(argv)
        bcfg = cli.config_from_args(args)
        dev = cli.device_of(args.platform)
        bscene, bcamera = load_scene(bcfg, device=dev)
        log(f"[6] brickSK smoke scene written and loaded in "
            f"{time.perf_counter() - t0:.1f} s; albedo mode "
            f"{fast._albedo_mode(bscene)}")
        btables, bmajor = tk.build_dilated_bricks(bscene.medium.density.data)
        btables = btables.reshape(-1, tk.ROW)
        log(f"[6] dilated brick table {tuple(btables.shape)}")
        terrs, ttimes = [], {}
        for n_rows, n_steps in ((8, 8), (1250, 8), (8, 32), (1250, 32)):
            err, *timed = track_vs_plain(btables, bmajor, n_rows, n_steps,
                                         card)
            terrs.append(err)
            ttimes[n_rows, n_steps] = timed

        track_cold(btables, bmajor, card)

        # -- phase 7: brickSK white furnace and card-vs-CPU render ---------
        brick_furnace_and_small_render()

        # -- phase 8: the brickSK slice through the CLI --------------------
        t0 = time.perf_counter()
        bslice = brick_slice(bcfg, dev, card)
        log(f"[8] phase 8 took {time.perf_counter() - t0:.1f} s")

        # -- phase 26 (run here, on phase 8's scene): the round kernels ----
        t0 = time.perf_counter()
        bkern = brick_kernels(bscene, bcamera, bcfg, card)
        log(f"[26] phase 26 took {time.perf_counter() - t0:.1f} s")
    del bscene, bcamera

    # -- phase 9: the gather kernels against their plain versions ----------
    t0 = time.perf_counter()
    gtable = torch.from_numpy(
        mpg.make_table(mpg.table_rows(67.0, GATHER_S))).to("cuda")
    log(f"[9] gather table {tuple(gtable.shape)} "
        f"({gtable.numel() * 4 / 2**20:.0f} MB) made in "
        f"{time.perf_counter() - t0:.1f} s")
    gathers = {name: gather_vs_plain(gtable, name, card) for name in pg.NAMES}
    del gtable
    floors = measured_floors(card)
    big = binned_big(card)
    for name, res in (("vmem", gathers["vmem"]), ("binned", gathers["binned"]),
                      ("binned 4.3 GB", big)):
        log(f"[9] {name}: warm {res['ms'] * 1e3:.2f} us, cold "
            f"{res['cold_ms'] * 1e3:.2f} us per call; above the tiny op by "
            f"{(res['ms'] - floors['launch_ms']) * 1e3:.2f} us and above the "
            f"1 MB copy_ by {(res['ms'] - floors['copy_ms']) * 1e3:.2f} us "
            f"(warm); byte bound {res['bound_ms'] * 1e3:.3f} us, sector floor "
            f"{res['sector_ms'] * 1e3:.3f} us; card {card}")
    log(f"[9] phase 9 took {time.perf_counter() - t0:.1f} s")

    # -- phase 10: the gather benchmark's entry point -----------------------
    with tempfile.TemporaryDirectory() as tmp:
        glaunches = gather_benchmark(tmp, card)

    # -- phases 11-12: the scheduler family on the slice's scene ------------
    with tempfile.TemporaryDirectory() as tmp:
        xml = write_smoke_xml(tmp)
        t0 = time.perf_counter()
        family = family_rows(xml, card)
        check_family(family)
        family_furnace_and_small_renders()
        log(f"[11] phase 11 took {time.perf_counter() - t0:.1f} s")
        cli_drains = naive_cli(xml, tmp, card)
        # -- phase 25 (run here, on phase 11's scene): the family's kernels
        t0 = time.perf_counter()
        family_k = family_kernels(xml, card)
        log(f"[25] phase 25 took {time.perf_counter() - t0:.1f} s")

    # -- phases 13-14: the differentiable path and training ----------------
    t0 = time.perf_counter()
    gradient_on_card()
    log(f"[13] phase 13 took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train = training(tmp, card)
        log(f"[14] phase 14 took {time.perf_counter() - t0:.1f} s")

    # -- phases 15-18: the VDB/NPZ scene path, configs 3 and 4, the modes --
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        vdb_path = native_and_vdb(tmp, card)
        log(f"[15] phase 15 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        config3_launches = config3(vdb_path, tmp, card)
        config1(tmp, card)
        log(f"[16] phase 16 took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        config4(tmp, card)
        log(f"[17] phase 17 took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        interactive_modes(tmp, card)
        log(f"[18] phase 18 took {time.perf_counter() - t0:.1f} s")

    # -- phase 19: config 2 with --champion's packed q4 tables --------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        inline = champion_config2(tmp, card)
        log(f"[19] phase 19 took {time.perf_counter() - t0:.1f} s")

    # -- phase 20: fastSK's options on config 2's scene (phase 5's) ---------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        options = options_config2(tmp, card, scene, camera, inline)
        log(f"[20] phase 20 took {time.perf_counter() - t0:.1f} s")

    # -- phase 21: parallel/ on the card (phase 5's scene and image) -------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sharded_launches = sharded(tmp, card, (img, n_rays), scene, camera,
                                   cfg)
        log(f"[21] phase 21 took {time.perf_counter() - t0:.1f} s")

    # -- phase 22: the body kernel against the eager body on kept states ----
    t0 = time.perf_counter()
    body = body_states(scene, camera, card)
    modes = mode_pools(scene, camera, card)
    log(f"[22] phase 22 took {time.perf_counter() - t0:.1f} s")

    # -- phase 23: the replay kernels against the eager body on kept pools --
    del scene, camera, renderer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    replay = replay_states(card)
    log(f"[23] phase 23 took {time.perf_counter() - t0:.1f} s")

    # -- phase 24: the north-star benchmark, bench_1024 --bwd ---------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    star = north_star(card)
    log(f"[24] phase 24 took {time.perf_counter() - t0:.1f} s")

    # -- phase 27: the tail stage's drain alone, on phase 5's kept state ----
    t0 = time.perf_counter()
    tail = tail_drain_alone(drain5["stage"], eager5["stage"], drain_ptxas,
                            card)
    log(f"[27] phase 27 took {time.perf_counter() - t0:.1f} s")

    # -- phase 29: render_diff's bounce-lockstep replays --------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nested = nested_replays(card)
    log(f"[29] phase 29 took {time.perf_counter() - t0:.1f} s")

    # -- phases 30-41: the measurement drivers at their published sizes ----
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    driven = drivers(card)
    log(f"[30-41] the drivers took {time.perf_counter() - t0:.1f} s")
    log(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s in all")

    def timed(ms, plain_ms, bound, bound_by):
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": None}

    tiled = {"design": TILE_DESIGN, "floor_launch_ms": floors["launch_ms"],
             "floor_copy_ms": floors["copy_ms"]}
    extra = {"taa1": {"design": TAA1_DESIGN}, "vmem": tiled, "binned": {
        **tiled, "ms_4300": big["ms"], "cold_ms_4300": big["cold_ms"],
        "bound_ms_4300": big["bound_ms"], "sector_ms_4300": big["sector_ms"],
        "library_ms_4300": big["library_ms"]}}
    gather_lines = [{
        "name": f"pgather_{name}", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/pgather.cu",
        "replaces": GATHER_REPLACES[name], "launches": glaunches[name],
        **gathers[name], **extra.get(name, {}),
    } for name in pg.NAMES]
    stage5 = drain5["stage"]
    print(json.dumps({"kernels": [{
        "name": "tailpk", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/tailpk.cu",
        "replaces": "cudavolumerenderer_tpu/ops/pallas/tailpk.py:152",
        "launches": eager5["tail_launches"], "max_abs_err": max(errs),
        **timed(*times[128]),
        "design": "one warp per path; rounds that each take a run of null "
                  "collisions or of scatters, a lane per step",
        "launches_path": "phase 5's render with the tail stage's eager loop "
                         "(the drain runs the same run code on the main "
                         "path, where the tail kernel launches 0 times)",
        "ms_r4096": times[4096][0],
        "step_sweep_ms": sweep["ms"], "in_slice_us": eager5["in_slice_us"],
        "slice_round_ms": slice_ms,
    }, {
        "name": "taildrain", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/tailpk.cu",
        "replaces": "cudavolumerenderer_tpu/models/fast.py:1421",
        "launches": drain5["drain_launches"],
        "max_abs_err": drain5["max_abs_err"],
        **{k: tail[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "design": "the tail stage in one launch: a warp per lane of the pool "
                  "runs its rounds to its end (the service computed by every "
                  "thread, the run by the warp); per-round counts by atomics, "
                  "folded in order by the last block",
        **{k: tail[k] for k in ("ms_runs", "bound_bytes", "L", "E",
                                "us_per_round", "ptxas")},
        "host_reads": drain5["reads"], "slice_walls_s": drain5["walls"],
        "slice_wall_eager_s": eager5["walls"][0],
        "stage_walls_ms": [w * 1e3 for w in drain5["stage_walls"]],
        "stage_device_ms": (None if stage5["device_us"] is None
                            else stage5["device_us"] / 1e3),
        "stage_busy": stage5["busy"],
        "launches_config3": config3_launches,
        "launches_sharded": sharded_launches,
        "launches_drivers": driver_total(driven, "taildrain"),
    }, {
        "name": "track", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/tracking.cu",
        "replaces": "cudavolumerenderer_tpu/ops/pallas/tracking.py:123",
        "launches": bslice["eager"]["track_launches"],
        "max_abs_err": max(terrs), **timed(*ttimes[1250, 8]),
        "launches_path": "phase 8's eager_body=True render (the round "
                         "kernel runs its step loop on the main path)",
    }, *brick_lines(bslice, bkern), {
        "name": "fastbody", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/fastbody.cu",
        "replaces": "cudavolumerenderer_tpu/models/fast.py:744",
        "launches": body_launches, "max_abs_err": body["max_abs_err"],
        **{k: body["rows"]["evaluation 20"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "design": "one thread per lane and evaluation; the FastState tensors "
                  "read and written in place; counts reduced per block and by "
                  "the last block; a stage's evaluations enqueued in batches, "
                  "each launch gated on the stage's control words",
        "per_state": body["rows"], "launches_config2": body["launches"],
        "launches_drivers": driver_total(driven, "fastbody"),
        "reads_config2": body["reads"], "walls_config2": body["walls"],
        "enqueue_us_config2": body["enqueue_us"],
        "stages_config2": body["stages"],
    }, {
        "name": "fastbody_drain", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/fastbody.cu",
        "replaces": "cudavolumerenderer_tpu/models/fast.py:744",
        **{k: body["drain"][k] for k in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "L", "E", "threads",
            "us_per_step", "ms_by_threads")},
        "library_ms": None,
        "design": "the last stage without the tail kernel in one launch: each "
                  "lane runs to its end in registers; per-evaluation counts "
                  "by warp-aggregated atomics, folded in order by the last "
                  "block",
    }, *({
        "name": f"fastbody_{mode}", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/fastbody.cu",
        "replaces": MODE_REPLACES[mode],
        "launches": (options["defer"]["by_mode"]["defer"] if mode == "defer"
                     else options["spec"][SPEC_EAGER]["by_mode"]["spec"]),
        "max_abs_err": modes[mode]["max_abs_err"],
        **{k: modes[mode][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")},
        "library_ms": None, "design": MODE_DESIGN[mode],
        "launches_path": ("phase 20's defer_ggx 4 render" if mode == "defer"
                          else f"phase 20's {SPEC_EAGER} render"),
        "pool": modes[mode],
        "rows": (options["defer"] if mode == "defer" else options["spec"]),
        **({"eager_wall_s": options["spec_eager_wall"]} if mode == "spec"
           else {}),
    } for mode in ("spec", "defer")), {
        "name": "replaybody", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/replaybody.cu",
        "replaces": "cudavolumerenderer_tpu/models/differentiable.py:623",
        "launches": train["main_path"]["launches"],
        "max_abs_err": replay["max_abs_err"],
        **{k: replay["head"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "design": "one thread per lane and evaluation; the _Lanes tensors "
                  "read and written in place; pass B's adjoints by atomics "
                  "(a constant albedo reduced per block first), or per-lane "
                  "(index, value) buffers added by index_add_ under "
                  "deterministic algorithms; a stage's evaluations enqueued "
                  "in batches, each launch gated on the stage's control words",
        "per_state": replay["rows"], "stages_256": replay["stages"],
        "walls_256": replay["walls"], "launches_256": replay["launches"],
        "reads_256": replay["reads"], "main_path_256": train["main_path"],
        "training_passes": train["passes"],
        "launches_bench_1024": star["counts"]["launches"],
        "bench_1024": {k: star[k] for k in (
            "best_mrays", "fwd_s", "primal_s", "fwdbwd",
            "max_memory_allocated", "occupancy", "n_rays", "n_rays_bwd",
            "device", "wall_s")},
    }, {
        "name": "replaybody_drain", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/replaybody.cu",
        "replaces": "cudavolumerenderer_tpu/models/differentiable.py:623",
        "launches": train["main_path"]["drain_launches"],
        **{k: replay["drain"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "L",
            "E", "us_per_step", "ms_by_pass")},
        "library_ms": None,
        "design": "the last stage in one launch: each lane runs to its end "
                  "in registers; the longest lane's evaluations give the "
                  "loop's E = k_chain * ceil(L / k_chain)",
        "launches_bench_1024": star["counts"]["drain_launches"],
    }, *family_lines(family, family_k, cli_drains),
        *fastq_lines(family, family_k, fq2), *nested_lines(nested),
        *gather_lines]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
