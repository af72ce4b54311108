#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a host with one CUDA GPU (sm_90a)
    python3 chip_smoke.py --plan-profiles   # only the integer plan calls' profiles
    python3 chip_smoke.py --served          # only the build and phase 8
    python3 chip_smoke.py --train           # only the build and phase 9
    python3 chip_smoke.py --tune            # only the build and phase 10
    python3 chip_smoke.py --families        # only the build and phase 11 (the families)
    python3 chip_smoke.py --mesh            # only the build and phase 12 (multi-device)
    python3 chip_smoke.py --dryrun          # only the build and phase 13, both meshes
    python3 chip_smoke.py --torchrun        # only the build and phase 14 (the launchers)
    python3 chip_smoke.py --examples        # only the build and phase 15 (the examples)

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. the card's name and power limit (nvidia-smi), then the CUDA kernels are
   built from ``src/repro_torch/kernels/csrc`` with nvcc (build time and
   the ptxas register report are printed);
2. every kernel against its plain PyTorch twin on the card: B1 / B2
   (quant_matmul, quant_matmul_int4) at the TFC shapes and ragged ones,
   exact on dyadic inputs and within the summation-order bound
   ``2·K·2^-24·(|x|@|w|)·|s|`` on randn inputs; B4 (quant_dequant) bit-exact
   over every rounding mode, signedness, width, granularity and output kind;
   B5 (quant_grouped_matmul, int8 and int4, per-tensor and per-channel
   scale, with and without bias, ragged M / Kg / Ng, and through the conv
   wrapper's strided view) exact on dyadic inputs and within the order
   bound on randn; B6 (quant_depthwise_conv2d) bit-exact on randn inputs
   (its twin sums the taps in the kernel's order) with no epilogue, ReLU
   only, bias, per-channel scale, act bits {2, 4, 8} in every rounding
   mode, stride 2, asymmetric pads, dilation 2 and channel counts off the
   block, at MobileNet-224 shapes among others.  The boundary glue of
   fusion (``check_glue``): ``maxpool2d_codes``, ``avgpool2d_codes``, the
   float32 pools, ``pack`` / ``unpack_codes_int4``, ``boundary_values``
   and the code recovery on the card ``torch.equal`` to the CPU, at CNV's
   pool shapes, padded and strided windows, both ``count_include_pad``
   values, zero points 0 and not, odd last dims (no packing) and the full
   int8 code range; B4 with ``emit_codes`` at the zoo's act widths.  Then
   the integer bodies
   of B1 / B2 / B5 / B6 (int32 sums, the integer epilogue B3) against their
   twins with ``torch.equal``: every rounding mode, ReLU on and off, the
   act Quant on and off, act_shift -3 / 0 / 5, zero points, signed,
   unsigned and narrow bounds, per-tensor and per-channel multipliers,
   ragged shapes, the int32 body with the float32 epilogue, and sums just
   below 2^24; B2's int8 tensor-core body (``int8_codes=True``) with codes
   over all of int8 at ragged M, N and K and MobileNet pointwise shapes, at
   a power-of-two scale (the reciprocal multiply) and at IN_SCALE (the
   exact-quotient staging), with x off the scale's grid (the division), and
   at its own accumulator limit, each ``torch.equal`` to the twin and to
   the IMAD body, its launches counted per body.  Then the B5 / B6
   redesign's boundaries (``check_redesign``): B6 at DW_GEOMETRIES (planes
   of 1x1, 7x7 and 13x13, C off the planes per block, N = 1, odd H at
   stride 2, asymmetric pads, dilation 2, 5x5 and 1x3 kernels, tiles off
   16 bytes) and every MobileNet-224 depthwise layer at 8 rows, the
   float32 body in every rounding mode and the integer bodies in every
   staging of x (a power-of-two scale: the reciprocal; IN_SCALE: the
   exact-quotient check; x off its grid: the division fallback;
   TINY_SCALE: the division), all ``torch.equal``; B5 at GQ_SHAPES (Ng 1,
   8, 12, 16, 40, Kg off 4 and above the staged slice, int8 and int4) in
   all three bodies and stagings; the per-staging launch counts checked.
   Then the B4 / B1 redesign's boundaries (``check_b4_b1_redesign``): B4
   torch.equal to its twin (NaN as NaN) in every mode, width and output
   kind at the scales of QDQ_SCALES (reciprocals subnormal, overflowing or
   negative; powers of two; 0.37) and a per-channel row mixing them, on
   ±0, ±inf, NaN, subnormals, ties and clip-bound neighbours, on views
   1-3 elements off 16 bytes, at numel 1, 3, 5 and on a tensor larger than
   one grid sweep; B1 / B2's CUDA-core body at every cluster size (1-8)
   and tile (16x64, 64x64, 128x32) its plan chooses, K in {1, 27, 98, 130,
   785} at M in {1, 16} and odd N, and misaligned x views: the float32
   body exact on dyadic x, within the order bound on randn and the same
   bits on a repeated call, the integer bodies torch.equal with B3 in all
   three stagings of x.
   Last B7
   (flash_attention; bf16 on its tensor-core body) against its twin at
   qwen2-1.5B's heads (12 over 2 KV heads, hd 128) and olmo-1B's (16 over
   16), S in {1, 17, 512, 2048, 2047}, B in {1, 4}, causal and not, float32
   (within 2e-5, abs + rel) and bf16 (within one bf16 step, or 2e-5 near
   zero);
3. the main path on the float32-epilogue tier (``use_analysis=False``),
   each graph built by the port's zoo, compiled on CUDA and held against
   the port's oracle on the CPU with the reference's segment census:
   TFC-w2a2 (packed int4: B2 + B4) and TFC-w1a1 with ``use_int4=False``
   (B1 + B4), CNV-w1a1 and CNV-w2a2 (B1, B2, B4), and MobileNet-w4a4 at
   img 224 with 8 rows (B1, B2, B4, B6), all bit-exact.  The zoo's random
   weights let MobileNet's activations quantize to 0 after its fourth
   conv, so the same graph with its conv gains raised by powers of two
   (``zoo.rescale_conv_gains``: same integer weights) runs too, 2 x 8 rows:
   bit-exact through the global average pool, and its final MatMul, whose
   inputs (sums x float32(1/49)) are not dyadic, within the order bound.
   Last a grouped conv (group 8, 64 -> 64 channels, 3x3, 56x56: B5 + B4),
   bit-exact;
4. serving on that tier: a ``CompiledGraphEngine`` answers 64 submitted
   TFC requests and one 40-row batch in 16-row slots, each row bit-exact
   against the oracle on the CPU; a second one serves the rescaled
   MobileNet-w4a4 at img 224 in 8-row slots, 16 submitted requests and one
   ragged 5-row batch, each row bit-exact against the compiled plan's rows
   and within the order bound of the CPU oracle;
3'. + 4'. the same on the integer path, ``compile_graph``'s defaults but
   ``use_fusion=False`` (the analysis tier and B3): TFC-w1a1 / w1a2 / w2a2 (4 of 4 int32 segments),
   CNV-w1a1 / w2a2 (9 of 9), MobileNet-w4a4 at img 224 as the zoo builds it
   and rescaled (27 of 28: the final MatMul stays float32) and the grouped
   conv (B5 on int32), each with the reference's census and
   ``requant_stats()`` and bit-exact against the CPU oracle (MobileNet's
   final MatMul within the order bound); then both engines on integer
   plans (fused: the engines compile with the defaults), with the
   load-time cost report.  B2's launches are counted per
   body around every forward: each launches B2's int8 tensor-core body
   once per segment whose meta chose it, exactly 13 per MobileNet-224
   forward (its pointwise convs; TFC's count is printed); B6's 13
   MobileNet-224 launches must all take the reciprocal staging (the zoo's
   activation scales are powers of two), B5's staging is printed;
3''. the fused main path, ``compile_graph``'s defaults (fusion on), on both
   tiers: all seven ``ZOO`` keys (TFC at 64 rows, CNV at 8, MobileNet-w4a4
   at img 224 with 8 rows as built and rescaled) and the grouped conv,
   each with the reference's fusion census (``CENSUS_FUSION``:
   ``fusion_stats()``, the fusion segments, the ops left interpreted),
   every negotiated boundary an int8 / uint8 tensor on the card and no
   tensor off it, bit-exact against the CPU oracle (MobileNet's final
   MatMul within the order bound) and bit for bit equal on the card to
   the same plan with ``use_fusion=False``;
3'''. the paper's formats on the card: ``qonnx_to_qcdq`` of TFC-w2a2,
   CNV-w2a2 and the rescaled MobileNet-w4a4 at img 224 (every conv on a
   kernel), ``qonnx_to_quantized_op`` of TFC-w2a2, each compiled on CUDA
   and held against the CPU oracle of the converted graph;
5. timings beside each kernel's bound, its twin and one library call
   computing the same function (CUDA events, median of 30 samples of 10
   calls after warm-up; device time from a replayed CUDA graph of the 10
   calls, call time from eager calls): at the TFC shapes with M = 256, and
   at the shapes of one MobileNet-w4a4 forward at img 224 with 8 rows
   (B5 at the grouped conv's shape), for the float32 bodies and for the
   integer ones (their library call is ``torch._int_mm`` on the int8
   operands where its shape rules allow, else ``torch.matmul`` on the
   float32 codes, exact sums, the epilogue not included either way; B2 on
   the body the lowering picks, and its 13 MobileNet pointwise layers also
   on the int8 body at a power-of-two scale and on the IMAD body; B6's
   13 depthwise layers also at a power-of-two scale; the library call of
   B5's / B6's integer rows is ``torch.bmm`` / ``F.conv2d(groups=C)`` on
   the float32 codes, the same exact sums without the epilogue);
   B4's largest MobileNet row also at a scale that is no power of two
   (0.37: the division); one MobileNet plan call's device time by kernel
   name (torch.profiler) and the device's busy share, on each path, and
   one TFC-w2a2 integer plan call of 16 rows; the MobileNet-224 integer
   plan call of 8 rows and the CNV-w1a1 integer plan call of 8 rows with
   fusion on and off (walls in turns, then one profile each: busy, launches,
   wall, busy share, by kernel name, and the boundary glue as its own rows:
   the fusion segments, the dequantize-on-entry and the codes-out of the
   kernel segments, labelled by ``record_function`` for that profile
   only); then each engine's requests per second (``--plan-profiles`` runs only the build and the two
   integer plan calls' profiles, three times each, so that a copy of the
   script in another tree measures that tree in the same call);
6. the LM serving path: first qwen2's SMOKE config on the card against
   the CPU (prefill logits, greedy tokens); then qwen2-1.5B at full width
   (28 layers, W8A8 with an 8-bit KV cache, bf16 activations, seeded
   weights): (a) a B=4, S=2048 prefill with exactly 28 B7 launches, held
   against the same prefill on the plain attention; (b) the launcher's
   traffic (8 requests, 16 new tokens, slots of 4) and the same with
   prompts of 512-2048 tokens through GenerationEngine, tokens per second,
   one slot of each held against greedy_generate;
7. LM timings: B7 at the prefill's attention shape (bf16 and float32)
   beside its twin, F.scaled_dot_product_attention and its bound; prefill
   and decode-step wall times; one decode step by kernel name;
8. the compiled plan captured per slot shape and the serving tier (the
   plans' default ``jit=True`` call: the first call at an input signature
   captures the plan in a CUDA graph, later calls replay it): (a) every
   ZOO key (MobileNet-w4a4 also rescaled) on both tiers, fused, three
   distinct slots (TFC 16 rows, CNV and MobileNet at 224 8 rows) replayed
   back to back before one sync, each ``torch.equal`` to the eager plan
   (``jit=False``) and to the CPU oracle (the rescaled MobileNet's final
   MatMul within the order bound), the capture's wrapper launches twice an
   eager forward's (warm-up and capture), none at a replay, one capture
   over six calls; (b) the seven keys in one ``EngineRegistry``, 64
   requests per key through a ``ServeScheduler`` each (window 2 ms,
   deadline 50 ms), every row bit-exact against the oracle, requests per
   second and p50 / p99, the served launches as replays x launches per
   forward, then a hot reload under traffic whose old plan is freed once
   drained; (c) ``SplitMergeFront`` over two workers on cuda:0 with one
   injected fault: no request lost, rows in submission order; (d) the
   launcher's ``--graph TFC-w2a2 --requests 64 --trace-jsonl`` in a
   subprocess, every request's submit -> complete span present; (e) plan
   call walls, captured against eager in turns (TFC-w2a2 16 rows, CNV-w1a1
   and MobileNet-224 8 rows, integer path, fused), their profiles and a
   captured call's time by CUDA events; last a segment that synchronizes:
   its capture raises naming the segment, again at the next call (no
   eager fallback), and the device stays usable;
9. QAT training (``train/loop.py``, ``optim/``, the STE backward; no
   kernel of the port lies on its path, B7 having no backward): (a)
   qwen2's SMOKE config in float32, FP32 and W8A8, one state on the CPU
   and its copy on the card, 3 steps each: loss and grad_norm within rel
   1e-5, parameters within 1e-5, TF32 off; (b) qwen2-1.5B at full width,
   W8A8 QAT, bf16 activations, float32 parameters, the launcher's
   defaults (global batch 16, seq 128, remat, peak lr 3e-4): 10 steps
   from init_params over SyntheticLMStream(seed=0), every loss finite,
   the last below the first, no kernel launch in the steps; the step wall
   (median of steps 3-10), tokens/s, peak memory, one step's profile (by
   kernel, by op, by backward node, and ranges for the forward and loss,
   the fake quant, the attention and AdamW); a step that must not sync
   with the host (``torch.cuda.set_sync_debug_mode("error")``); a step
   with compress_grads and the error-feedback invariant on the next
   gradient; a prefill of the trained model through 28 B7 launches; (c) microbatches 2 against 1 on the card within 5e-3;
   (d) the training launcher in a subprocess (SMOKE, 6 steps, checkpoints
   every 3), then the same run with a fault at step 4: it restarts,
   resumes from step 3 and matches steps 4-6 within rel 1e-5;
10. the launch-geometry autotuner (``repro_torch.tune``) on TFC-w2a2 (64
   rows), CNV-w1a1 (8) and the rescaled MobileNet-w4a4 at 224 (8), each
   declared at those rows, compile_graph's defaults, one fresh cache root
   (removed at the end): (a) ``tune="search"``: the signatures searched,
   the candidates timed per signature, each one's heuristic blocks and ms
   against the winner's (device ms of a CUDA graph of 10 calls, best of
   3 interleaved rounds), the wall; (b) a warm ``tune="cached"`` compile:
   0 searches, 0 misses, a graph hit, every kernel segment tuned, one
   capture over two same-shape calls; (c) the tuned plan torch.equal to
   the heuristic plan and to itself, and held against the CPU oracle as
   phase 3 holds it, then the float32-epilogue tier searched in the same
   root: against the oracle, against its heuristic plan (MobileNet's final
   MatMul within the order bound), and each float32 winner that differs
   from the heuristic within the order bound on randn; (d) the speed gate:
   captured tuned and heuristic plan calls in 8 interleaved turns, the
   tuned plan at least 0.90 of the heuristic's throughput; (e) an engine
   serving TFC-w2a2 from the cache (hits counted, rows bit-exact) and the
   launcher's ``--tune cached --tune-cache-dir`` answering 16 requests from
   the manifest of one search of the zoo's TFC-w2a2;
11. the vlm, moe, audio, ssm and hybrid families (llava-next-34b,
   deepseek-moe-16b, moonshot-v1-16b-a3b, whisper-base, rwkv6-7b,
   recurrentgemma-2b).  Every model here is seeded by ``api.init_params``
   with its vectors (norm weights, biases, gates, decays) then redrawn
   from N(0, 0.1) (``live_vectors``, as the CPU tests' weights): the
   init's zero vectors make a layernorm model's logits exactly 0.  Every
   logits gate also fails on logits that are constant over the
   vocabulary.  (a) each SMOKE config, one such init on the CPU and its
   copy on the card, FP32 and W8A8-kv8: forward, prefill plus two decode
   steps with every layer's cache (the hybrid's 9-token prompt rolls its
   ring of 8 and the decode steps wrap it), and greedy_generate (with
   img_embeds / frames) on the card against the CPU within the CPU
   tests' bounds, decode against forward on the card (moe at capacity
   8.0); (b) serving at published width, bf16 activations, float32
   weights, W8A8 (8-bit KV cache where the family quantizes its cache:
   not whisper's, not the hybrid's ring): whisper-base whole (B=4, 1,500
   frames, prompts of 4 tokens, 64 new), deepseek-moe-16b whole (B=4,
   512, 16), llava-next-34b cut to 24 layers (2,880 patches, B=2, 128,
   16), rwkv6-7b cut to 16 layers (B=4, 512, 16) and recurrentgemma-2b
   whole (B=4, 3,072-token prompts over its 2,048-slot ring, 16): one
   greedy_generate with B7 launched once per decoder layer and nothing
   else (never in rwkv6 or the hybrid), the prefill's wall, busy share
   and device launches (torch.profiler), the decode step's wall, launches
   and tokens/s (no B7), peak memory, deepseek's dropped share at
   capacity 1.25 and its moe_aux; B7 per launch at the three prefill
   shapes that run it, beside its twin, SDPA and its bound; (c) one W8A8
   QAT train step per family at published width (the training launcher's
   configuration, B=2, S=128; whisper whole, deepseek and llava cut to 2
   layers, rwkv6 to 4, recurrentgemma to 6, two groups): finite positive
   loss and grad_norm, no kernel launch, llava's loss equal to loss_fn's
   and to the sliced logits' loss; step wall and peak memory.
12. multi-device (A16) against the one-device plan, on one card:
   (a) ``elastic_mesh()`` and ``elastic_mesh(prefer_model=1)`` are
   {data 1, model 1} and ``compile_graph(mesh="auto")`` spans one device
   and equals the plain plan bit for bit (TFC-w1a1); (b) a 4-entry mesh
   of ``cuda:0`` (``launch.mesh.make_virtual_mesh``): TFC-w1a1 and
   CNV-w1a1 at 16 rows and the remainder batches 1, 5, 13, the rescaled
   MobileNet-w4a4 at img 224 at 8 rows, all on the integer path and
   ``torch.equal`` to the one-device plan (MobileNet's float32 final
   MatMul within the order bound should its bits differ), placement
   "mesh" over 4 devices, every entry's shard counter, one capture per
   shard signature, every shard replayed, each eager mesh forward
   launching exactly 4x the one-device forward's kernels (phase 3''s
   kernel set over the three keys); the float32-epilogue tier of TFC-w2a2
   and the rescaled MobileNet within the order bound of the CPU oracle;
   (c) ``CompiledGraphEngine(mesh=...)`` serving TFC-w1a1 in 16-row slots
   bit-exact, and ``SplitMergeFront`` over two mesh-sharded workers with a
   fault injected in one (no request lost, submission order); (d) the
   launcher's ``--graph TFC-w1a1 --mesh`` and ``--devices 4`` in two
   subprocesses started together, their logs naming the devices spanned; (e)
   ``quantized_psum`` on an NCCL group of one (a FileStore), equal to
   ``ef_compress`` on the CPU bit for bit, through the ambient mesh and
   through ``group=``; (f) the LM launcher under its (1, 1) mesh
   (qwen2-1.5B SMOKE, ``shard_activations=True``): tokens equal to the
   same generation with no mesh, B7 once per layer in each prefill; (g)
   the plan-call walls of the 4-entry mesh and the one-device plan (TFC-w1a1
   at 16 rows, the rescaled MobileNet at 8), in 10 turns, with their busy
   time: on one card the shards run one after another, so this is the
   cost of the split and the merge, not scaling.  Not gated.  (h) B7 on
   a DTensor's shards: a fake process group of 4 ranks in this process, a
   {data 2, model 2} ``cuda`` DeviceMesh, q, k, v whose rank-0 shards (half
   the rows, half the KV groups, bf16) lie on the card;
   ``transformer.attend`` launches B7 once, on those shards, and its
   result's shard equals B7's twin on them by phase 2's rule (the shards
   need no collective, so the fake group's empty ones change nothing).
   On a host
   of n cards (``--mesh`` alone, e.g. on four) the same checks run with
   (a) ``elastic_mesh()`` over the n cards and ``mesh="auto"`` spanning
   them, (b)-(d) and (g) over a mesh whose entries cycle over the cards
   (4 distinct cards on four: the walls then show the split across
   cards), (e) on cuda:0's one-entry mesh, and (f) checking first that
   the LM launcher refuses several cards without torchrun, then with ``--device
   cuda:0``;
13. the multi-pod dry-run (``python -m repro_torch.launch.dryrun``), one
   child process per arch, as many at once as the host has cores (capped
   at 8), so no process group outlives it: every (arch x shape) cell of the
   ten archs traced on meta tensors over a fake process group of 256 ranks
   (the 16x16 mesh; ``--dryrun``: and of 512, the 2x16x16 one) with a
   ``cuda`` DeviceMesh; per cell its status, trace time (beside the other
   children), collective count and bytes per device, per-chip FLOPs and
   argument / output bytes; it fails on a failed cell or a matrix other
   than 32 ok and 8 skipped per mesh.  It launches nothing on the card and
   runs after phase 12, so no timed phase shares the host's cores with it.
   Both meshes took longer than 300 s in one process, so the default run
   takes the single-pod mesh and ``--dryrun`` both.
14. both LM launchers under torchrun (``python -m torch.distributed.run
   --standalone --nproc-per-node 1``: NCCL on ``cuda:0``, world size 1,
   where nothing is distributed, so this drives the process layer on
   plain tensors), each child's summary line carrying its launch counts:
   (a) ``launch.train`` at qwen2-1.5B's full width with its defaults
   (16 x 128, W8A8, remat) for 2 steps with a checkpoint at step 2, then
   ``--steps 3`` resumed from it; each step's loss and the state after
   step 3 (the child's checkpoint, leaf by leaf by CRC-32 and size)
   bit-equal to ``launch.train.main(['--device', 'cuda', '--steps',
   '3'])`` in this process (the same kernels in the same order at world
   size 1; its state is kept in memory, not written), no kernel
   launched; (b) ``launch.serve`` at full width (W8A8, 8-bit KV), 8
   requests x 16 new tokens: tokens equal to the one-process launcher's,
   B7 28 times a prefill in the child; (c) the
   walls of each child and of the one-process runs, with the card's name
   and power limit: the serve child runs beside the first train child,
   the one-process serve launcher beside the resumed one (never two QAT
   runs at once: each peaks at ~53 GiB).  A child that fails, outlives
   its 300 s or prints no counts fails the phase, and kills the others.
15. the four examples of ``examples_torch/``, in this process through their
   ``main`` and section functions, each call in a launch-count window of
   its own, against the same calls on the CPU: (a) quickstart and
   export_zoo (operator outputs, node lists, counts, match flags, the
   round trip's exactness and CNV-w2a2's output equal; quickstart's
   float32 MatMul within the order bound; no launch); (b) serve_quantized's ``main`` (B7 once per
   layer per prefill, B1, B2, B4), then its sections on parameters drawn
   on the CPU and copied to the card: calibration, one engine slot (B7
   n_layers times), greedy float and W8A8 + 8-bit KV (B7 2 x n_layers;
   prefill logits within LM_SMALL_REL_L2, tokens equal), the weight-only
   matmuls (B1 and B2 once each; relative errors within EX_WEIGHT_ONLY),
   TFC-w2a2 behind the scheduler (B2 and B4 at warm-up and capture; rows
   equal to the CPU oracle, census equal); (c) train_qat_lm's ``run``
   for 3 W4A8 steps from one train state on the CPU and its copy on the
   card (losses within rel 1e-5, parameters within 1e-5, as phase 9 (a)),
   then the example at its defaults but ``--steps`` (EX_STEPS W4A8 steps of 16 x 32; the mean loss
   of the last 20 steps below that of the first 20), EX_STEPS + 20 steps
   resumed from step EX_STEPS, ``--full --steps 2`` (qwen2-1.5B at published width: finite
   losses, step wall, peak memory), no launch in any of them, the
   checkpoints in a temporary directory removed after; each example's
   wall with the card's name and power limit.

Launch counts are read in windows of their own: phase 3's plans, phase
4's engines, phases 3' and 4' likewise, each fused plan's own call in
3'' (its use_fusion=False twin runs outside the window), 3''', and phase
6 (a) and (b), phase 9 (b)'s steps (where no kernel may launch), phase
11 (b)'s generation, prefill and decode steps and (c)'s steps, and
phase 10's tuned plans (the search's own timing launches the wrappers
too, before those windows), and phase 14's children (each its own
process's counts) and the one-process serve launcher, and each call of
phase 15;
every kernel of each window's path must have launched in it.  Phases 3
to 5 call their plans eagerly (``jit=False``), as the
counts and profiles there need; the engines of phases 4 and 4' serve
through captured graphs, where a wrapper counts at the warm-up and the
capture and a replay runs no wrapper.  The last lines are the card, a JSON line of per-kernel numbers
(summed over one MobileNet-224 forward of 8 rows; B5 over the grouped
conv; the integer rows named ``<kernel>/int32``; the launches those of
the fused plans of 3'', the default path, per tier; B7 over one
qwen2-1.5B prefill at B=4, S=2048, its launches those of phase 6 (b))
and the JSON result line.  It imports nothing of JAX and nothing of the JAX package
``repro``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 on the tensor cores, dense
TFC_LAYERS = [(784, 64), (64, 64), (64, 64), (64, 10)]
M_TIMED = 256
SLOT = 8                       # MobileNet-224 rows per plan call / slot
REPLACES = {
    "quant_matmul": "src/repro/kernels/quant_matmul.py:139",
    "quant_matmul_int4": "src/repro/kernels/quant_matmul.py:184",
    "quant_dequant": "src/repro/kernels/quant_dequant.py:126",
    "quant_grouped_matmul": "src/repro/kernels/quant_grouped_conv.py:218",
    "quant_depthwise_conv2d": "src/repro/kernels/quant_grouped_conv.py:392",
    "flash_attention": "src/repro/kernels/flash_attention.py:94",
}
SOURCES = {
    "quant_matmul": "src/repro_torch/kernels/csrc/quant_matmul.cu",
    "quant_matmul_int4": "src/repro_torch/kernels/csrc/quant_matmul.cu",
    "quant_dequant": "src/repro_torch/kernels/csrc/quant_dequant.cu",
    "quant_grouped_matmul": "src/repro_torch/kernels/csrc/quant_grouped_conv.cu",
    "quant_depthwise_conv2d": "src/repro_torch/kernels/csrc/quant_grouped_conv.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
# the kernels of the zoo's compiled path (phases 3 + 4); B7 runs on the LM path
ZOO_KERNELS = ("quant_matmul", "quant_matmul_int4", "quant_dequant", "quant_grouped_matmul",
               "quant_depthwise_conv2d")
# what phase 4's engines (TFC-w2a2 and MobileNet-224, fused plans) launch
SERVED_KERNELS = ("quant_matmul", "quant_matmul_int4", "quant_dequant", "quant_depthwise_conv2d")
# the reference's census (use_analysis=False, use_fusion=False)
CENSUS = {
    ("TFC-w2a2", True): {"quant_dequant": 4, "quant_matmul_int4": 4, "interp": 3},
    ("TFC-w1a1", False): {"quant_dequant": 1, "quant_matmul": 4, "interp": 3},
    ("CNV-w1a1", True): {"quant_dequant": 1, "quant_conv": 1, "quant_conv_int4": 5,
                         "quant_matmul_int4": 3, "interp": 8},
    ("CNV-w2a2", True): {"quant_dequant": 3, "quant_conv": 1, "quant_conv_int4": 5,
                         "quant_matmul_int4": 3, "interp": 5},
    ("MobileNet-w4a4", True): {"quant_dequant": 1, "quant_conv": 1, "quant_conv_dw": 13,
                               "quant_conv_int4": 13, "quant_matmul_int4": 1,
                               "interp": 1},
}
# the reference's census and requant stats on the integer path: compile_graph's
# defaults (use_analysis=True, use_integer_requant=True) with use_fusion=False,
# held against the reference by tests/test_torch_requant.py
_TFC_INT = {"quant_dequant": 4, "quant_matmul_int4": 4, "interp": 3}
_MOBILENET_INT = {"quant_dequant": 1, "quant_conv": 1, "quant_conv_dw": 13,
                  "quant_conv_int4": 13, "interp": 1, "quant_matmul_int4": 1}
CENSUS_ANALYSIS = {
    "TFC-w1a1": {"quant_dequant": 1, "quant_matmul_int4": 4, "interp": 3},
    "TFC-w1a2": _TFC_INT,
    "TFC-w2a2": _TFC_INT,
    "CNV-w1a1": {"quant_dequant": 1, "quant_conv": 1, "interp": 8, "quant_conv_int4": 5,
                 "quant_matmul_int4": 3},
    "CNV-w2a2": {"quant_dequant": 3, "quant_conv": 1, "quant_conv_int4": 5, "interp": 5,
                 "quant_matmul_int4": 3},
    "MobileNet-w4a4": _MOBILENET_INT,
    "MobileNet-w4a4 rescaled": _MOBILENET_INT,
    "GroupedConv-g8": {"quant_dequant": 1, "quant_conv_grouped_int4": 1},
}




def _fusion(fbs, ib, packed, saved, offers, declined, kinds, interp):
    return {"stats": {"enabled": True, "fused_boundary_segments": fbs,
                      "integer_boundaries": ib, "packed_boundaries": packed,
                      "boundary_bytes_saved": saved, "offers": offers,
                      "declined": declined},
            "fusion_kinds": kinds, "interp": interp}


# the reference's census with fusion on (compile_graph's default), per tier
# ("int": the defaults, "f32": use_analysis=False): fusion_stats(), the
# fusion rules' segments and the ops left interpreted; held against the
# reference by tests/test_torch_fusion.py.  MobileNet at img 224, as built
# and rescaled alike.
FUSION_KINDS = ("bipolar_act", "quant_pool", "eltwise_add", "quant_concat")
_TFC_RELU = {"Relu": 3}
_CNV_REST = {"Flatten": 1, "Relu": 2}
_MOB_REST = {"GlobalAveragePool": 1, "Flatten": 1}
CENSUS_FUSION = {}
for _tier in ("int", "f32"):
    CENSUS_FUSION.update({
        ("TFC-w1a1", _tier): _fusion(8, 4, 3, 3024, 4, 0, {"bipolar_act": 3}, _TFC_RELU),
        ("TFC-w1a2", _tier): _fusion(8, 4, 3, 3024, 4, 0, {}, _TFC_RELU),
        ("TFC-w2a2", _tier): _fusion(8, 4, 3, 3024, 4, 0, {}, _TFC_RELU),
        ("CNV-w1a1", _tier): _fusion(19, 10, 7, 559744, 11, 1,
                                     {"bipolar_act": 8, "quant_pool": 2}, _CNV_REST),
        ("CNV-w1a2", _tier): _fusion(13, 10, 7, 559744, 11, 1, {"quant_pool": 2}, _CNV_REST),
        ("CNV-w2a2", _tier): _fusion(13, 10, 7, 559744, 11, 1, {"quant_pool": 2}, _CNV_REST),
        ("GroupedConv-g8", _tier): _fusion(2, 1, 0, 4816896, 2, 1, {}, {}),
    })
# the float32 depthwise body (B6) realizes its act Quant inside: no codes
CENSUS_FUSION[("MobileNet-w4a4", "f32")] = _fusion(27, 14, 0, 9633792, 15, 1, {}, _MOB_REST)
CENSUS_FUSION[("MobileNet-w4a4", "int")] = _fusion(28, 27, 0, 15429120, 28, 1, {}, _MOB_REST)


def _rq_stats(kernel, int32, eliminated):
    return {"kernel_segments": kernel, "int32_segments": int32,
            "fp32_segments": kernel - int32, "fp32_ops_eliminated": eliminated,
            "coverage": int32 / kernel}


REQUANT_STATS = {
    "TFC-w1a1": _rq_stats(4, 4, 202), "TFC-w1a2": _rq_stats(4, 4, 202),
    "TFC-w2a2": _rq_stats(4, 4, 202), "CNV-w1a1": _rq_stats(9, 9, 284170),
    "CNV-w2a2": _rq_stats(9, 9, 1133578),
    "MobileNet-w4a4": _rq_stats(28, 27, 40341504),
    "MobileNet-w4a4 rescaled": _rq_stats(28, 27, 40341504),
    "GroupedConv-g8": _rq_stats(1, 1, 12845056),
}
# the kernels with an integer body (B3 inlined); B4 has none
INT_KERNELS = ("quant_matmul", "quant_matmul_int4", "quant_grouped_matmul",
               "quant_depthwise_conv2d")
INT8_OPS = 1979e12             # H100 SXM int8 dense tensor-core rate (data sheet)
MOBILENET_224_STATS = {"grouped_segments": 13, "block_diagonal_grouped": 0,
                       "reclaimed_macs": 4_260_017_664,
                       "carrier_bytes_saved": 12_512_160}
# the synthetic grouped conv that puts B5 on the compiled path
GCONV = dict(n=SLOT, c=64, img=56, groups=8)
MODES = ("ROUND", "CEIL", "FLOOR", "UP", "DOWN", "HALF_UP", "HALF_DOWN",
         "ROUND_TO_ZERO")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_event_ms(run, samples: int) -> float:
    import torch
    ts = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def time_ms(fn, reps=10, samples=30) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn`` after warm-up.

    Device ms: ``reps`` calls captured in one CUDA graph and replayed, so
    the host's launch path is out of the measurement.  Call ms: ``reps``
    eager calls back to back, which at these shapes is bound by the
    host's launch path (Python wrapper, ctypes, launch)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def eager():
        for _ in range(reps):
            fn()
    device = _median_event_ms(graph.replay, samples) / reps
    call = _median_event_ms(eager, samples) / reps
    return device, call


# ----------------------------------------------------------------- phase 2

def check_matmuls(ops, torch, np, dev, err):
    """B1 / B2 against their twins; returns the number of cases."""
    rng = np.random.RandomState(0)
    # M = 16 is the serving slot, 64 the main path's batch, 256 the timed one
    shapes = [(m, k, n) for m in (1, 8, 16, 64, 256)
              for k, n in ((784, 64), (64, 64), (64, 10))]
    shapes += [(13, 98, 10), (33, 130, 70), (256, 784, 64)]
    n_cases = 0
    for m, k, n in shapes:
        for int4 in (False, True):
            name = "quant_matmul_int4" if int4 else "quant_matmul"
            fn = ops.quant_matmul_int4 if int4 else ops.quant_matmul
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (k, n)).astype(np.int8))
            wk = ops.pack_int4(w) if int4 else w
            for per_col in (False, True):
                for with_bias in (False, True):
                    s = torch.from_numpy((2.0 ** -rng.randint(2, 6, n if per_col else 1))
                                         .astype(np.float32)).reshape(-1 if per_col else ())
                    b = torch.from_numpy((rng.randint(-64, 64, n) / 16.0)
                                         .astype(np.float32)) if with_bias else None
                    # dyadic activations: every partial sum exact -> equal
                    x = torch.from_numpy((rng.randint(-128, 129, (m, k)) / 128.0)
                                         .astype(np.float32))
                    args = [t.to(dev) if t is not None else None for t in (x, wk, s, b)]
                    got = fn(*args)
                    want = ops.quant_matmul_int4_plain(*args) if int4 \
                        else ops.quant_matmul_plain(*args)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} {m}x{k}x{n} differs on dyadic x")
                    # randn activations: summation order may differ
                    xr = torch.randn(m, k, generator=torch.Generator().manual_seed(m * k + n))
                    args[0] = xr.to(dev)
                    got = fn(*args)
                    want = ops.quant_matmul_int4_plain(*args) if int4 \
                        else ops.quant_matmul_plain(*args)
                    mag = (xr.abs() @ w.float().abs()).to(dev) * s.abs().to(dev)
                    # order bound on the sums, plus one rounding of the result
                    bound = 2 * k * 2.0 ** -24 * mag + 2.0 ** -23 * want.abs()
                    diff = (got - want).abs()
                    if bool((diff > bound).any()):
                        raise AssertionError(f"{name} {m}x{k}x{n} beyond the order bound")
                    err[name] = max(err[name], float(diff.max()))
                    n_cases += 2
    return n_cases


def check_quant_dequant(ops, torch, np, dev, err):
    """B4 against its twin, bit-exact; returns the number of cases."""
    from repro_torch.kernels.quant_dequant import static_bounds
    rng = np.random.RandomState(1)
    n_cases = 0
    for shape in ((61, 130), (256, 784)):
        x = (rng.randn(*shape) * 4).astype(np.float32)
        x.reshape(-1)[:13] = np.arange(-6, 7, dtype=np.float32) * 0.5
        x = torch.from_numpy(x).to(dev)
        ncol = shape[1]
        for per_channel in (False, True):
            s = torch.from_numpy((rng.rand(ncol) * 0.5 + 0.05).astype(np.float32)).to(dev) \
                if per_channel else torch.tensor(0.37, device=dev)
            z = torch.from_numpy(np.round(rng.randn(ncol)).astype(np.float32)).to(dev) \
                if per_channel else torch.tensor(1.0, device=dev)
            for mode in MODES:
                for bits in (1, 2, 4, 7.5, 8):
                    for signed, narrow in ((True, False), (True, True), (False, False),
                                           (False, True)):
                        for codes in (False, True):
                            if codes and static_bounds(signed, narrow, bits)[1] > 127:
                                continue             # codes must fit int8
                            kw = dict(bit_width=bits, signed=signed, narrow=narrow,
                                      rounding_mode=mode, emit_codes=codes)
                            got = ops.quant_dequant(x, s, z, **kw)
                            want = ops.quant_dequant_plain(x, s, z, **kw)
                            if not torch.equal(got, want):
                                raise AssertionError(f"quant_dequant differs: {shape} {kw}")
                            n_cases += 1
    torch.cuda.synchronize()
    err["quant_dequant"] = 0.0
    return n_cases


def check_grouped_matmul(ops, torch, np, dev, err):
    """B5 against its twin; returns the number of cases."""
    rng = np.random.RandomState(6)
    g8, m8 = GCONV["groups"], GCONV["n"] * GCONV["img"] ** 2
    kg8, ng8 = GCONV["c"] // g8 * 9, GCONV["c"] // g8
    shapes = [(g8, m8, kg8, ng8), (2, 13, 10, 5), (3, 65, 18, 33), (4, 100, 36, 17),
              (1, 33, 130, 70), (64, 40, 2, 1)]
    n_cases = 0
    for g, m, kg, ng in shapes:
        for int4 in (False, True):
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (g, kg, ng)).astype(np.int8))
            wk = (ops.pack_int4_grouped(w) if int4 else w).to(dev)
            for per_ch in (False, True):
                for with_bias in (False, True):
                    s = torch.from_numpy((2.0 ** -rng.randint(2, 6, g * ng if per_ch else 1))
                                         .astype(np.float32)).reshape(-1 if per_ch else ())
                    b = torch.from_numpy((rng.randint(-64, 64, g * ng) / 16.0)
                                         .astype(np.float32)) if with_bias else None
                    s, b = s.to(dev), None if b is None else b.to(dev)
                    x = torch.from_numpy((rng.randint(-128, 129, (g, m, kg)) / 128.0)
                                         .astype(np.float32)).to(dev)
                    got = ops.quant_grouped_matmul(x, wk, s, b, packed=int4)
                    want = ops.quant_grouped_matmul_plain(x, wk, s, b, packed=int4)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"B5 {g}x{m}x{kg}x{ng} int4={int4} differs "
                                             "on dyadic x")
                    xr = torch.randn(g, m, kg, generator=torch.Generator().manual_seed(
                        g * m + kg)).to(dev)
                    got = ops.quant_grouped_matmul(xr, wk, s, b, packed=int4)
                    want = ops.quant_grouped_matmul_plain(xr, wk, s, b, packed=int4)
                    mag = torch.matmul(xr.abs(), w.to(dev).float().abs()) * s.abs().reshape(
                        (g, 1, ng) if per_ch else ())
                    bound = 2 * kg * 2.0 ** -24 * mag + 2.0 ** -23 * want.abs()
                    diff = (got - want).abs()
                    if bool((diff > bound).any()):
                        raise AssertionError(f"B5 {g}x{m}x{kg}x{ng} beyond the order bound")
                    err["quant_grouped_matmul"] = max(err["quant_grouped_matmul"],
                                                      float(diff.max()))
                    n_cases += 2
    # through the conv wrapper: a strided view of the im2col matrix in,
    # the (M, O) matrix out
    x = torch.from_numpy((rng.randint(-64, 65, (2, 24, 13, 11)) / 64.0)
                         .astype(np.float32)).to(dev)
    wg = torch.from_numpy(rng.randint(-7, 8, (6, 4 * 9, 5)).astype(np.int8)).to(dev)
    for int4 in (False, True):
        wk = ops.pack_int4_grouped(wg) if int4 else wg
        kw = dict(groups=6, kernel_shape=(3, 3), strides=(2, 1), pads=(1, 0, 2, 1),
                  dilations=(1, 2), packed=int4)
        got = ops.quant_grouped_conv2d(x, wk, 0.125, **kw)
        xg = ops.extract_patches(x, (3, 3), (2, 1), (1, 0, 2, 1), (1, 2))[0]
        want = ops.quant_grouped_matmul_plain(
            xg.view(xg.shape[0], 6, 36).permute(1, 0, 2), wk, 0.125, packed=int4)
        want = want.permute(1, 0, 2).reshape(2, got.shape[2], got.shape[3], 30) \
            .permute(0, 3, 1, 2)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B5 through quant_grouped_conv2d differs (int4={int4})")
        n_cases += 1
    return n_cases


def _mobilenet_layers(img=224):
    """(kind, cin, cout, stride, input H) of each MobileNet-V1 conv."""
    from repro_torch.models import zoo
    out, h = [], img
    for kind, cin, cout, stride in zoo.MOBILENET_V1:
        out.append((kind, cin, cout, stride, h))
        h = (h - 1) // stride + 1
    return out


def check_depthwise(ops, torch, np, dev, err):
    """B6 against its twin, bit-exact on randn inputs; returns the number of
    cases."""
    rng = np.random.RandomState(7)
    geos = [dict(strides=(1, 1), pads=(1, 1, 1, 1), dilations=(1, 1)),
            dict(strides=(2, 2), pads=(1, 1, 1, 1), dilations=(1, 1)),
            dict(strides=(2, 1), pads=(2, 0, 1, 1), dilations=(1, 1)),
            dict(strides=(1, 1), pads=(2, 2, 2, 2), dilations=(2, 2))]
    epis = [dict(relu=False, act_bits=None), dict(relu=True, act_bits=None)]
    epis += [dict(relu=True, act_bits=bits, act_signed=signed, act_rounding=mode)
             for bits, signed in ((2, False), (4, False), (8, True)) for mode in MODES]
    n_cases = 0

    def case(x, c, geo, epi, per_ch, with_bias, zp):
        taps = torch.from_numpy(rng.randint(-7, 8, (9, c)).astype(np.int8)).to(dev)
        s = torch.from_numpy((rng.rand(c if per_ch else 1) * 0.1 + 0.01)
                             .astype(np.float32)).to(dev).reshape(-1 if per_ch else ())
        b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(dev) if with_bias else None
        qs, qz = torch.tensor(0.173, device=dev), torch.tensor(zp, device=dev)
        kw = dict(kernel_shape=(3, 3), **geo, **epi)
        got = ops.quant_depthwise_conv2d(x, taps, s, b, qs, qz, **kw)
        want = ops.quant_depthwise_conv2d_plain(x, taps, s, b, qs, qz, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B6 {tuple(x.shape)} {kw} per_ch={per_ch} "
                                 f"bias={with_bias} differs")

    for c in (32, 37, 130):
        x = (torch.randn(2, c, 15, 14, generator=torch.Generator().manual_seed(c)) * 2).to(dev)
        for geo in geos:
            for i, epi in enumerate(epis):
                case(x, c, geo, epi, per_ch=bool(i % 2), with_bias=bool(i % 3),
                     zp=float(i % 2))
                n_cases += 1
    # every MobileNet-224 depthwise layer at 8 rows, with its own epilogue
    for kind, cin, _, stride, h in _mobilenet_layers():
        if kind != "dw":
            continue
        x = torch.randn(SLOT, cin, h, h, generator=torch.Generator().manual_seed(h)).to(dev)
        case(x, cin, dict(strides=(stride, stride), pads=(1, 1, 1, 1), dilations=(1, 1)),
             dict(relu=True, act_bits=4, act_signed=False), per_ch=False, with_bias=False,
             zp=0.0)
        n_cases += 1
    err["quant_depthwise_conv2d"] = 0.0
    return n_cases


# ------------------------------------------------ phase 2, B7 flash attention

FA_TOL = 2e-5    # float32: the bound of the reference's tests/test_flash_attention.py
# (H, KV, hd): qwen2-1.5B's GQA (G = 6) and olmo-1B's G = 1; the families'
# prefills: llava-next-34b (G = 7), deepseek-moe-16b (G = 1) and whisper-base's
# decoder (hd 64), also at llava's S_total = 2880 patches + 128 tokens and one
# row off it (FA_FAMILY_S)
FA_SHAPES = {"qwen2": (12, 2, 128), "olmo": (16, 16, 128), "llava": (56, 8, 128),
             "deepseek": (16, 16, 128), "whisper": (8, 8, 64)}
FA_FAMILY_S = (2880 + 128, 2880 + 127)


def _bf16_steps(torch, a, b):
    """Distance in bf16 steps between two bf16 tensors."""
    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def _hold_flash_attention(torch, got, want, what) -> tuple:
    """B7's output against its twin's on the same inputs.  float32: within
    FA_TOL (abs + rel).  bf16: within one bf16 step of the twin, or within
    FA_TOL where both round a near-zero float32 value (the two sum in other
    orders before their one rounding to bf16).  Raises beyond the bound;
    returns (max abs diff, the most bf16 steps apart beyond FA_TOL)."""
    diff = (got.float() - want.float()).abs()
    far = 0
    if got.dtype == torch.float32:
        ok = diff <= FA_TOL + FA_TOL * want.abs()
    else:
        steps = _bf16_steps(torch, got, want)
        ok = (steps <= 1) | (diff <= FA_TOL)
        far = int(steps[diff > FA_TOL].max()) if bool((diff > FA_TOL).any()) else 0
    if not bool(ok.all()):
        raise AssertionError(f"flash_attention {what}: {int((~ok).sum())} entries beyond the "
                             f"bound, max diff {float(diff.max())}")
    return float(diff.max()), far


def check_flash_attention(ops, torch, dev, err):
    """B7 against its twin at qwen2's, olmo's and the families' head shapes,
    S in {1, 17, 512, 2048, 2047} (the families' also FA_FAMILY_S), B in
    {1, 4}, causal and not, float32 and bf16, q, k and v as the model
    passes them (transposed views of (B, S, H, hd)), held by
    _hold_flash_attention.  Returns the number of cases."""
    g = torch.Generator(device=dev).manual_seed(7)
    n_cases, worst_steps = 0, 0
    for label, (H, KV, hd) in FA_SHAPES.items():
        family = label in ("llava", "deepseek", "whisper")
        for S in (1, 17, 512, 2048, 2047) + (FA_FAMILY_S if family else ()):
            for B in (1, 4):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=dev)
                               .to(dtype).transpose(1, 2) for h in (H, KV, KV))
                    for causal in (True, False):
                        got = ops.flash_attention(q, k, v, causal=causal)
                        want = ops.flash_attention_plain(q, k, v, causal=causal)
                        torch.cuda.synchronize()
                        d, far = _hold_flash_attention(
                            torch, got, want, f"{label} B={B} S={S} {dtype} causal={causal}")
                        worst_steps = max(worst_steps, far)
                        err["flash_attention"] = max(err["flash_attention"], d)
                        n_cases += 1
    print(f"flash_attention vs twin: {n_cases} cases, max abs diff "
          f"{err['flash_attention']:.3e} (bf16 entries beyond {FA_TOL}: at most "
          f"{worst_steps} bf16 step apart)", flush=True)
    return n_cases


# ------------------------------------------------ phase 2, integer bodies

IN_SCALE = 3 * 2.0 ** -5       # a dyadic activation scale that is no power of two
# B2's int8 body: the zoo's kind of activation scale (a power of two, staged
# by the exact reciprocal) and IN_SCALE (no power of two: the exact-quotient
# check, else the IEEE division)
TC_IN_SCALES = (2.0 ** -3, IN_SCALE)
STAGING_NAMES = ("reciprocal", "quotient", "division")   # ops.staging's modes


def int_specs():
    """The epilogues the integer cases run: None (the int32 body with the
    float32 epilogue), B3 without an act Quant (ReLU off and on), and B3
    with one in every rounding mode at act_shift -3, 0 and 5, the ReLU,
    the zero point and signed / unsigned / narrow / int8 bounds varying."""
    from repro_torch.kernels.requant import IntRequant
    bounds = [(-16, 15, (-2, 0, 1)), (-7, 7, (0, 1, -3)), (0, 15, (0, 3, 1)),
              (0, 14, (1, 0, 2)), (-128, 127, (5, -1, 0))]
    specs = [None, IntRequant(shift=9), IntRequant(shift=9, relu=True)]
    for i, (mode, s) in enumerate((m, s) for m in MODES for s in (-3, 0, 5)):
        lo, hi, zps = bounds[i % len(bounds)]
        specs.append(IntRequant(shift=s + 4, relu=bool(i % 2), has_act=True, act_shift=s,
                                act_zp=zps[i % 3], act_lo=lo, act_hi=hi, act_out_shift=4,
                                rounding_mode=mode))
    return specs


def _body(torch, spec, n, per_ch, rng, np, dev):
    """(scale or multipliers, keyword arguments) of one integer case."""
    if spec is None:
        s = (2.0 ** -rng.randint(2, 6, n if per_ch else 1)).astype(np.float32)
        return torch.from_numpy(s).to(dev), dict(acc_dtype=torch.int32)
    mult = (2 * rng.randint(0, 5, n if per_ch else 1) + 1).astype(np.int32)
    return torch.from_numpy(mult).to(dev), dict(acc_dtype=torch.int32, requant=spec,
                                                in_scale=IN_SCALE)


def _int_x(torch, np, rng, shape, dev, spec, qmax=8):
    """Integer-valued activations: q * IN_SCALE on the B3 body (the kernel
    divides it back), q itself on the float32-epilogue body."""
    q = rng.randint(-qmax, qmax + 1, shape).astype(np.float32)
    return torch.from_numpy(q * np.float32(IN_SCALE) if spec is not None else q).to(dev)


def check_integer(ops, torch, np, dev, err):
    """B1 / B2 / B5 / B6 on their integer bodies against their twins, all
    with torch.equal (integer sums are exact in any order); returns the
    number of cases per kernel."""
    rng = np.random.RandomState(21)
    specs = int_specs()
    n_cases = {k: 0 for k in INT_KERNELS}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} integer body differs: {what}")
        n_cases[name] += 1

    # B1 / B2: ragged, TFC and MobileNet-pointwise shapes; every spec
    for m, k, n in ((37, 130, 70), (256, 784, 64), (64, 64, 10), (1568, 256, 256)):
        for int4 in (False, True):
            name = "quant_matmul_int4" if int4 else "quant_matmul"
            fn, plain = ((ops.quant_matmul_int4, ops.quant_matmul_int4_plain) if int4
                         else (ops.quant_matmul, ops.quant_matmul_plain))
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (k, n)).astype(np.int8))
            wk = (ops.pack_int4(w) if int4 else w).to(dev)
            for i, spec in enumerate(specs):
                s, kw = _body(torch, spec, n, bool(i % 2), rng, np, dev)
                x = _int_x(torch, np, rng, (m, k), dev, spec)
                bias = torch.randn(n, generator=torch.Generator().manual_seed(i)).to(dev) \
                    if i % 5 == 0 else None
                same(name, fn(x, wk, s, bias, **kw), plain(x, wk, s, bias, **kw),
                     f"{m}x{k}x{n} {spec}")
    # accumulators at the obligation-3 limit: one row of x and one column of
    # w at their largest, summed over K, just below 2**24
    k = 1040
    for int4 in (False, True):
        name = "quant_matmul_int4" if int4 else "quant_matmul"
        fn, plain = ((ops.quant_matmul_int4, ops.quant_matmul_int4_plain) if int4
                     else (ops.quant_matmul, ops.quant_matmul_plain))
        wmax = 7 if int4 else 127
        qmax = (2 ** 24 - 1) // (k * wmax)
        w = torch.from_numpy(rng.randint(-wmax, wmax + 1, (k, 5)).astype(np.int8))
        w[:, 0] = wmax
        wk = (ops.pack_int4(w) if int4 else w).to(dev)
        q = rng.randint(-qmax, qmax + 1, (3, k)).astype(np.float32)
        q[0] = qmax
        q[1] = -qmax
        for spec in specs[:3]:
            x = torch.from_numpy(q * np.float32(IN_SCALE) if spec is not None else q).to(dev)
            s, kw = _body(torch, spec, 5, False, np.random.RandomState(0), np, dev)
            s = torch.ones_like(s)              # mult 1: acc * mult stays below 2**24
            got = fn(x, wk, s, **kw)
            same(name, got, plain(x, wk, s, **kw), f"edge {spec}")

    # B2's int8 tensor-core body (int8_codes: the lowering's proof that the
    # staged codes fit int8), equal to the twin and to the IMAD body, its
    # launches counted per body: codes over all of int8, ragged M, N and K
    # and MobileNet-224 pointwise shapes at 8 rows, both scale kinds (a
    # power of two: the reciprocal multiply; IN_SCALE: the exact-quotient
    # staging), x off the scale's grid (random values and exact halves,
    # where the staging divides), and sums at the limit
    before = ops.b2_body_counts()
    n_tc = 0

    def tc_case(x, wk, s, bias, kw, what):
        nonlocal n_tc
        got = ops.quant_matmul_int4(x, wk, s, bias, int8_codes=True, **kw)
        same("quant_matmul_int4", got,
             ops.quant_matmul_int4_plain(x, wk, s, bias, int8_codes=True, **kw), what)
        same("quant_matmul_int4", ops.quant_matmul_int4(x, wk, s, bias, **kw), got,
             what + " (IMAD body)")
        n_tc += 1
        return got

    for m, k, n, sp in ((1, 32, 10, specs), (17, 784, 64, specs), (37, 98, 70, specs),
                        (392, 1024, 1024, specs[:6]), (1568, 256, 512, specs[:4]),
                        (25088, 64, 128, specs[:4])):
        wk = ops.pack_int4(torch.from_numpy(rng.randint(-8, 8, (k, n)).astype(np.int8))).to(dev)
        for i, spec in enumerate(sp):
            for in_scale in TC_IN_SCALES:
                s, kw = _body(torch, spec, n, bool(i % 2), rng, np, dev)
                kw["in_scale"] = in_scale
                q = rng.randint(-127, 128, (m, k)).astype(np.float32)
                bias = torch.randn(n, generator=torch.Generator().manual_seed(i)).to(dev) \
                    if i % 3 == 0 else None
                tc_case(torch.from_numpy(q * np.float32(in_scale)).to(dev), wk, s, bias, kw,
                        f"int8 body {m}x{k}x{n} in_scale={in_scale} {spec}")
    for i, spec in enumerate(specs[:6]):
        wk = ops.pack_int4(torch.from_numpy(rng.randint(-8, 8, (130, 40)).astype(np.int8))).to(dev)
        q = rng.uniform(-120, 120, (70, 130))
        q[::3] = np.round(q[::3]) + 0.5
        for in_scale in TC_IN_SCALES:
            s, kw = _body(torch, spec, 40, bool(i % 2), rng, np, dev)
            kw["in_scale"] = in_scale
            tc_case(torch.from_numpy((q * in_scale).astype(np.float32)).to(dev), wk, s, None, kw,
                    f"int8 body, x off the grid, in_scale={in_scale} {spec}")
    # the limit of int8 codes: -127 / 127 against -8 over K = 16510 (ragged
    # in 32), sums of +-16,774,160, just below 2**24
    k = 16510
    w = torch.from_numpy(rng.randint(-8, 8, (k, 5)).astype(np.int8))
    w[:, 0] = -8
    wk = ops.pack_int4(w).to(dev)
    q = rng.randint(-127, 128, (3, k)).astype(np.float32)
    q[0], q[1] = -127, 127
    for spec in specs[:3]:
        for in_scale in TC_IN_SCALES:
            s, kw = _body(torch, spec, 5, False, np.random.RandomState(0), np, dev)
            kw["in_scale"] = in_scale
            what = f"int8 body at the limit, in_scale={in_scale} {spec}"
            got = tc_case(torch.from_numpy(q * np.float32(in_scale)).to(dev), wk,
                          torch.ones_like(s), None, kw, what)
            if spec is None and float(got.abs().max()) != 16774160.0:
                raise AssertionError(f"{what}: the sums did not reach the limit")
    after = ops.b2_body_counts()
    if after["int8_mma"] - before["int8_mma"] != n_tc or \
            after["imad"] - before["imad"] != n_tc:
        raise AssertionError(f"B2 body launches {before} -> {after} for {n_tc} int8 cases")
    n_cases["quant_matmul_int4 (int8 body)"] = n_tc

    # B5: the grouped conv's shape and ragged ones, int8 and int4
    g8, m8 = GCONV["groups"], GCONV["n"] * GCONV["img"] ** 2
    shapes = [((g8, m8, GCONV["c"] // g8 * 9, GCONV["c"] // g8), specs[:6]),
              ((3, 65, 18, 33), specs), ((2, 13, 10, 5), specs), ((1, 33, 130, 70), specs[:8])]
    for (g, m, kg, ng), sp in shapes:
        for int4 in (False, True):
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (g, kg, ng)).astype(np.int8))
            wk = (ops.pack_int4_grouped(w) if int4 else w).to(dev)
            for i, spec in enumerate(sp):
                s, kw = _body(torch, spec, g * ng, bool(i % 2), rng, np, dev)
                x = _int_x(torch, np, rng, (g, m, kg), dev, spec)
                same("quant_grouped_matmul",
                     ops.quant_grouped_matmul(x, wk, s, packed=int4, **kw),
                     ops.quant_grouped_matmul_plain(x, wk, s, packed=int4, **kw),
                     f"{g}x{m}x{kg}x{ng} int4={int4} {spec}")

    # B6: ragged geometries with every spec, then every MobileNet-224
    # depthwise layer at 8 rows; spec None runs the fused float32 epilogue
    geos = [dict(strides=(1, 1), pads=(1, 1, 1, 1), dilations=(1, 1)),
            dict(strides=(2, 1), pads=(2, 0, 1, 1), dilations=(1, 1)),
            dict(strides=(1, 1), pads=(2, 2, 2, 2), dilations=(2, 2))]
    fp32_epi = dict(relu=True, act_bits=4, act_signed=False, act_rounding="HALF_UP")

    def dw_case(x_shape, geo, spec, per_ch, qmax=8, taps=None):
        c = x_shape[1]
        taps = taps if taps is not None else \
            torch.from_numpy(rng.randint(-7, 8, (9, c)).astype(np.int8)).to(dev)
        s, kw = _body(torch, spec, c, per_ch, rng, np, dev)
        x = _int_x(torch, np, rng, x_shape, dev, spec, qmax)
        args = (x, taps, s)
        if spec is None:
            args += (None, torch.tensor(0.25, device=dev), torch.tensor(1.0, device=dev))
            kw.update(fp32_epi)
        kw.update(kernel_shape=(3, 3), **geo)
        same("quant_depthwise_conv2d", ops.quant_depthwise_conv2d(*args, **kw),
             ops.quant_depthwise_conv2d_plain(*args, **kw), f"{x_shape} {geo} {spec}")

    for c in (32, 37):
        for geo in geos:
            for i, spec in enumerate(specs):
                dw_case((2, c, 15, 14), geo, spec, bool(i % 2))
    for j, (kind, cin, _, stride, h) in enumerate(_mobilenet_layers()):
        if kind == "dw":
            dw_case((SLOT, cin, h, h), dict(strides=(stride, stride), pads=(1, 1, 1, 1),
                                            dilations=(1, 1)), specs[3 + j % 24], True)
    # accumulators at the limit: 9 taps of the largest weight and input
    qmax = (2 ** 24 - 1) // (9 * 127)
    taps = torch.full((9, 4), 127, dtype=torch.int8, device=dev)
    for spec in specs[:3]:
        dw_case((1, 4, 6, 6), geos[0], spec, False, qmax=qmax, taps=taps)
    for k in INT_KERNELS:
        err[k + "/int32"] = 0.0
    return n_cases


# ----------------------------------- phase 2, the B5 / B6 redesign's cases

# B6 geometries beyond check_depthwise's, (N, C, H, W, kernel, strides,
# dilations, pads): the tile and plane-group boundaries (planes of 1x1,
# 7x7, 13x13; C off the planes per block; N = 1), odd H at stride 2,
# dilation 2, asymmetric pads, 5x5 and 1x3 kernels, tiles whose rows are
# not on 16 bytes
DW_GEOMETRIES = [
    (2, 5, 1, 1, (3, 3), (1, 1), (1, 1), (1, 1, 1, 1)),
    (3, 37, 7, 7, (3, 3), (1, 1), (1, 1), (1, 1, 1, 1)),
    (1, 19, 13, 13, (3, 3), (1, 1), (1, 1), (1, 1, 1, 1)),
    (2, 6, 15, 14, (3, 3), (2, 2), (1, 1), (1, 1, 1, 1)),
    (2, 5, 33, 31, (3, 3), (2, 1), (1, 1), (2, 0, 1, 1)),
    (2, 4, 20, 24, (3, 3), (1, 1), (2, 2), (2, 2, 2, 2)),
    (1, 3, 40, 44, (5, 5), (1, 1), (1, 1), (2, 2, 2, 2)),
    (2, 7, 17, 9, (1, 3), (1, 1), (1, 1), (0, 1, 0, 1)),
    (1, 2, 70, 66, (3, 3), (1, 2), (1, 1), (1, 1, 1, 1)),
    (1, 3, 57, 100, (3, 3), (2, 2), (1, 1), (1, 1, 1, 1)),
]
# B5 shapes (G, M, Kg, Ng): Ng 1, 8, 12, 16, 40; Kg off 4 (the element
# path); Kg above the 128-wide staged slice (the K loop)
GQ_SHAPES = [(3, 70, 36, 1), (4, 100, 72, 8), (2, 65, 18, 12), (3, 129, 40, 16),
             (2, 33, 36, 40), (3, 50, 27, 12), (2, 90, 300, 8), (1, 257, 258, 40)]
# the integer bodies' stagings: a power of two (the reciprocal), IN_SCALE
# (the exact-quotient check) and, with x off IN_SCALE's grid, its division
# fallback; TINY_SCALE's reciprocal overflows float32, so every x is
# divided (its twin runs on the CPU, whose division keeps the subnormals)
STAGINGS = ((2.0 ** -3, False), (IN_SCALE, False), (IN_SCALE, True))
TINY_SCALE = 3 * 2.0 ** -140


def _staged_x(torch, np, rng, shape, dev, in_scale, off_grid, qmax=8):
    """q · in_scale, every seventh element moved off the grid if asked."""
    x = rng.randint(-qmax, qmax + 1, shape).astype(np.float32) * np.float32(in_scale)
    if off_grid:
        x.reshape(-1)[::7] += np.float32(in_scale / 3)
    return torch.from_numpy(x).to(dev)


def check_redesign(ops, torch, np, dev, err):
    """B6 and B5 at the redesign's boundaries (DW_GEOMETRIES, every
    MobileNet-224 depthwise layer at 8 rows, GQ_SHAPES), each body against
    its twin: B6 torch.equal throughout (float32 on randn in every rounding
    mode, the integer bodies in every staging); B5's integer bodies
    torch.equal, its float32 body exact on dyadic x and within the order
    bound on randn; the staging counts follow the scales.  Returns the
    number of cases per kernel."""
    rng = np.random.RandomState(31)
    specs = int_specs()
    n_cases = {"quant_depthwise_conv2d": 0, "quant_grouped_matmul": 0}
    before = ops.staging_counts()
    expect = {k: dict.fromkeys(("reciprocal", "quotient", "division"), 0) for k in n_cases}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its twin: {what}")
        n_cases[name] += 1

    def dw_float(x, taps, geo_kw, mode, i):
        c = x.shape[1]
        s = torch.from_numpy((rng.rand(c) * 0.1 + 0.01).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.randn(c).astype(np.float32)).to(dev) if i % 2 else None
        qs = torch.tensor(0.125 if i % 3 else 0.173, device=dev)     # power of two or not
        qz = torch.tensor(float(i % 2), device=dev)
        kw = dict(geo_kw, relu=True, act_bits=4, act_signed=False, act_rounding=mode)
        same("quant_depthwise_conv2d", ops.quant_depthwise_conv2d(x, taps, s, b, qs, qz, **kw),
             ops.quant_depthwise_conv2d_plain(x, taps, s, b, qs, qz, **kw),
             f"float32 {tuple(x.shape)} {kw}")

    def twin(plain, args, kw, cpu):
        if not cpu:
            return plain(*args, **kw)
        return plain(*(a.cpu() if torch.is_tensor(a) else a for a in args), **kw).to(dev)

    def dw_int(shape, taps, geo_kw, spec, in_scale, off_grid):
        x = _staged_x(torch, np, rng, shape, dev, in_scale, off_grid)
        c = shape[1]
        if spec is None:
            s = torch.from_numpy((2.0 ** -rng.randint(2, 6, c)).astype(np.float32)).to(dev)
            kw = dict(acc_dtype=torch.int32, in_scale=in_scale)
        else:
            s = torch.from_numpy((2 * rng.randint(0, 5, c) + 1).astype(np.int32)).to(dev)
            kw = dict(acc_dtype=torch.int32, requant=spec, in_scale=in_scale)
        kw.update(geo_kw)
        same("quant_depthwise_conv2d", ops.quant_depthwise_conv2d(x, taps, s, **kw),
             twin(ops.quant_depthwise_conv2d_plain, (x, taps, s), kw, in_scale == TINY_SCALE),
             f"integer {shape} {geo_kw} in_scale={in_scale} off_grid={off_grid} {spec}")
        expect["quant_depthwise_conv2d"][STAGING_NAMES[ops.staging(in_scale)[0]]] += 1

    layers = [(SLOT, cin, h, h, (3, 3), (st, st), (1, 1), (1, 1, 1, 1))
              for kind, cin, _, st, h in _mobilenet_layers() if kind == "dw"]
    for j, (n, c, h, w, ks, st, dil, pads) in enumerate(DW_GEOMETRIES + layers):
        geo_kw = dict(kernel_shape=ks, strides=st, dilations=dil, pads=pads)
        taps = torch.from_numpy(rng.randint(-7, 8, (ks[0] * ks[1], c)).astype(np.int8)).to(dev)
        x = torch.randn(n, c, h, w, generator=torch.Generator().manual_seed(j)).to(dev)
        for i, mode in enumerate(MODES if j >= len(DW_GEOMETRIES) or j % 3 == 0 else MODES[::3]):
            dw_float(x, taps, geo_kw, mode, i + j)
        for k, (in_scale, off_grid) in enumerate(STAGINGS):
            dw_int((n, c, h, w), taps, geo_kw, specs[3 + (3 * j + k) % 24], in_scale, off_grid)
        dw_int((n, c, h, w), taps, geo_kw, None, STAGINGS[j % 3][0], STAGINGS[j % 3][1])
        if j < len(DW_GEOMETRIES):
            dw_int((n, c, h, w), taps, geo_kw, specs[j % 3], TINY_SCALE, False)

    for g, m, kg, ng in GQ_SHAPES:
        for int4 in (False, True) if kg % 2 == 0 else (False,):
            lo, hi = (-8, 7) if int4 else (-127, 127)
            w = torch.from_numpy(rng.randint(lo, hi + 1, (g, kg, ng)).astype(np.int8))
            wk = (ops.pack_int4_grouped(w) if int4 else w).to(dev)
            s = torch.from_numpy((2.0 ** -rng.randint(2, 6, g * ng)).astype(np.float32)).to(dev)
            b = torch.from_numpy((rng.randint(-64, 64, g * ng) / 16.0).astype(np.float32)).to(dev)
            x = torch.from_numpy((rng.randint(-128, 129, (g, m, kg)) / 128.0)
                                 .astype(np.float32)).to(dev)
            what = f"B5 {g}x{m}x{kg}x{ng} int4={int4}"
            same("quant_grouped_matmul", ops.quant_grouped_matmul(x, wk, s, b, packed=int4),
                 ops.quant_grouped_matmul_plain(x, wk, s, b, packed=int4), what + " dyadic")
            xr = torch.randn(g, m, kg, generator=torch.Generator().manual_seed(m + kg)).to(dev)
            got = ops.quant_grouped_matmul(xr, wk, s, b, packed=int4)
            want = ops.quant_grouped_matmul_plain(xr, wk, s, b, packed=int4)
            mag = torch.matmul(xr.abs(), w.to(dev).float().abs()) * s.abs().reshape(g, 1, ng)
            diff = (got - want).abs()
            if bool((diff > 2 * kg * 2.0 ** -24 * mag + 2.0 ** -23 * want.abs()).any()):
                raise AssertionError(f"{what} beyond the order bound")
            err["quant_grouped_matmul"] = max(err["quant_grouped_matmul"], float(diff.max()))
            n_cases["quant_grouped_matmul"] += 1
            for k, (in_scale, off_grid) in enumerate(STAGINGS + ((TINY_SCALE, False),)):
                for spec in (None, specs[3 + (k + ng) % 24]):
                    xi = _staged_x(torch, np, rng, (g, m, kg), dev, in_scale, off_grid)
                    if spec is None:
                        si, kw = s, dict(acc_dtype=torch.int32, in_scale=in_scale)
                    else:
                        si = torch.from_numpy((2 * rng.randint(0, 5, g * ng) + 1)
                                              .astype(np.int32)).to(dev)
                        kw = dict(acc_dtype=torch.int32, requant=spec, in_scale=in_scale)
                    same("quant_grouped_matmul",
                         ops.quant_grouped_matmul(xi, wk, si, packed=int4, **kw),
                         twin(ops.quant_grouped_matmul_plain, (xi, wk, si),
                              dict(kw, packed=int4), in_scale == TINY_SCALE),
                         f"{what} in_scale={in_scale} off_grid={off_grid} {spec}")
                    expect["quant_grouped_matmul"][STAGING_NAMES[ops.staging(in_scale)[0]]] += 1
    after = ops.staging_counts()
    moved = {k: {m: after[k][m] - before[k][m] for m in after[k]} for k in after}
    if moved != expect:
        raise AssertionError(f"staging launches {moved}, expected {expect}")
    print(f"redesign cases: {n_cases}; integer launches by staging {moved}", flush=True)
    return n_cases


# ----------------------------------- phase 2, the B4 / B1 redesign's cases

# B4's scales: reciprocals that are subnormal (2^127), overflow (2^-149, a
# subnormal scale) or negative (-0.125), the normal extremes, the zoo's
# powers of two and one that is no power of two (the division)
QDQ_SCALES = (2.0 ** -149, 2.0 ** -126, 2.0 ** 126, 2.0 ** 127, -0.125, 0.125, 0.5,
              2.0 ** -7, 0.37)
# a per-channel row mixing powers of two (multiplied) and other scales
# (divided); 11 columns, so vectors wrap columns
QDQ_MIXED = (0.125, 0.37, 2.0 ** -126, 2.0 ** 127, -0.125, 1.0, 2.0 ** -149, 3.0, 0.5,
             2.0 ** 126, 1e-3)
# B4's widths: (bits, signed, narrow, zero point)
QDQ_WIDTHS = ((8, True, False, 0.0), (4, False, True, 3.0), (2, True, True, -1.0),
              (7.5, True, False, 0.0))
# B1 / B2 (CUDA-core bodies): M in {1, 16}, the ragged K, odd N
QMM_RAGGED = [(m, k, n) for m in (1, 16) for k, n in ((1, 9), (27, 33), (98, 65),
                                                      (130, 9), (785, 33))]


def qdq_edge_x(np, scale):
    """Values a quantizer must keep its bits on: signed zeros, infinities,
    NaN, subnormals, .5 ties and values near the clip bounds (in units of
    ``scale``), then randn spread over the grid."""
    tiny = 2.0 ** -149
    base = [0.0, -0.0, np.inf, -np.inf, np.nan, tiny, -tiny, 2.0 ** -130, -(2.0 ** -127),
            1.17549435e-38]
    units = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 6.5, 7.5, -7.5, -8.5, 7.49, 7.51, -8.49,
             -8.51, 14.5, 15.5, 126.5, 127.5, -128.5, 300.0, -300.0, 0.25, 3.0]
    with np.errstate(all="ignore"):
        near = np.array(units, np.float32) * np.float32(scale)
        spread = (np.random.RandomState(7).randn(66) * 9 * scale).astype(np.float32)
    return np.concatenate([np.array(base, np.float32), near.astype(np.float32), spread])


def equal_nan(torch, a, b) -> bool:
    """torch.equal with every NaN equal to every NaN.  Zeros compare by
    value, as torch.equal has them: the twin's clamp on the card (fmaxf)
    turns a -0.0 at a lower bound of 0 into +0.0, where the kernel's
    compare keeps -0.0, as the twin on the CPU does."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a),
                                               torch.where(nb, 0.0, b))


def check_b4_b1_redesign(ops, torch, np, dev, err):
    """B4 and B1 / B2's CUDA-core body at the redesign's boundaries, each
    against its twin on the same inputs.  B4 torch.equal (NaN as NaN) in
    every mode, width and output kind: the scales of QDQ_SCALES per tensor
    and the mixed per-channel row on the edge values; views 1-3 elements
    off 16 bytes; numel 1, 3, 5; one tensor larger than a grid sweep.  B1
    and B2: every tile and cluster size the plan can choose, QMM_RAGGED,
    misaligned x views; the float32 body exact on dyadic x, within the
    order bound on randn and the same bits on a repeated call; the integer
    bodies torch.equal with B3 on in all three stagings of x (and the
    division at TINY_SCALE, its twin on the CPU).  Returns the number of
    cases per kernel."""
    from repro_torch.kernels import quant_dequant as qd
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels.quant_dequant import static_bounds
    rng = np.random.RandomState(41)
    specs = int_specs()
    n_cases = {"quant_dequant": 0, "quant_matmul": 0, "quant_matmul_int4": 0}

    def qdq(x, s, z, what, **kw):
        got = ops.quant_dequant(x, s, z, **kw)
        want = ops.quant_dequant_plain(x, s, z, **kw)
        torch.cuda.synchronize()
        if not equal_nan(torch, got, want):
            raise AssertionError(f"quant_dequant differs from its twin: {what} {kw}")
        n_cases["quant_dequant"] += 1

    def widths(x, s, z_scalar, what, codes_x=None):
        for mode in MODES:
            for bits, signed, narrow, zp in QDQ_WIDTHS:
                z = torch.tensor(zp, device=dev) if z_scalar is None else z_scalar
                kw = dict(bit_width=bits, signed=signed, narrow=narrow, rounding_mode=mode)
                qdq(x, s, z, what, **kw)
                if static_bounds(signed, narrow, bits)[1] <= 127:
                    qdq(x if codes_x is None else codes_x, s, z, what + " codes",
                        emit_codes=True, **kw)

    for scale in QDQ_SCALES:
        xe = torch.from_numpy(qdq_edge_x(np, scale if abs(scale) > 2.0 ** -120 else 1.0)
                              .reshape(3, 33)).to(dev)
        # the code of a NaN is the cast's (undefined in C++): codes take the
        # finite edge values
        xc = torch.where(torch.isfinite(xe), xe, torch.zeros_like(xe))
        widths(xe, torch.tensor(scale, device=dev), None, f"scale {scale}", xc)
    s_mix = torch.tensor(QDQ_MIXED, device=dev)
    z_mix = torch.tensor([0, 1, -2, 0, 3, 0, 0, -1, 2, 0, 1], dtype=torch.float32,
                         device=dev)
    xe = torch.from_numpy(np.concatenate([qdq_edge_x(np, 1.0), qdq_edge_x(np, 0.125),
                                          qdq_edge_x(np, 0.37)])[:11 * 27]
                          .reshape(27, 11)).to(dev)
    xe[5] = xe[5] * s_mix
    widths(xe, s_mix, z_mix, "mixed per-channel row",
           torch.where(torch.isfinite(xe), xe, torch.zeros_like(xe)))
    # views 1-3 elements off 16 bytes, and numel 1, 3, 5, per tensor and
    # per channel (the scalar head and tail, the column wrap)
    for off in (1, 2, 3):
        for rows, cols in ((1, 1), (1, 3), (1, 5), (7, 13), (97, 130)):
            buf = torch.randn(rows * cols + off, generator=torch.Generator().manual_seed(off))
            x = (buf * 3).to(dev)[off:].view(rows, cols)
            s_ch = torch.from_numpy((2.0 ** -rng.randint(1, 5, cols)).astype(np.float32))
            s_ch[::3] = 0.37
            for s, z in ((torch.tensor(0.125, device=dev), torch.tensor(1.0, device=dev)),
                         (s_ch.to(dev), torch.from_numpy(rng.randint(-2, 3, cols)
                                                         .astype(np.float32)).to(dev))):
                for mode in MODES[::2]:
                    for codes in (False, True):
                        qdq(x, s, z, f"view +{off} {rows}x{cols}", bit_width=4,
                            rounding_mode=mode, emit_codes=codes)
    # larger than one sweep of the grid (QDQ_MAX_BLOCKS blocks), per tensor
    # and per channel (cols odd)
    big = torch.randn(5003, 3501, generator=torch.Generator().manual_seed(9)).to(dev) * 4
    assert big.numel() > 4 * qd.QDQ_MAX_BLOCKS * qd.QDQ_THREADS * qd.QDQ_UMAX
    s_big = torch.from_numpy((2.0 ** -rng.randint(1, 5, 3501)).astype(np.float32)).to(dev)
    for s in (torch.tensor(0.125, device=dev), s_big):
        for codes in (False, True):
            qdq(big, s, torch.tensor(0.0, device=dev), "beyond a grid sweep", bit_width=4,
                emit_codes=codes)
    err["quant_dequant"] = 0.0

    # B1 / B2 on the CUDA cores
    def staged(shape, in_scale, off_grid):
        return _staged_x(torch, np, rng, shape, dev, in_scale, off_grid)

    def twin(plain, args, kw, cpu):
        if not cpu:
            return plain(*args, **kw)
        return plain(*(a.cpu() if torch.is_tensor(a) else a for a in args), **kw).to(dev)

    def mm_case(m, k, n, int4, x_view=0, want_plan=None):
        name = "quant_matmul_int4" if int4 else "quant_matmul"
        fn, plain = ((ops.quant_matmul_int4, ops.quant_matmul_int4_plain) if int4
                     else (ops.quant_matmul, ops.quant_matmul_plain))
        what = f"{name} {m}x{k}x{n} view+{x_view}"
        lo, hi = (-8, 7) if int4 else (-127, 127)
        w = torch.from_numpy(rng.randint(lo, hi + 1, (k, n)).astype(np.int8))
        wk = (ops.pack_int4(w) if int4 else w).to(dev)
        s = torch.from_numpy((2.0 ** -rng.randint(2, 6, n)).astype(np.float32)).to(dev)
        b = torch.from_numpy((rng.randint(-64, 64, n) / 16.0).astype(np.float32)).to(dev)

        def place(x):          # x as it is, or a view x_view elements off 16 bytes
            if not x_view:
                return x
            buf = torch.zeros(x.numel() + x_view, device=dev)
            buf[x_view:] = x.reshape(-1)
            return buf[x_view:].view(x.shape)
        plan = qm.qmm_launch_plan(m, k, n, int4, 0, not x_view)
        if want_plan is not None and (qm.QMM_TILE_NAMES[plan.tile], plan.split) != want_plan:
            raise AssertionError(f"{what}: plan {plan}, expected {want_plan}")
        xd = place(torch.from_numpy((rng.randint(-128, 129, (m, k)) / 128.0)
                                    .astype(np.float32)).to(dev))
        got = fn(xd, wk, s, b)
        torch.cuda.synchronize()
        if not torch.equal(got, plain(xd, wk, s, b)):
            raise AssertionError(f"{what} differs on dyadic x")
        xr = place(torch.randn(m, k, generator=torch.Generator().manual_seed(m + k + n))
                   .to(dev))
        got = fn(xr, wk, s, b)
        again = fn(xr, wk, s, b)
        want = plain(xr, wk, s, b)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls on the same x differ")
        mag = (xr.abs() @ w.to(dev).float().abs()) * s.abs()
        diff = (got - want).abs()
        if bool((diff > 2 * k * 2.0 ** -24 * mag + 2.0 ** -23 * want.abs()).any()):
            raise AssertionError(f"{what} beyond the order bound")
        err[name] = max(err[name], float(diff.max()))
        n_cases[name] += 3
        for j, (in_scale, off_grid) in enumerate(STAGINGS + ((TINY_SCALE, False),)):
            spec = specs[3 + (j + k + n) % 24] if j % 2 == 0 else specs[1 + j % 2]
            si = torch.from_numpy((2 * rng.randint(0, 5, n) + 1).astype(np.int32)).to(dev)
            xi = place(staged((m, k), in_scale, off_grid))
            kw = dict(acc_dtype=torch.int32, requant=spec, in_scale=in_scale)
            got = fn(xi, wk, si, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, twin(plain, (xi, wk, si), kw, in_scale == TINY_SCALE)):
                raise AssertionError(f"{what} integer body, in_scale={in_scale} "
                                     f"off_grid={off_grid} {spec}")
            n_cases[name] += 1
        xi = place(staged((m, k), 1.0, False))
        kw = dict(acc_dtype=torch.int32)
        got = fn(xi, wk, s, b, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, plain(xi, wk, s, b, **kw)):
            raise AssertionError(f"{what} int32 body, float32 epilogue")
        n_cases[name] += 1

    # every cluster size (K = 64 s at one 16x64 tile), then the two large tiles
    for split in range(1, 9):
        for int4 in (False, True):
            mm_case(16, 64 * split, 33, int4, want_plan=("small", split))
    for int4 in (False, True):
        mm_case(4300, 98, 65, int4, want_plan=("wide", 1))
        mm_case(8500, 28, 31, int4, want_plan=("tall", 1))
    mm_case(8500, 27, 31, False, want_plan=("tall", 1))
    mm_case(256, 784, 64, False, want_plan=("small", 7))
    for m, k, n in QMM_RAGGED:
        for int4 in (False, True) if k % 2 == 0 else (False,):
            mm_case(m, k, n, int4)
    for m, k, n in ((256, 784, 64), (16, 27, 33), (100, 130, 9)):
        for off in (1, 3):
            mm_case(m, k, n, False, x_view=off)
            mm_case(m, k + k % 2, n, True, x_view=off)
    for k in INT_KERNELS:
        err[k + "/int32"] = 0.0
    print(f"B4 / B1 redesign cases: {n_cases}", flush=True)
    return n_cases


# ------------------------------------------------------------ phases 3 + 4

_ORACLES: dict = {}


def _oracle(g, x, return_all=False, key=None):
    """The port's oracle on the CPU; with ``key`` the result is kept, so the
    integer path reuses what the float32 path computed on the same input."""
    from repro_torch.core import execute, transforms
    if key is not None and key in _ORACLES:
        return _ORACLES[key]
    out = execute(transforms.cleanup(g), {g.input_names[0]: x}, device="cpu",
                  return_all=return_all)
    if key is not None:
        _ORACLES[key] = out
    return out


def _check_plan(plan, key, int4, ops, before, needs):
    if plan.fused_counts != CENSUS[(key, int4)]:
        raise AssertionError(f"{key}: census {plan.fused_counts} != {CENSUS[(key, int4)]}")
    after = ops.launch_counts()
    for k in needs:
        if after[k] <= before[k]:
            raise AssertionError(f"{key}: kernel {k} was not launched")
    return {k: after[k] - before[k] for k in after}


def grouped_conv_graph():
    """Quant -> Conv(group 8, 64 -> 64, 3x3, pads 1, 4-bit weights) -> Relu
    -> Quant on 56x56 maps: no zoo model has a grouped conv with a channel
    multiplier, so this one puts B5 on the compiled path."""
    import numpy as np
    from repro_torch.core import GraphBuilder
    c, img, g = GCONV["c"], GCONV["img"], GCONV["groups"]
    b = GraphBuilder("GroupedConv-g8")
    x = b.add_input("x", (GCONV["n"], c, img, img))
    h = b.quant(x, 1.0 / 64, 0.0, 8)
    w = np.random.RandomState(9).randn(c, c // g, 3, 3).astype(np.float32) * 0.3
    qw = b.quant(b.add_initializer("w", w), 1.0 / 16, 0.0, 4, narrow=True)
    (h,) = b.add_node("Conv", [h, qw], 1, {"kernel_shape": [3, 3], "strides": [1, 1],
                                          "pads": [1, 1, 1, 1], "group": g})
    (h,) = b.add_node("Relu", [h], 1)
    h = b.quant(h, 1.0 / 8, 0.0, 4, signed=False)
    b.mark_output(h)
    return b.build()


def _final_matmul(graph):
    """The (activation, dequantized weight) input names of the last MatMul."""
    node = [n for n in graph.toposort() if n.op_type == "MatMul"][-1]
    return node.inputs[0], node.inputs[1]


def order_bound(xf, wf, ref):
    """Summation-order bound of a float32 product (K terms) plus one
    rounding of the result, elementwise."""
    k = xf.shape[-1]
    return 2 * k * 2.0 ** -24 * (xf.abs() @ wf.abs()) + 2.0 ** -23 * ref.abs()


def fused_engine(eng, label) -> str:
    """Phase 4 / 4': an engine compiles with the defaults, so it serves a
    fused plan with integer boundaries."""
    fs = eng.plan.fusion_stats()
    if not fs["enabled"] or fs["integer_boundaries"] <= 0:
        raise AssertionError(f"{label}: the engine's plan is not fused ({fs})")
    return f"fused plan, {fs['integer_boundaries']} integer boundaries"


def run_main_path(torch, np, dev):
    from repro_torch.core import compile_graph
    from repro_torch.core.executor import to_tensor
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.serve import CompiledGraphEngine

    needs = {"TFC-w2a2": ("quant_matmul_int4", "quant_dequant"),
             "TFC-w1a1": ("quant_matmul", "quant_dequant"),
             "CNV-w1a1": ("quant_matmul", "quant_matmul_int4", "quant_dequant"),
             "CNV-w2a2": ("quant_matmul", "quant_matmul_int4", "quant_dequant"),
             "MobileNet-w4a4": ("quant_matmul", "quant_matmul_int4", "quant_dequant",
                                "quant_depthwise_conv2d")}
    xs = {"TFC": np.random.RandomState(2).randn(64, 784).astype(np.float32),
          "CNV": np.random.RandomState(12).randn(SLOT, 3, 32, 32).astype(np.float32)}
    for key, int4 in [k for k in CENSUS if not k[0].startswith("MobileNet")]:
        g = zoo.ZOO[key]()
        x = xs[key[:3]]
        before = ops.launch_counts()
        plan = compile_graph(g, device=dev, use_int4=int4, use_analysis=False,
                             use_fusion=False)
        out = plan({"x": x}, jit=False)[plan.graph.output_names[0]]
        torch.cuda.synchronize()
        ref = _oracle(g, x, key=key)[g.output_names[0]]
        if tuple(out.shape) != (x.shape[0], 10) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{key}: bad output {tuple(out.shape)}")
        if not torch.equal(out.cpu(), ref):
            raise AssertionError(f"{key}: compiled CUDA plan differs from the oracle "
                                 f"by {float((out.cpu() - ref).abs().max())}")
        launched = _check_plan(plan, key, int4, ops, before, needs[key])
        print(f"main path {key} use_int4={int4}: bit-exact vs oracle, "
              f"fused_counts={plan.fused_counts}, launches={launched}", flush=True)

    # MobileNet-w4a4 at img 224 as the zoo builds it: its random weights
    # let every activation after the fourth conv quantize to 0, so it is
    # held bit-exact but says little past that point; the same graph with
    # its conv gains raised (zoo.rescale_conv_gains: same integer weights,
    # dyadic scales) keeps the activations live and carries the real check
    x16 = np.random.RandomState(13).randn(2 * SLOT, 3, 224, 224).astype(np.float32)
    g = zoo.build_mobilenet(4, 4, img=224)
    before = ops.launch_counts()
    plan = compile_graph(g, device=dev, use_analysis=False, use_fusion=False)
    out = plan({"x": x16[:SLOT]}, jit=False)[g.output_names[0]]
    torch.cuda.synchronize()
    if not torch.equal(out.cpu(), _oracle(g, x16[:SLOT], key="MobileNet-w4a4")[
            g.output_names[0]]):
        raise AssertionError("MobileNet-224 (zoo): compiled CUDA plan differs from the oracle")
    launched = _check_plan(plan, "MobileNet-w4a4", True, ops, before,
                           needs["MobileNet-w4a4"])
    if plan.grouped_conv_stats() != MOBILENET_224_STATS:
        raise AssertionError(f"MobileNet-224 stats {plan.grouped_conv_stats()}")
    print(f"main path MobileNet-w4a4 img 224 (zoo weights), {SLOT} rows: bit-exact vs the "
          f"CPU oracle; fused_counts={plan.fused_counts}, "
          f"grouped_conv_stats={plan.grouped_conv_stats()}, launches={launched}", flush=True)

    t0 = time.perf_counter()
    live = zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224))
    oracle = _oracle(live, x16, return_all=True, key="MobileNet-w4a4 rescaled")
    ref = oracle[live.output_names[0]]
    t_oracle = time.perf_counter() - t0
    before = ops.launch_counts()
    lplan = compile_graph(live, device=dev, use_analysis=False, use_fusion=False)
    pre, w_name = _final_matmul(lplan.graph)
    rows = []
    for i in (0, SLOT):
        env = {"x": to_tensor(x16[i:i + SLOT], dev)}
        for seg in lplan.segments:          # the plan's own loop, keeping env
            seg.run(lplan.consts, env)
        torch.cuda.synchronize()
        if not torch.equal(env[pre].cpu(), oracle[pre][i:i + SLOT]):
            raise AssertionError("MobileNet-224: the plan differs from the oracle "
                                 f"before the final MatMul ({pre})")
        rows.append(env[lplan.graph.output_names[0]].cpu())
    out = torch.cat(rows)
    if tuple(out.shape) != (2 * SLOT, 1000) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"MobileNet-224: bad output {tuple(out.shape)}")
    live_share = float((oracle[pre] != 0).float().mean())
    if live_share < 0.5:
        raise AssertionError(f"MobileNet-224 (rescaled): pooled features {live_share:.3f} "
                             "nonzero; the check would be vacuous")
    bound = order_bound(oracle[pre], oracle[w_name], ref)
    diff = (out - ref).abs()
    if bool((diff > bound).any()):
        raise AssertionError("MobileNet-224: final MatMul beyond the order bound "
                             f"({float(diff.max())})")
    launched = _check_plan(lplan, "MobileNet-w4a4", True, ops, before,
                           needs["MobileNet-w4a4"])
    print(f"main path MobileNet-w4a4 img 224 (conv gains rescaled), 2 x {SLOT} rows: "
          f"bit-exact vs the CPU oracle through the global average pool ({pre}, "
          f"{live_share:.3f} of it nonzero); final MatMul within the order bound, max diff "
          f"{float(diff.max())}, {int((diff == 0).sum())} of {diff.numel()} outputs "
          f"bit-exact; launches={launched}; CPU oracle {t_oracle:.1f} s", flush=True)

    # the grouped conv: B5 (int4) + B4, bit-exact
    gg = grouped_conv_graph()
    xg = np.random.RandomState(14).randn(*gg.inputs[0].shape).astype(np.float32)
    before = ops.launch_counts()
    gplan = compile_graph(gg, device=dev, use_analysis=False, use_fusion=False)
    gout = gplan({"x": xg}, jit=False)[gg.output_names[0]]
    torch.cuda.synchronize()
    want = {"quant_dequant": 1, "quant_conv_grouped_int4": 1}
    if gplan.fused_counts != want:
        raise AssertionError(f"grouped conv census {gplan.fused_counts} != {want}")
    if not torch.equal(gout.cpu(), _oracle(gg, xg, key="GroupedConv-g8")[
            gg.output_names[0]]):
        raise AssertionError("grouped conv: compiled CUDA plan differs from the oracle")
    after = ops.launch_counts()
    if after["quant_grouped_matmul"] <= before["quant_grouped_matmul"]:
        raise AssertionError("grouped conv: B5 was not launched")
    print(f"main path {gg.name} {tuple(xg.shape)}: bit-exact vs oracle, fused_counts="
          f"{gplan.fused_counts}, grouped_conv_stats={gplan.grouped_conv_stats()}",
          flush=True)

    # phase 3's window ends here; phase 4 (the engines, serving fused plans)
    # is counted in a window of its own
    plans = ops.launch_counts()
    ops.reset_launch_counts()
    # phase 4: serving TFC in 16-row slots, held against the oracle on the CPU
    tfc = zoo.build_tfc(2, 2)
    eng = CompiledGraphEngine(tfc, max_batch=16, device=dev, use_analysis=False,
                              report_cost=False)
    xt = np.random.RandomState(3).randn(64, 784).astype(np.float32)
    reqs = [eng.submit(r) for r in xt]
    if eng.run_pending() != 64:
        raise AssertionError("run_pending did not run 64 requests")
    got = np.stack([r.wait() for r in reqs])
    if not np.array_equal(got, _oracle(tfc, xt, key="serve TFC")[
            tfc.output_names[0]].numpy()):
        raise AssertionError("served rows differ from the oracle")
    x40 = xt[:40] * 0.5
    if not np.array_equal(eng(x40), _oracle(tfc, x40, key="serve TFC 40")[
            tfc.output_names[0]].numpy()):
        raise AssertionError("engine(x) differs from the oracle")
    if eng.n_completed != 64:
        raise AssertionError(f"engine completed {eng.n_completed}, not 64")
    print(f"serving TFC-w2a2 ({fused_engine(eng, 'TFC engine')}): 64 requests via "
          f"run_pending + one 40-row call, all rows bit-exact vs the CPU oracle; "
          f"completed={eng.n_completed}", flush=True)

    # serving MobileNet-224 (rescaled) in 8-row slots: rows equal the
    # plan's, which phase 3 held against the oracle
    meng = CompiledGraphEngine(live, max_batch=SLOT, device=dev, use_analysis=False,
                               report_cost=False)
    if meng.conv_segments_fused != 27 or meng.grouped_conv_stats != MOBILENET_224_STATS:
        raise AssertionError("MobileNet engine: conv telemetry differs")
    reqs = [meng.submit(r) for r in x16]
    if meng.run_pending() != 2 * SLOT:
        raise AssertionError(f"run_pending did not run {2 * SLOT} requests")
    served = torch.from_numpy(np.stack([r.wait() for r in reqs]))
    ragged = torch.from_numpy(meng(x16[3:8]))
    if not torch.equal(served, out) or not torch.equal(ragged, out[3:8]):
        raise AssertionError("served MobileNet rows differ from the compiled plan's")
    if bool(((served - ref).abs() > bound).any()):
        raise AssertionError("served MobileNet rows beyond the oracle's order bound")
    print(f"serving MobileNet-w4a4 img 224 (rescaled; {fused_engine(meng, 'MobileNet engine')}): "
          f"{2 * SLOT} requests via run_pending in {SLOT}-row slots + one ragged 5-row call, "
          f"every row bit-exact vs the compiled plan (fusion off) and within the CPU "
          f"oracle's order bound; "
          f"completed={meng.n_completed}", flush=True)
    return plans, ops.launch_counts(), (eng, xt), (meng, np.concatenate([x16] * 4)), \
        (lplan, x16[:SLOT])


def _check_int_plan(plan, key, ops, before, needs):
    """The integer plan's census, requant stats and kernel launches."""
    if plan.fused_counts != CENSUS_ANALYSIS[key]:
        raise AssertionError(f"{key} (int): census {plan.fused_counts} != "
                             f"{CENSUS_ANALYSIS[key]}")
    if plan.requant_stats() != REQUANT_STATS[key]:
        raise AssertionError(f"{key} (int): requant stats {plan.requant_stats()}")
    after = ops.launch_counts()
    for k in needs:
        if after[k] <= before[k]:
            raise AssertionError(f"{key} (int): kernel {k} was not launched")
    return {k: after[k] - before[k] for k in after}


MOBILENET_INT8_BODIES = 13     # B2 int8 tensor-core launches per MobileNet-224 forward


def check_b2_bodies(ops, plan, before, forwards, label, exact=None):
    """B2's launches per body since ``before`` (``ops.b2_body_counts()``):
    each forward launches the int8 tensor-core body once per segment whose
    meta chose it (``exact`` of them, where given); returns the counts."""
    after = ops.b2_body_counts()
    got = {k: after[k] - before[k] for k in after}
    per_fwd = sum(s.meta.get("b2_body") == "int8_mma" for s in plan.segments)
    if exact is not None and per_fwd != exact:
        raise AssertionError(f"{label}: {per_fwd} segments chose B2's int8 body, not {exact}")
    if got["int8_mma"] != forwards * per_fwd:
        raise AssertionError(f"{label}: {got['int8_mma']} int8-body B2 launches in "
                             f"{forwards} forwards, not {forwards} x {per_fwd}")
    return got


def run_integer_path(torch, np, dev):
    """Phases 3 + 4 on the integer path: compile_graph's defaults (the
    analysis tier and B3), every model bit-exact against the CPU oracle
    (MobileNet's float32 final MatMul within the order bound)."""
    from repro_torch.core import compile_graph
    from repro_torch.core.executor import to_tensor
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.serve import CompiledGraphEngine

    needs = {"TFC": ("quant_matmul_int4", "quant_dequant"),
             "CNV": ("quant_matmul", "quant_matmul_int4", "quant_dequant"),
             "Mob": ("quant_matmul", "quant_matmul_int4", "quant_dequant",
                     "quant_depthwise_conv2d")}
    xs = {"TFC": np.random.RandomState(2).randn(64, 784).astype(np.float32),
          "CNV": np.random.RandomState(12).randn(SLOT, 3, 32, 32).astype(np.float32)}
    for key in ("TFC-w1a1", "TFC-w1a2", "TFC-w2a2", "CNV-w1a1", "CNV-w2a2"):
        g = zoo.ZOO[key]()
        x = xs[key[:3]]
        before = ops.launch_counts()
        plan = compile_graph(g, device=dev, use_fusion=False)
        bodies = ops.b2_body_counts()
        out = plan({"x": x}, jit=False)[plan.graph.output_names[0]]
        torch.cuda.synchronize()
        bodies = check_b2_bodies(ops, plan, bodies, 1, key)
        ref = _oracle(g, x, key=key)[g.output_names[0]]
        if tuple(out.shape) != (x.shape[0], 10) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{key} (int): bad output {tuple(out.shape)}")
        if not torch.equal(out.cpu(), ref):
            raise AssertionError(f"{key} (int): compiled CUDA plan differs from the oracle "
                                 f"by {float((out.cpu() - ref).abs().max())}")
        launched = _check_int_plan(plan, key, ops, before, needs[key[:3]])
        rq = plan.requant_stats()
        print(f"integer path {key}: bit-exact vs oracle, requant {rq['int32_segments']}/"
              f"{rq['kernel_segments']} int32 segments, fused_counts={plan.fused_counts}, "
              f"launches={launched}, B2 launches by body {bodies}", flush=True)

    x16 = np.random.RandomState(13).randn(2 * SLOT, 3, 224, 224).astype(np.float32)
    g = zoo.build_mobilenet(4, 4, img=224)
    before = ops.launch_counts()
    plan = compile_graph(g, device=dev, use_fusion=False)
    bodies = ops.b2_body_counts()
    staged = ops.staging_counts()["quant_depthwise_conv2d"]
    out = plan({"x": x16[:SLOT]}, jit=False)[g.output_names[0]]
    torch.cuda.synchronize()
    bodies = check_b2_bodies(ops, plan, bodies, 1, "MobileNet-224 (zoo, int)",
                             exact=MOBILENET_INT8_BODIES)
    staged = {k: v - staged[k] for k, v in ops.staging_counts()["quant_depthwise_conv2d"].items()}
    if staged != {"reciprocal": 13, "quotient": 0, "division": 0}:
        raise AssertionError(f"MobileNet-224 (zoo, int): B6 launches by staging {staged}, "
                             "not 13 on the reciprocal")
    print(f"integer path MobileNet-w4a4 img 224: its 13 depthwise segments (B6) launched "
          f"by staging {staged}", flush=True)
    if not torch.equal(out.cpu(), _oracle(g, x16[:SLOT], key="MobileNet-w4a4")[
            g.output_names[0]]):
        raise AssertionError("MobileNet-224 (zoo, int): compiled CUDA plan differs from "
                             "the oracle")
    launched = _check_int_plan(plan, "MobileNet-w4a4", ops, before, needs["Mob"])
    print(f"integer path MobileNet-w4a4 img 224 (zoo weights), {SLOT} rows: bit-exact vs the "
          f"CPU oracle; requant 27/28 int32 segments; launches={launched}; B2 launches by "
          f"body {bodies}", flush=True)

    live = zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224))
    oracle = _oracle(live, x16, return_all=True, key="MobileNet-w4a4 rescaled")
    ref = oracle[live.output_names[0]]
    before = ops.launch_counts()
    iplan = compile_graph(live, device=dev, use_fusion=False)
    pre, w_name = _final_matmul(iplan.graph)
    final = [s for s in iplan.segments if s.kind == "quant_matmul_int4"]
    if len(final) != 1 or final[0].meta["requant_path"] != "fp32":
        raise AssertionError("MobileNet-224 (int): the final MatMul is not the one "
                             "float32 segment")
    rows = []
    for i in (0, SLOT):
        env = {"x": to_tensor(x16[i:i + SLOT], dev)}
        bodies = ops.b2_body_counts()
        for seg in iplan.segments:          # the plan's own loop, keeping env
            seg.run(iplan.consts, env)
        torch.cuda.synchronize()
        check_b2_bodies(ops, iplan, bodies, 1, "MobileNet-224 (rescaled, int)",
                        exact=MOBILENET_INT8_BODIES)
        if not torch.equal(env[pre].cpu(), oracle[pre][i:i + SLOT]):
            raise AssertionError("MobileNet-224 (int): the plan differs from the oracle "
                                 f"before the final MatMul ({pre})")
        rows.append(env[iplan.graph.output_names[0]].cpu())
    out = torch.cat(rows)
    bound = order_bound(oracle[pre], oracle[w_name], ref)
    diff = (out - ref).abs()
    if bool((diff > bound).any()) or not bool(torch.isfinite(out).all()):
        raise AssertionError("MobileNet-224 (int): final MatMul beyond the order bound "
                             f"({float(diff.max())})")
    launched = _check_int_plan(iplan, "MobileNet-w4a4 rescaled", ops, before, needs["Mob"])
    print(f"integer path MobileNet-w4a4 img 224 (conv gains rescaled), 2 x {SLOT} rows: "
          f"requant 27/28 int32 segments, bit-exact vs the CPU oracle through the global "
          f"average pool; final MatMul (float32) within the order bound, max diff "
          f"{float(diff.max())}, {int((diff == 0).sum())} of {diff.numel()} outputs "
          f"bit-exact; launches={launched}", flush=True)

    gg = grouped_conv_graph()
    xg = np.random.RandomState(14).randn(*gg.inputs[0].shape).astype(np.float32)
    before = ops.launch_counts()
    gplan = compile_graph(gg, device=dev, use_fusion=False)
    staged = ops.staging_counts()["quant_grouped_matmul"]
    gout = gplan({"x": xg}, jit=False)[gg.output_names[0]]
    torch.cuda.synchronize()
    staged = {k: v - staged[k] for k, v in ops.staging_counts()["quant_grouped_matmul"].items()}
    seg = next(s for s in gplan.segments if s.kind == "quant_conv_grouped_int4")
    if seg.meta["requant_path"] != "int32":
        raise AssertionError("grouped conv: B5's segment is not on the int32 path")
    if not torch.equal(gout.cpu(), _oracle(gg, xg, key="GroupedConv-g8")[
            gg.output_names[0]]):
        raise AssertionError("grouped conv (int): compiled CUDA plan differs from the oracle")
    launched = _check_int_plan(gplan, "GroupedConv-g8", ops, before,
                               ("quant_grouped_matmul", "quant_dequant"))
    print(f"integer path {gg.name} {tuple(xg.shape)}: B5 segment on requant_path int32, "
          f"bit-exact vs oracle, launches={launched}, B5 by staging {staged}", flush=True)

    plans = ops.launch_counts()          # phase 3's window ends; phase 4's starts
    ops.reset_launch_counts()
    # phase 4 on the integer path: the engine serves TFC-w2a2 in 16-row slots
    # and the rescaled MobileNet-224 in 8-row slots; report_cost is on
    tfc = zoo.build_tfc(2, 2)
    eng = CompiledGraphEngine(tfc, max_batch=16, device=dev)
    if eng.plan.requant_stats()["coverage"] != 1.0 or eng.cost_report is None:
        raise AssertionError("TFC engine: not on the integer path, or no cost report")
    xt = np.random.RandomState(3).randn(64, 784).astype(np.float32)
    reqs = [eng.submit(r) for r in xt]
    bodies = ops.b2_body_counts()
    if eng.run_pending() != 64:
        raise AssertionError("run_pending did not run 64 requests")
    # the engine's plan captures its one slot shape at the first slot (a
    # warm-up run and the capture: two passes through the wrappers) and
    # replays it for the other three, which launch without the wrappers
    bodies = check_b2_bodies(ops, eng.plan, bodies, 2, "TFC-w2a2 engine (int)")
    if eng.plan.trace_count != 1 or eng.plan.replay_count != 4:
        raise AssertionError(f"TFC engine: {eng.plan.trace_count} captures and "
                             f"{eng.plan.replay_count} replays, not 1 and 4")
    got = np.stack([r.wait() for r in reqs])
    if not np.array_equal(got, _oracle(tfc, xt, key="serve TFC")[
            tfc.output_names[0]].numpy()):
        raise AssertionError("served integer-path rows differ from the oracle")
    x40 = xt[:40] * 0.5
    if not np.array_equal(eng(x40), _oracle(tfc, x40, key="serve TFC 40")[
            tfc.output_names[0]].numpy()):
        raise AssertionError("engine(x) on the integer path differs from the oracle")
    rep = eng.cost_report
    print(f"serving TFC-w2a2 on the integer path ({fused_engine(eng, 'TFC engine (int)')}): "
          f"64 requests via run_pending (4 slots of 16; "
          f"B2 launches by body {bodies}) + one 40-row "
          f"call, all rows bit-exact vs the CPU oracle; cost report at load: "
          f"{len(rep.layers)} layers, {rep.macs} MACs, {rep.bops:.6g} BOPs, "
          f"{int(rep.total_weight_bits)} weight bits", flush=True)

    meng = CompiledGraphEngine(live, max_batch=SLOT, device=dev)
    if meng.plan.requant_stats() != REQUANT_STATS["MobileNet-w4a4 rescaled"] or \
            meng.cost_report is None:
        raise AssertionError("MobileNet engine: not on the integer path, or no cost report")
    reqs = [meng.submit(r) for r in x16]
    bodies = ops.b2_body_counts()
    if meng.run_pending() != 2 * SLOT:
        raise AssertionError(f"run_pending did not run {2 * SLOT} requests")
    # one capture (warm-up + capture) at the first slot, a replay for the second
    bodies = check_b2_bodies(ops, meng.plan, bodies, 2, "MobileNet-224 engine (int)",
                             exact=MOBILENET_INT8_BODIES)
    served = torch.from_numpy(np.stack([r.wait() for r in reqs]))
    ragged = torch.from_numpy(meng(x16[3:8]))
    if not torch.equal(served, out) or not torch.equal(ragged, out[3:8]):
        raise AssertionError("served integer-path MobileNet rows differ from the plan's")
    if bool(((served - ref).abs() > bound).any()):
        raise AssertionError("served MobileNet rows beyond the oracle's order bound")
    rep = meng.cost_report
    print(f"serving MobileNet-w4a4 img 224 (rescaled) on the integer path "
          f"({fused_engine(meng, 'MobileNet engine (int)')}): {2 * SLOT} "
          f"requests in {SLOT}-row slots (B2 launches by body {bodies}) + one ragged 5-row "
          f"call, every row bit-exact vs "
          f"the plan (fusion off; its rows are bit-exact vs the CPU oracle through the pool) and "
          f"within the oracle's order bound; cost report at load: {len(rep.layers)} "
          f"layers, {rep.macs} MACs, {int(rep.total_weight_bits)} weight bits", flush=True)
    return plans, ops.launch_counts(), (eng, xt), (meng, np.concatenate([x16] * 4)), \
        (iplan, x16[:SLOT])


# ------------------------------------------------ phase 2, the boundary glue

# (N, C, H, W, kernel, strides, pads, count_include_pad, zero point): CNV's two
# MaxPools (2x2 / 2 on its 28x28 and 10x10 maps of SLOT rows), padded and
# strided windows, asymmetric pads, odd last dims
POOL_CASES = [
    (SLOT, 64, 28, 28, (2, 2), (2, 2), (0, 0, 0, 0), 0, 0),
    (SLOT, 128, 10, 10, (2, 2), (2, 2), (0, 0, 0, 0), 0, 0),
    (2, 16, 9, 9, (3, 3), (1, 1), (1, 1, 1, 1), 0, 0),
    (2, 16, 9, 9, (3, 3), (1, 1), (1, 1, 1, 1), 1, 3),
    (3, 8, 13, 11, (3, 3), (2, 2), (1, 0, 1, 0), 0, -2),
    (3, 8, 13, 11, (3, 2), (1, 2), (0, 1, 0, 1), 1, 5),
    (1, 5, 7, 7, (2, 2), (1, 1), (1, 1, 1, 1), 1, 0),
]
# B4 with emit_codes at the zoo's act widths: (bits, signed, scale, rows, cols):
# the 8-bit input, CNV's 2-bit and MobileNet's 4-bit acts at their first
# conv's output size
GLUE_QDQ = [(8, True, 1 / 128, SLOT, 3 * 32 * 32), (2, False, 0.5, SLOT, 64 * 30 * 30),
            (4, False, 0.125, SLOT, 32 * 112 * 112), (1, True, 1.0, 64, 64)]


def check_glue(ops, torch, np, dev) -> int:
    """The fused path's boundary glue on the card (``kernels.quant_pool``,
    the carrier codecs of ``core/lowering/fusion.py``) ``torch.equal`` to
    the same functions on the CPU, and B4's codes output at the zoo's act
    widths equal to its twin; returns the number of cases."""
    from repro_torch.core.lowering import fusion
    from repro_torch.kernels import quant_pool as qp
    rng = np.random.RandomState(21)
    n = 0

    def same(label, fn, *args):
        nonlocal n
        got = fn(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args))
        want = fn(*args)
        if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
            raise AssertionError(f"glue {label} differs on the card")
        n += 1

    for b, c, h, w, k, st, pads, cip, zp in POOL_CASES:
        kw = dict(kernel_shape=k, strides=st, pads=pads)
        codes = torch.from_numpy(rng.randint(-128, 128, (b, c, h, w)).astype(np.int8))
        vals = (codes.float() - zp) * 2.0 ** -3              # dyadic: exact sums
        label = f"{(b, c, h, w)} k{k} s{st} p{pads} cip{cip} z{zp}"
        same(f"maxpool2d_codes {label}", lambda t: qp.maxpool2d_codes(t, **kw), codes)
        same(f"maxpool2d {label}", lambda t: qp.maxpool2d(t, **kw), vals)
        same(f"avgpool2d {label}", lambda t: qp.avgpool2d(t, count_include_pad=cip, **kw),
             vals)
        same(f"avgpool2d_codes {label}",
             lambda t: qp.avgpool2d_codes(t, 2.0 ** -3, float(zp), count_include_pad=cip,
                                          **kw), codes)
        if not torch.equal(qp.avgpool2d_codes(codes.to(dev), 2.0 ** -3, float(zp),
                                              count_include_pad=cip, **kw).cpu(),
                           qp.avgpool2d(vals, count_include_pad=cip, **kw)):
            raise AssertionError(f"glue avgpool2d_codes != avgpool2d on the card: {label}")
        # nibble packing along W: even last dims pack, odd ones are left out
        if w % 2 == 0:
            nib = torch.from_numpy(rng.randint(-8, 8, (b, c, h, w)).astype(np.int8))
            same(f"pack_codes_int4 {label}", qp.pack_codes_int4, nib)
            packed = qp.pack_codes_int4(nib)
            same(f"unpack_codes_int4 {label}", qp.unpack_codes_int4, packed)
            if not torch.equal(qp.unpack_codes_int4(packed.to(dev)).cpu(), nib):
                raise AssertionError(f"glue pack / unpack round trip on the card: {label}")
            for packed_c in (False, True):
                car = fusion.Carrier(0.5, float(zp % 3), 4, True, packed_c)
                stored = qp.pack_codes_int4(nib) if packed_c else nib
                same(f"boundary_values {car}", lambda t: fusion.boundary_values(t, car),
                     stored)
    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(4, 64)
    same("unpack_codes_int4 every byte", qp.unpack_codes_int4, every)
    # the integer path's code recovery (y on a 2^-3 grid, zero point 2)
    q = torch.from_numpy(rng.randint(0, 16, (SLOT, 4096)).astype(np.float32))
    y = (q - 2.0) * 2.0 ** -3
    for packed_c in (False, True):
        car = fusion.Carrier(2.0 ** -3, 2.0, 4, False, packed_c)
        same(f"carried_output {car}",
             lambda t: fusion.carried_output(t, car, (8.0, 2.0)), y)
    for bits, signed, scale, rows, cols in GLUE_QDQ:
        x = torch.from_numpy((rng.randn(rows, cols) * 2).astype(np.float32)).to(dev)
        s, z = torch.tensor(scale, device=dev), torch.tensor(0.0, device=dev)
        kw = dict(bit_width=bits, signed=signed, emit_codes=True)
        got = ops.quant_dequant(x, s, z, **kw)
        if got.dtype != torch.int8 or not torch.equal(got, ops.quant_dequant_plain(x, s, z, **kw)):
            raise AssertionError(f"quant_dequant emit_codes differs: {bits} bits {rows}x{cols}")
        n += 1
    torch.cuda.synchronize()
    return n


# ---------------------------------------------------- phase 3'', fused

def check_launched(counts, names, window) -> None:
    """Print one window's launch counts; fail unless each kernel of
    ``names`` launched in it."""
    print(f"launches in {window}: {counts}", flush=True)
    for k in names:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} never launched in {window}")


def fusion_census(plan) -> dict:
    """What negotiation decided and what it left interpreted."""
    return {"stats": plan.fusion_stats(),
            "fusion_kinds": {k: v for k, v in plan.fused_counts.items()
                             if k in FUSION_KINDS},
            "interp": plan.interp_op_counts()}


def step_plan(torch, plan, x, dev) -> dict:
    """The plan's own loop, keeping every tensor it makes (env)."""
    from repro_torch.core.executor import to_tensor
    env = {plan.graph.input_names[0]: to_tensor(x, dev)}
    for seg in plan.segments:
        seg.run(plan.consts, env)
    torch.cuda.synchronize()
    return env


def check_carried(torch, plan, env, label):
    """Every negotiated boundary is int8 codes (uint8 when nibble-packed),
    and no tensor the plan made left the card."""
    for name, c in plan.fusion.carriers.items():
        want = torch.uint8 if c.packed else torch.int8
        if env[name].dtype != want:
            raise AssertionError(f"{label}: boundary {name} is {env[name].dtype}, not {want}")
    for name, v in env.items():
        if isinstance(v, torch.Tensor) and v.device.type != "cuda":
            raise AssertionError(f"{label}: {name} is on {v.device}")


def run_fused_path(torch, np, dev):
    """Phase 3'': the default plans (fusion on) on both tiers, every ZOO key
    and the grouped conv: census as the reference's (CENSUS_FUSION),
    carried boundaries int8 / uint8 on the card, bit-exact against the CPU
    oracle (MobileNet's final MatMul within the order bound) and bit for
    bit equal on the card to the same plan with use_fusion=False.
    Launches are counted around each fused plan's own call only (the
    use_fusion=False plan runs outside that window).  Returns the fused
    integer MobileNet-224 (rescaled) and CNV-w1a1 plans, and the fused
    plans' launches per tier."""
    from repro_torch.core import compile_graph
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    x16 = np.random.RandomState(13).randn(2 * SLOT, 3, 224, 224).astype(np.float32)
    xs = {"TFC": np.random.RandomState(2).randn(64, 784).astype(np.float32),
          "CNV": np.random.RandomState(12).randn(SLOT, 3, 32, 32).astype(np.float32),
          "Mob": x16[:SLOT], "Gro": np.random.RandomState(14).randn(
              GCONV["n"], GCONV["c"], GCONV["img"], GCONV["img"]).astype(np.float32)}
    graphs = {k: zoo.ZOO[k] for k in zoo.ZOO}
    graphs["MobileNet-w4a4 rescaled"] = \
        lambda: zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224))
    graphs["GroupedConv-g8"] = grouped_conv_graph
    keep, counts = {}, {}
    for tier, kw in (("int", {}), ("f32", {"use_analysis": False})):
        counts[tier] = dict.fromkeys(ops.launch_counts(), 0)
        for key, build in graphs.items():
            g = build()
            x = xs[key[:3]]
            plan = compile_graph(g, device=dev, **kw)
            census = fusion_census(plan)
            want = CENSUS_FUSION[(key.split(" ")[0], tier)]
            if census != want:
                raise AssertionError(f"{key} ({tier}, fused): census {census} != {want}")
            ops.reset_launch_counts()
            env = step_plan(torch, plan, x, dev)
            launched = {k: v for k, v in ops.launch_counts().items() if v > 0}
            for k, v in launched.items():
                counts[tier][k] += v
            check_carried(torch, plan, env, f"{key} ({tier}, fused)")
            out = env[g.output_names[0]]
            off = compile_graph(g, device=dev, use_fusion=False, **kw)
            if not torch.equal(out, off({"x": x}, jit=False)[g.output_names[0]]):
                raise AssertionError(f"{key} ({tier}): the fused plan differs from the "
                                     "use_fusion=False plan on the card")
            torch.cuda.synchronize()
            if key == "MobileNet-w4a4 rescaled":
                oracle = _oracle(g, x16, return_all=True, key=key)
                pre, w_name = _final_matmul(plan.graph)
                if not torch.equal(env[pre].cpu(), oracle[pre][:SLOT]):
                    raise AssertionError(f"{key} ({tier}, fused): differs from the oracle "
                                         f"before the final MatMul ({pre})")
                ref = oracle[g.output_names[0]][:SLOT]
                bound = order_bound(oracle[pre][:SLOT], oracle[w_name], ref)
                if bool(((out.cpu() - ref).abs() > bound).any()):
                    raise AssertionError(f"{key} ({tier}, fused): final MatMul beyond the "
                                         "order bound")
                exact = "bit-exact through the pool, final MatMul within the order bound"
            else:
                ref = _oracle(g, x, key=key)[g.output_names[0]]
                if not bool(torch.isfinite(out).all()) or not torch.equal(out.cpu(), ref):
                    raise AssertionError(f"{key} ({tier}, fused): differs from the CPU oracle")
                exact = "bit-exact"
            fs = census["stats"]
            print(f"fused path {key} ({tier}): {exact} vs the CPU oracle, equal to "
                  f"use_fusion=False on the card; {fs['integer_boundaries']} integer "
                  f"boundaries ({fs['packed_boundaries']} packed), "
                  f"{fs['fused_boundary_segments']} fused boundary segments, "
                  f"{fs['boundary_bytes_saved']} boundary bytes saved a call, fusion "
                  f"segments {census['fusion_kinds']}, interpreted {census['interp']}; "
                  f"the fused plan's launches={launched}", flush=True)
            if tier == "int" and key in ("MobileNet-w4a4 rescaled", "CNV-w1a1"):
                keep[key] = (plan, off, x)
    return keep, counts


# -------------------------------------------------- phase 3''', formats

def run_formats(torch, np, dev):
    """Phase 3''': the paper's formats on the card.  ``qonnx_to_qcdq`` of
    TFC-w2a2, CNV-w2a2 and the rescaled MobileNet-w4a4 at img 224 (every
    conv on a kernel) and ``qonnx_to_quantized_op`` of TFC-w2a2, each
    compiled on CUDA (defaults) and held against the port's CPU oracle of
    the same converted graph."""
    from repro_torch.core import compile_graph, formats, passes
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    cases = [("TFC-w2a2 QCDQ", zoo.build_tfc(2, 2), formats.qonnx_to_qcdq,
              np.random.RandomState(2).randn(64, 784)),
             ("CNV-w2a2 QCDQ", zoo.build_cnv(2, 2), formats.qonnx_to_qcdq,
              np.random.RandomState(12).randn(SLOT, 3, 32, 32)),
             ("MobileNet-w4a4 (rescaled) QCDQ",
              zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224)),
              formats.qonnx_to_qcdq, np.random.RandomState(13).randn(2, 3, 224, 224)),
             ("TFC-w2a2 QOp", zoo.build_tfc(2, 2), formats.qonnx_to_quantized_op,
              np.random.RandomState(2).randn(64, 784))]
    for label, g, convert, x in cases:
        x = x.astype(np.float32)
        q = convert(passes.run_pipeline(g, "compile_prep"))
        before = ops.launch_counts()
        plan = compile_graph(q, device=dev)
        n_convs = sum(n.op_type == "Conv" for n in q.nodes)
        if plan.interp_op_counts().get("Conv", 0) or sum(
                v for k, v in plan.fused_counts.items() if k.startswith("quant_conv")) != n_convs:
            raise AssertionError(f"{label}: not every conv lowers ({plan.fused_counts})")
        env = step_plan(torch, plan, x, dev)
        check_carried(torch, plan, env, label)
        out = env[q.output_names[0]]
        oracle = _oracle(q, x, return_all=True)
        if label.startswith("MobileNet"):
            pre, w_name = _final_matmul(plan.graph)
            if not torch.equal(env[pre].cpu(), oracle[pre]):
                raise AssertionError(f"{label}: differs from the oracle before the final MatMul")
            ref = oracle[q.output_names[0]]
            bound = order_bound(oracle[pre], oracle[w_name], ref)
            if bool(((out.cpu() - ref).abs() > bound).any()):
                raise AssertionError(f"{label}: final MatMul beyond the order bound")
        elif not torch.equal(out.cpu(), oracle[q.output_names[0]]):
            raise AssertionError(f"{label}: compiled CUDA plan differs from the oracle")
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        how = " through the pool, final MatMul within the order bound" \
            if label.startswith("MobileNet") else ""
        print(f"formats {label} {tuple(x.shape)}: compiled on CUDA ({n_convs} convs, all on "
              f"kernels), equal to the CPU oracle of the converted graph{how}; "
              f"fused_counts={plan.fused_counts}, launches={launched}", flush=True)


# ------------------------------------------- phase 5, fusion on and off

GLUE_FNS = ("boundary_values", "carried_output")   # kernel segments' glue
GLUE_ROWS = {"glue/boundary_values": "dequantize on entry",
             "glue/carried_output": "codes out (recovery, packing)",
             **{f"segment/{k}": f"{k} segment" for k in FUSION_KINDS}}


def _subtree(e):
    """(kernels, device us) the aten ops under one profiler event launched
    (a kernel launched through ctypes, outside any aten op, is not
    attached to the event; the glue is aten ops only)."""
    n, us = len(e.kernels), sum(k.duration for k in e.kernels)
    for c in e.cpu_children:
        cn, cu = _subtree(c)
        n, us = n + cn, us + cu
    return n, us


def _under(e, names) -> bool:
    """Whether a profiler event runs inside a range named in ``names``."""
    p = e.cpu_parent
    while p is not None:
        if p.name in names:
            return True
        p = p.cpu_parent
    return False


def glue_profile(torch, plan, x, label, model, wall_ms, reps=5) -> dict:
    """One plan call's device time by kernel name (torch.profiler), with
    each segment and the boundary glue labelled by ``record_function``
    ranges for this profile only: the fusion segments (bipolar / pool /
    add / concat), the dequantize-on-entry and the codes-out of the kernel
    segments.  Prints busy ms, launches, ``wall_ms`` (host clock, no
    profiler, no labels) and the busy share, then the glue rows; returns
    the numbers."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.lowering import fusion
    xd = torch.from_numpy(x).cuda()

    def labelled(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    runs = [seg.run for seg in plan.segments]
    try:
        for seg, run in zip(plan.segments, runs):
            seg.run = labelled(f"segment/{seg.kind}", run)
        with mock.patch.multiple(fusion, **{n: labelled(f"glue/{n}", getattr(fusion, n))
                                            for n in GLUE_FNS}):
            for _ in range(2):
                plan({"x": xd}, jit=False)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    plan({"x": xd}, jit=False)
                torch.cuda.synchronize()
    finally:
        for seg, run in zip(plan.segments, runs):
            seg.run = run
    by_name = {}
    for e in prof.key_averages():
        # device-side kernels only: the labels' own device ranges span idle
        # time between their kernels
        if str(e.device_type).endswith("CUDA") and not e.key.startswith(("segment/", "glue/")):
            t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            by_name[e.key] = (t / reps / 1e3, e.count / reps)
    busy = sum(t for t, _ in by_name.values())
    launches = sum(n for _, n in by_name.values())
    print(f"fusion profile[{model}, {label}]: one plan call of {len(x)} rows: device busy "
          f"{busy:.6f} ms in {launches:g} launches, wall {wall_ms:.6f} ms (no profiler), busy "
          f"share {busy / wall_ms:.3f}", flush=True)
    for key, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"fusion profile[{model}, {label}]:   {t:.6f} ms in {n:g} launches  "
              f"{key[:100]}", flush=True)
    rows = {}
    for e in prof.events():
        if e.name in GLUE_ROWS and not _under(e, GLUE_ROWS):
            n, us = _subtree(e)
            r = rows.setdefault(e.name, [0, 0.0])
            r[0] += n
            r[1] += us
    glue_ms = sum(us for _, us in rows.values()) / reps / 1e3
    glue_n = sum(n for n, _ in rows.values()) / reps
    for name, (n, us) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        print(f"fusion glue[{model}, {label}]: {GLUE_ROWS[name]}: {us / reps / 1e3:.6f} ms in "
              f"{n / reps:g} launches", flush=True)
    print(f"fusion glue[{model}, {label}]: total {glue_ms:.6f} ms in {glue_n:g} launches "
          f"({glue_ms / busy if busy else 0.0:.3f} of busy)", flush=True)
    return {"busy_ms": busy, "launches": launches, "wall_ms": wall_ms,
            "glue_ms": glue_ms, "glue_launches": glue_n}


def fusion_profiles(torch, keep):
    """Phase 5 for the fused path: the MobileNet-224 integer plan call of
    SLOT rows and the CNV-w1a1 integer plan call, fusion on and off: walls
    in turns (on, off, off, on, ...), then one labelled profile of each."""
    for key, (on, off, x) in keep.items():
        model = "MobileNet-224" if key.startswith("MobileNet") else "CNV-w1a1"
        walls = walls_in_turns(torch, {"fusion on": on, "fusion off": off}, x, model=model)
        got = {lab: glue_profile(torch, p, x, lab, model, walls[lab])
               for lab, p in (("fusion on", on), ("fusion off", off))}
        a, b = got["fusion on"], got["fusion off"]
        print(f"fusion on vs off [{model}, integer path, {len(x)} rows]: busy "
              f"{a['busy_ms']:.6f} / {b['busy_ms']:.6f} ms, launches {a['launches']:g} / "
              f"{b['launches']:g}, wall {a['wall_ms']:.6f} / {b['wall_ms']:.6f} ms, glue "
              f"{a['glue_ms']:.6f} ms in {a['glue_launches']:g} launches (on)", flush=True)


def requests_per_s(eng, xs) -> float:
    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        reqs = [eng.submit(r) for r in xs]
        eng.run_pending()
        for r in reqs:
            r.wait()
        rates.append(len(xs) / (time.perf_counter() - t0))
    return statistics.median(rates)


# --------------------------------- phase 8, the captured plan and serving

SERVE_ROWS = {"TFC": 16, "CNV": SLOT, "Mob": SLOT}    # slot rows per family
SERVE_REQUESTS = 64            # requests per ZOO key through the registry


def _served_slots(np):
    """Three distinct slot inputs per family, seeded: TFC's from the 64
    rows of phase 3'', MobileNet's from its 16 (the third slot straddles
    the two), so their oracles are reused where those phases ran."""
    x64 = np.random.RandomState(2).randn(64, 784).astype(np.float32)
    x16 = np.random.RandomState(13).randn(2 * SLOT, 3, 224, 224).astype(np.float32)
    cnv = np.random.RandomState(12).randn(3 * SLOT, 3, 32, 32).astype(np.float32)
    return {"TFC": (x64, [(0, 16), (16, 32), (32, 48)]),
            "CNV": (cnv, [(0, SLOT), (SLOT, 2 * SLOT), (2 * SLOT, 3 * SLOT)]),
            "Mob": (x16, [(0, SLOT), (SLOT, 2 * SLOT), (SLOT // 2, SLOT + SLOT // 2)])}


def _served_oracle(g, key, x):
    """The CPU oracle's rows for ``x`` and, for the rescaled MobileNet, the
    order bound of its final MatMul (None where rows must be bit-exact)."""
    if key == "MobileNet-w4a4 rescaled":
        oracle = _oracle(g, x, return_all=True, key=key)
        pre, w_name = _final_matmul(g)
        ref = oracle[g.output_names[0]]
        return ref, order_bound(oracle[pre], oracle[w_name], ref)
    okey = key if key.startswith("TFC") else "served " + key
    return _oracle(g, x, key=okey)[g.output_names[0]], None


def _rows_ok(torch, got, ref, bound) -> bool:
    if bound is None:
        return torch.equal(got, ref)
    return bool((got - ref).abs().le(bound).all())


def run_captured_plans(torch, np, dev):
    """Phase 8 (a): every ZOO key (MobileNet-w4a4 also rescaled) on both
    tiers, fused plans: three distinct slots through the captured plan back
    to back before one sync, each torch.equal to the eager plan
    (``jit=False``) and to the CPU oracle (the rescaled MobileNet's final
    MatMul within the order bound); the capture's launches are those of a
    warm-up and a capture (twice an eager forward), replays run no
    wrapper, and ``trace_count`` stays at one capture over six calls.
    Every key is tried before a failure is raised.  Returns the slot
    inputs and oracle rows per key and the integer tier's launches per
    eager forward per key."""
    import gc
    from repro_torch.core import compile_graph
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    slots = _served_slots(np)
    graphs = {k: zoo.ZOO[k] for k in zoo.ZOO}
    graphs["MobileNet-w4a4 rescaled"] = \
        lambda: zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224))
    oracles, per_fwd, failures, seen_distinct = {}, {}, [], set()
    for key, build in graphs.items():
        g = build()
        x, spans = slots[key[:3]]
        ref, bound = _served_oracle(g, key, x)
        oracles[key] = (x, ref, bound)
        for tier, kw in (("int", {}), ("f32", {"use_analysis": False})):
            label = f"{key} ({tier})"
            plan = got = more = eager = None
            try:
                plan = compile_graph(g, device=dev, **kw)
                name = plan.graph.output_names[0]
                xs = [torch.from_numpy(x[a:b]) for a, b in spans]
                before = ops.launch_counts()
                eager = [plan({"x": xi}, jit=False)[name] for xi in xs]
                torch.cuda.synchronize()
                mid = ops.launch_counts()
                fwd = {k: (mid[k] - before[k]) // 3 for k in mid if mid[k] > before[k]}
                t0 = plan.trace_count
                got = [plan({"x": xi})[name] for xi in xs]    # capture + 2 replays
                torch.cuda.synchronize()
                after = ops.launch_counts()
                captured = {k: after[k] - mid[k] for k in after if after[k] > mid[k]}
                if captured != {k: 2 * v for k, v in fwd.items()}:
                    raise AssertionError(f"capture launched {captured}, not twice an eager "
                                         f"forward's {fwd}")
                more = [plan({"x": xi})[name] for xi in xs]   # three replays
                torch.cuda.synchronize()
                if ops.launch_counts() != after:
                    raise AssertionError("a replay ran a kernel wrapper")
                if plan.trace_count != t0 + 1 or plan.replay_count != 6:
                    raise AssertionError(f"{plan.trace_count - t0} captures and "
                                         f"{plan.replay_count} replays over six calls")
                for i, (a, b) in enumerate(spans):
                    for what, v in (("captured", got[i]), ("replayed", more[i])):
                        if not torch.equal(v, eager[i]):
                            raise AssertionError(f"slot {i}: {what} != eager")
                    if not _rows_ok(torch, got[i].cpu(), ref[a:b],
                                    None if bound is None else bound[a:b]):
                        raise AssertionError(f"slot {i}: differs from the CPU oracle")
                # where a model maps both slots to the same rows (the w1a1
                # keys' and MobileNet's as built, whose activations die), the
                # overwrite check of that key sees nothing; each family must
                # have keys where it does
                distinct = not torch.equal(eager[0], eager[1])
                if distinct:
                    seen_distinct.add(key[:3])
                if tier == "int":
                    per_fwd[key] = fwd
                rule = "final MatMul within the order bound" if bound is not None \
                    else "bit-exact"
                print(f"captured plan {label}: 3 distinct slots of {len(xs[0])} rows "
                      f"replayed back to back, each torch.equal to the eager plan and "
                      f"to the CPU oracle ({rule}); 1 capture, 6 calls, "
                      f"{plan.replay_count} replays; capture launches {captured} "
                      f"(warm-up + capture); slots differ: {distinct}", flush=True)
            except Exception as e:          # collected: every key is tried
                failures.append(f"{label}: {type(e).__name__}: {e}")
                print(f"captured plan {label}: FAILED {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
            plan = got = more = eager = None
            gc.collect()
            torch.cuda.empty_cache()
    if seen_distinct != set(slots):
        failures.append(f"only {sorted(seen_distinct)} had slots with distinct rows")
    if failures:
        raise AssertionError("phase 8 (a) failed:\n  " + "\n  ".join(failures))
    return oracles, per_fwd


def serve_registry(torch, np, dev, oracles, per_fwd):
    """Phase 8 (b): the seven ZOO keys in one EngineRegistry (integer tier,
    fused plans), each slot shape captured by a warm call, then
    SERVE_REQUESTS requests per key through one ServeScheduler each
    (window 2 ms, deadline 50 ms), submitted interleaved across keys; every
    row equal to the oracle's (bit-exact); one capture per engine; then a
    hot reload of TFC-w2a2 under traffic whose old plan (graphs and pool)
    is freed once drained."""
    import gc
    import weakref
    from repro_torch.models import zoo
    from repro_torch.serve import EngineRegistry, ServeScheduler

    keys = list(zoo.ZOO)
    reg = EngineRegistry(report_cost=False, device=dev)
    for key in keys:
        eng = reg.register(key, zoo.ZOO[key](), max_batch=SERVE_ROWS[key[:3]])
        eng(oracles[key][0][:1])              # capture the slot shape
    scheds = {k: ServeScheduler(reg.get(k), window_ms=2.0).start() for k in keys}
    try:
        reqs = {k: [] for k in keys}
        t0 = time.perf_counter()
        for j in range(SERVE_REQUESTS):
            for k in keys:
                x = oracles[k][0]
                reqs[k].append((j % len(x), scheds[k].submit(x[j % len(x)],
                                                             deadline_ms=50.0)))
        for k in keys:
            for _, r in reqs[k]:
                r.wait(timeout=120)
        dt = time.perf_counter() - t0
        total = 0
        for k in keys:
            _, ref, _ = oracles[k]
            for i, r in reqs[k]:
                if not np.array_equal(r.result, ref[i].numpy()):
                    raise AssertionError(f"registry {k}: served row {i} differs from "
                                         "the oracle")
            eng = reg.get(k)
            st = scheds[k].stats()
            if eng.plan.trace_count != 1:
                raise AssertionError(f"registry {k}: {eng.plan.trace_count} captures, not 1")
            launches = {n: eng.plan.replay_count * v for n, v in per_fwd[k].items()}
            total += len(reqs[k])
            print(f"registry {k}: {len(reqs[k])} requests through ServeScheduler (window "
                  f"2 ms, deadline 50 ms), every row bit-exact vs the CPU oracle; latency "
                  f"p50 {st['latency_p50_ms']:.3f} ms p99 {st['latency_p99_ms']:.3f} ms, "
                  f"{st['flushes']} flushes, {st['deadline_misses']} deadline misses; "
                  f"1 capture, {eng.plan.replay_count} replays, launches (replays x "
                  f"launches per forward) {launches}", flush=True)
        print(f"registry: {total} requests over {len(keys)} models in {dt:.6f} s: "
              f"{total / dt:.1f} requests/s", flush=True)

        # hot reload under traffic: queued requests drain through the old plan
        k = "TFC-w2a2"
        x, ref, _ = oracles[k]
        old = weakref.ref(reg.get(k).plan)
        pending = [scheds[k].submit(x[i]) for i in range(20)]
        reg.reload(k, zoo.ZOO[k]())
        for i, r in enumerate(pending):
            if not np.array_equal(r.wait(timeout=60), ref[i].numpy()):
                raise AssertionError(f"reload: request {i} differs from the oracle")
        reg.get(k)(x[:1])
        for _ in range(40):
            gc.collect()
            if old() is None:
                break
            time.sleep(0.05)
        if old() is not None:
            raise AssertionError("reload: the old plan (its graphs and pool) is still alive")
        print(f"registry reload {k} under traffic: 20 requests answered bit-exact, the old "
              f"plan freed after the drain, the new plan captured "
              f"{reg.get(k).plan.trace_count} time(s)", flush=True)
    finally:
        for s in scheds.values():
            s.stop()


def serve_splitmerge(torch, np, dev, oracles):
    """Phase 8 (c): SplitMergeFront over two workers on cuda:0, TFC-w2a2 in
    16-row slots, one worker's fault injected: no request lost, rows in
    submission order, bit-exact."""
    from repro_torch.models import zoo
    from repro_torch.serve import SplitMergeFront, device_workers

    x, ref, _ = oracles["TFC-w2a2"]
    xs = [x[j % len(x)] for j in range(SERVE_REQUESTS)]
    workers = device_workers(zoo.ZOO["TFC-w2a2"], devices=["cuda:0", "cuda:0"],
                             max_batch=16, report_cost=False)
    for w in workers:
        w.engine(x[:1])                       # capture each worker's slot in turn
    with SplitMergeFront(workers) as front:
        workers[0].inject_fault()
        rows = front.submit_wave(xs).wait(timeout=120)
        st = front.stats()
    if len(rows) != len(xs):
        raise AssertionError(f"splitmerge: {len(rows)} rows for {len(xs)} requests")
    for j, r in enumerate(rows):
        if not np.array_equal(r, ref[j % len(x)].numpy()):
            raise AssertionError(f"splitmerge: row {j} is not request {j}'s oracle row")
    if st["failed"] != ["dev0"] or st["redispatched_shards"] < 1:
        raise AssertionError(f"splitmerge: fault not seen or not re-dispatched ({st})")
    print(f"splitmerge TFC-w2a2 over 2 workers on cuda:0, fault injected in dev0: "
          f"{len(rows)} rows, none lost, in submission order, bit-exact; {st}", flush=True)


def serve_launcher():
    """Phase 8 (d): the launcher's --graph path in a subprocess, spans to a
    JSONL file: every request has its submit -> complete span with its
    queued and compute children."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        spans = Path(tmp) / "spans.jsonl"
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--graph", "TFC-w2a2",
             "--requests", str(SERVE_REQUESTS), "--trace-jsonl", str(spans)],
            env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"launcher exited {res.returncode}: {res.stderr[-3000:]}")
        recs = [json.loads(line) for line in spans.read_text().splitlines()]
    roots = [r for r in recs if r["name"] == "request"]
    kids = {}
    for r in recs:
        if r["name"] in ("queued", "compute"):
            kids.setdefault(r["parent"], set()).add(r["name"])
    if len(roots) != SERVE_REQUESTS or len({r["trace"] for r in roots}) != SERVE_REQUESTS:
        raise AssertionError(f"launcher spans: {len(roots)} request spans, not "
                             f"{SERVE_REQUESTS}")
    for r in roots:
        if r["t1"] < r["t0"] or kids.get(r["span"]) != {"queued", "compute"} or r["error"]:
            raise AssertionError(f"launcher spans: request span {r} incomplete")
    rate = [ln for ln in res.stderr.splitlines() if "req/s" in ln]
    print(f"launcher --graph TFC-w2a2 --requests {SERVE_REQUESTS} --trace-jsonl: exit 0 in "
          f"{wall:.3f} s, {len(recs)} spans, every request submit -> complete with queued "
          f"and compute; {rate[-1] if rate else ''}", flush=True)


def captured_walls(torch, np, dev):
    """Phase 8 (e): plan-call walls of the fused integer plans, captured
    against eager in the same run (10 turns each), then one profile of
    each (busy, launches) and the time of one captured call by CUDA events
    (input copy, replay, output copy)."""
    from repro_torch.core import compile_graph
    from repro_torch.models import zoo
    cases = (("TFC-w2a2", zoo.build_tfc(2, 2),
              np.random.RandomState(3).randn(16, 784).astype(np.float32)),
             ("CNV-w1a1", zoo.build_cnv(1, 1),
              np.random.RandomState(12).randn(SLOT, 3, 32, 32).astype(np.float32)),
             ("MobileNet-224", zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224)),
              np.random.RandomState(13).randn(SLOT, 3, 224, 224).astype(np.float32)))
    out = {}
    for model, g, x in cases:
        plan = compile_graph(g, device=dev)
        walls = walls_in_turns(torch, {"captured": (plan, True), "eager": plan}, x,
                               model=model)
        prof = {lab: profile_forward(torch, plan, x, f"{lab}, integer path", model, jit=j)
                for lab, j in (("captured", True), ("eager", False))}
        xd = torch.from_numpy(x).cuda()
        event_ms = _median_event_ms(lambda: plan({"x": xd}), 30)
        out[model] = {"walls": walls, "profiles": prof, "event_ms": event_ms}
        c, e = prof["captured"], prof["eager"]
        print(f"captured vs eager [{model}, integer path, fused, {len(x)} rows]: wall "
              f"{walls['captured']:.6f} / {walls['eager']:.6f} ms (median of 10 turns), "
              f"busy {c['busy_ms']:.6f} / {e['busy_ms']:.6f} ms, launches "
              f"{c['launches']:g} / {e['launches']:g} (profiler), captured call "
              f"{event_ms:.6f} ms (CUDA events)", flush=True)
    return out


def capture_failure_raises(torch, np, dev):
    """Phase 8, last: a segment that synchronizes cannot be captured; the
    call raises naming the segment and its ops, a second call raises
    again (nothing falls back to the eager path), and the device stays
    usable."""
    from repro_torch.core import compile_graph
    from repro_torch.models import zoo
    plan = compile_graph(zoo.build_tfc(2, 2), device=dev)
    seg = plan.segments[1]
    run = seg.run

    def syncing(consts, env):
        run(consts, env)
        torch.cuda.synchronize()
    seg.run = syncing
    x = np.random.RandomState(3).randn(16, 784).astype(np.float32)
    msgs = []
    for _ in range(2):
        try:
            plan({"x": x})
        except RuntimeError as e:
            msgs.append(str(e))
    if len(msgs) != 2 or not all(f"segment 1 ({seg.kind}" in m for m in msgs) or \
            plan.replay_count:
        raise AssertionError(f"capture failure: {msgs}, {plan.replay_count} replays")
    seg.run = run
    out = plan({"x": x}, jit=False)[plan.graph.output_names[0]]
    torch.cuda.synchronize()
    print(f"capture failure: raised twice, no replay, no eager fallback: "
          f"{msgs[0].splitlines()[0][:200]}; the device stays usable "
          f"({tuple(out.shape)} eager rows after)", flush=True)


def run_served_tier(torch, np, dev):
    """Phase 8: the captured plan and the serving tier, (a) to (e), then
    a capture that fails."""
    oracles, per_fwd = run_captured_plans(torch, np, dev)
    serve_registry(torch, np, dev, oracles, per_fwd)
    serve_splitmerge(torch, np, dev, oracles)
    serve_launcher()
    walls = captured_walls(torch, np, dev)
    capture_failure_raises(torch, np, dev)
    return walls


# ----------------------------------------------------------------- phase 5

def _timed(**fns) -> dict:
    """{key: device ms, key_call: call ms} for each named callable."""
    out = {}
    for key, fn in fns.items():
        call_key = "call_ms" if key == "ms" else key.replace("_ms", "_call_ms")
        out[key], out[call_key] = time_ms(fn)
    return out


def _matmul_row(ops, torch, dev, g, m, k, n, int4, shape):
    x = torch.randn(m, k, generator=g).to(dev)
    w = torch.randint(-8 if int4 else -127, 8 if int4 else 128, (k, n), generator=g,
                      dtype=torch.int8)
    wk = (ops.pack_int4(w) if int4 else w).to(dev)
    wf = w.float().to(dev)
    s = torch.full((n,), 2.0 ** -6, device=dev)
    fn = ops.quant_matmul_int4 if int4 else ops.quant_matmul
    plain = ops.quant_matmul_int4_plain if int4 else ops.quant_matmul_plain
    nbytes = 4 * m * k + (k * n // 2 if int4 else k * n) + 4 * n + 4 * m * n
    return dict(shape=shape, **_timed(ms=lambda: fn(x, wk, s),
                                      plain_ms=lambda: plain(x, wk, s),
                                      library_ms=lambda: torch.matmul(x, wf) * s),
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=2 * m * k * n / FP32_FLOPS * 1e3)


def _qdq_row(ops, torch, dev, g, rows, cols, bits, signed, scale, shape):
    x = (torch.randn(rows, cols, generator=g) * 2).to(dev)
    s, z = torch.tensor(scale, device=dev), torch.tensor(0.0, device=dev)
    kw = dict(bit_width=bits, signed=signed)
    qmin, qmax = (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1) if signed else (0, 2 ** bits - 1)
    return dict(shape=shape, **_timed(
        ms=lambda: ops.quant_dequant(x, s, z, **kw),
        plain_ms=lambda: ops.quant_dequant_plain(x, s, z, **kw),
        library_ms=lambda: torch.fake_quantize_per_tensor_affine(x, scale, 0, qmin, qmax)),
        bytes_ms=(8 * rows * cols + 8) / HBM_BYTES_PER_S * 1e3,
        ops_ms=6 * rows * cols / FP32_FLOPS * 1e3)


def timings(ops, torch, dev):
    """Per kernel, the rows of one TFC forward at M = M_TIMED."""
    g = torch.Generator().manual_seed(5)
    rows = {k: [] for k in REPLACES}
    for k, n in TFC_LAYERS:
        for int4 in (False, True):
            rows["quant_matmul_int4" if int4 else "quant_matmul"].append(
                _matmul_row(ops, torch, dev, g, M_TIMED, k, n, int4, f"{M_TIMED}x{k}x{n}"))
    for cols, bits, signed, scale in ((784, 8, True, 1 / 128), (64, 2, False, 0.5),
                                      (64, 2, False, 0.5), (64, 2, False, 0.5)):
        rows["quant_dequant"].append(_qdq_row(ops, torch, dev, g, M_TIMED, cols, bits,
                                              signed, scale, f"{M_TIMED}x{cols}"))
    return rows


QDQ_DIV = "quant_dequant (scale 0.37, the division)"


def timings_qdq_division(ops, torch, dev):
    """B4's division path: its largest MobileNet-224 row (the act Quant of
    the first pointwise conv, SLOT rows) at a scale that is no power of
    two.  Outside the sums: the zoo's act scales are powers of two."""
    g = torch.Generator().manual_seed(16)
    return {QDQ_DIV: [_qdq_row(ops, torch, dev, g, SLOT, 64 * 112 * 112, 4, False, 0.37,
                               f"{SLOT}x{64 * 112 * 112}")]}


def timings_mobilenet(ops, torch, dev):
    """Per kernel, the rows of one MobileNet-w4a4 forward at img 224 with
    SLOT rows (B5: the grouped conv of phase 3)."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(15)
    rows = {k: [] for k in REPLACES}
    rows["quant_dequant"].append(_qdq_row(ops, torch, dev, g, SLOT, 3 * 224 * 224, 8,
                                          True, 1 / 128, f"{SLOT}x{3 * 224 * 224}"))
    for kind, cin, cout, stride, h in _mobilenet_layers():
        ho = (h - 1) // stride + 1
        if kind == "conv":          # first conv: im2col K = 27 (odd): int8, B1
            m = SLOT * ho * ho
            rows["quant_matmul"].append(_matmul_row(ops, torch, dev, g, m, 27, cout, False,
                                                    f"{m}x27x{cout}"))
        elif kind == "pw":
            m = SLOT * h * h
            rows["quant_matmul_int4"].append(_matmul_row(
                ops, torch, dev, g, m, cin, cout, True, f"{m}x{cin}x{cout}"))
        else:
            x = torch.randn(SLOT, cin, h, h, generator=g).to(dev)
            taps = torch.randint(-8, 8, (9, cin), generator=g, dtype=torch.int8).to(dev)
            wf = taps.float().t().reshape(cin, 1, 3, 3).contiguous()
            s = torch.tensor(2.0 ** -6, device=dev)
            qs, qz = torch.tensor(0.125, device=dev), torch.tensor(0.0, device=dev)
            kw = dict(kernel_shape=(3, 3), strides=(stride, stride), pads=(1, 1, 1, 1),
                      relu=True, act_bits=4, act_signed=False)
            n_out = SLOT * cin * ho * ho
            rows["quant_depthwise_conv2d"].append(dict(
                shape=f"{SLOT}x{cin}x{h}x{h}/s{stride}",
                **_timed(ms=lambda: ops.quant_depthwise_conv2d(x, taps, s, None, qs, qz, **kw),
                         plain_ms=lambda: ops.quant_depthwise_conv2d_plain(
                             x, taps, s, None, qs, qz, **kw),
                         library_ms=lambda: F.conv2d(x, wf, None, stride, 1, 1, cin)),
                bytes_ms=(4 * x.numel() + 9 * cin + 4 * n_out + 12) / HBM_BYTES_PER_S * 1e3,
                ops_ms=(18 + 8) * n_out / FP32_FLOPS * 1e3))
        if kind != "dw":            # the act Quant B4 runs after conv / pointwise
            c_out = cout * ho * ho if kind == "conv" else cout * h * h
            rows["quant_dequant"].append(_qdq_row(ops, torch, dev, g, SLOT, c_out, 4, False,
                                                  0.125, f"{SLOT}x{c_out}"))
    rows["quant_matmul_int4"].append(_matmul_row(ops, torch, dev, g, SLOT, 1024, 1000, True,
                                                 f"{SLOT}x1024x1000"))
    # B5 at the grouped conv's shape: (G, M, Kg) view of its im2col matrix
    c, img, grp = GCONV["c"], GCONV["img"], GCONV["groups"]
    x = torch.randn(GCONV["n"], c, img, img, generator=g).to(dev)
    patches = ops.extract_patches(x, (3, 3), (1, 1), (1, 1, 1, 1))[0]
    m, kg, ng = patches.shape[0], c // grp * 9, c // grp
    xg = patches.view(m, grp, kg).permute(1, 0, 2)
    w = torch.randint(-8, 8, (grp, kg, ng), generator=g, dtype=torch.int8)
    wk = ops.pack_int4_grouped(w).to(dev)
    wf = w.float().to(dev)
    s = torch.full((c,), 2.0 ** -4, device=dev)
    rows["quant_grouped_matmul"].append(dict(
        shape=f"{grp}x{m}x{kg}x{ng} int4",
        **_timed(ms=lambda: ops.quant_grouped_matmul(xg, wk, s, packed=True),
                 plain_ms=lambda: ops.quant_grouped_matmul_plain(xg, wk, s, packed=True),
                 library_ms=lambda: torch.bmm(xg, wf)),
        bytes_ms=(4 * m * grp * kg + grp * kg * ng // 2 + 4 * c + 4 * m * c)
        / HBM_BYTES_PER_S * 1e3,
        ops_ms=2 * m * grp * kg * ng / FP32_FLOPS * 1e3))
    wfull = w.float().permute(0, 2, 1).reshape(c, c // grp, 3, 3).to(dev)
    conv_ms = time_ms(lambda: F.conv2d(x, wfull, None, 1, 1, 1, grp))[0]
    print(f"(library yardstick, conv only, no scale or epilogue) F.conv2d groups={grp} on "
          f"{tuple(x.shape)}: device {conv_ms:.6f} ms", flush=True)
    return rows


def _int_mm_ok(m, k, n) -> bool:
    """torch._int_mm's shape rules on CUDA (M > 16, K and N multiples of 8)."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def _timing_spec():
    """The B3 epilogue of the timed integer rows: ReLU and an unsigned 4-bit
    act Quant, as MobileNet-w4a4's layers have."""
    from repro_torch.kernels.requant import IntRequant
    return IntRequant(shift=9, relu=True, has_act=True, act_shift=6, act_zp=0, act_lo=0,
                      act_hi=15, act_out_shift=3, rounding_mode="ROUND")


def _int_matmul_row(ops, torch, dev, g, m, k, n, int4, shape, int8_codes=False,
                    in_scale=IN_SCALE, spec=_timing_spec):
    """One integer-body row; for B2 ``int8_codes`` picks the int8 tensor-core
    body (else IMAD), ``in_scale`` the staging division (IN_SCALE) or the
    exact reciprocal multiply (a power of two), and ``spec`` the epilogue
    (B3 by default; None: the float32 epilogue over the same int32 sums).
    Its library yardstick is ``torch._int_mm`` on the int8 operands where
    that call's shape rules allow, else ``torch.matmul`` on the float32
    codes (the same exact sums), the epilogue left out either way."""
    q = torch.randint(-8, 9, (m, k), generator=g, dtype=torch.int8)
    x = (q.float() * in_scale).to(dev)
    w = torch.randint(-8 if int4 else -127, 8 if int4 else 128, (k, n), generator=g,
                      dtype=torch.int8)
    wk = (ops.pack_int4(w) if int4 else w).to(dev)
    mult = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32).mul(2).add(1).to(dev)
    kw = dict(acc_dtype=torch.int32, in_scale=in_scale)
    if spec is not None:
        kw["requant"] = spec()
    else:
        mult = mult.float().mul(2.0 ** -6)
    if int8_codes:
        kw["int8_codes"] = True
    fn = ops.quant_matmul_int4 if int4 else ops.quant_matmul
    plain = ops.quant_matmul_int4_plain if int4 else ops.quant_matmul_plain
    # the twin's int8-fit check reads its result on the host, which a CUDA
    # graph cannot capture: the twin is timed without it (same arithmetic)
    plain_kw = {key: v for key, v in kw.items() if key != "int8_codes"}
    fns = dict(ms=lambda: fn(x, wk, mult, **kw), plain_ms=lambda: plain(x, wk, mult, **plain_kw))
    if _int_mm_ok(m, k, n):
        q8, w8 = q.to(dev), w.to(dev)
        fns["library_ms"] = lambda: torch._int_mm(q8, w8)
    else:                   # the same sums on the float32 codes, exact below 2^24
        qf, wf = q.float().to(dev), w.float().to(dev)
        fns["library_ms"] = lambda: torch.matmul(qf, wf)
    row = dict(shape=shape, **_timed(**fns),
               bytes_ms=(4 * m * k + (k * n // 2 if int4 else k * n) + 4 * n + 4 * m * n)
               / HBM_BYTES_PER_S * 1e3,
               ops_ms=2 * m * k * n / INT8_OPS * 1e3)
    return row


B2_INT8 = "quant_matmul_int4/int32 (int8 body, power-of-two scale)"
B2_INT8_F32 = "quant_matmul_int4/int32 (int8 body, power-of-two scale, float32 epilogue)"
B2_IMAD = "quant_matmul_int4/int32 (IMAD body)"


def int_timings(ops, torch, dev):
    """The integer bodies (B3 epilogue) at the shapes of one TFC forward at
    M = M_TIMED and of one MobileNet-w4a4 forward at img 224 with SLOT rows
    (the 27 int32 segments; the final MatMul stays float32); B5 at the
    grouped conv's shape.  B2 takes the body the lowering picks: IMAD for
    TFC's first layer (8-bit input codes), the int8 tensor-core body
    elsewhere, at IN_SCALE (the division).  Beside them, in ``b2``, the 13
    MobileNet pointwise layers on the int8 body at a power-of-two scale
    (the reciprocal multiply) and on the IMAD body (B2's integer body
    before the int8 one); in
    ``b6`` the 13 depthwise layers at a power-of-two scale (the reciprocal
    staging of the main path's scales)."""
    g = torch.Generator().manual_seed(25)
    tfc = {k + "/int32": [] for k in INT_KERNELS}
    for i, (k, n) in enumerate(TFC_LAYERS):
        for int4 in (False, True):
            tfc[("quant_matmul_int4" if int4 else "quant_matmul") + "/int32"].append(
                _int_matmul_row(ops, torch, dev, g, M_TIMED, k, n, int4, f"{M_TIMED}x{k}x{n}",
                                int8_codes=int4 and i > 0))
    mob = {k + "/int32": [] for k in INT_KERNELS}
    b2 = {B2_INT8: [], B2_INT8_F32: [], B2_IMAD: []}
    b6 = {B6_POW2: []}
    spec = _timing_spec()
    for kind, cin, cout, stride, h in _mobilenet_layers():
        ho = (h - 1) // stride + 1
        if kind == "conv":
            m = SLOT * ho * ho
            mob["quant_matmul/int32"].append(_int_matmul_row(
                ops, torch, dev, g, m, 27, cout, False, f"{m}x27x{cout}"))
        elif kind == "pw":
            m = SLOT * h * h
            shape = f"{m}x{cin}x{cout}"
            mob["quant_matmul_int4/int32"].append(_int_matmul_row(
                ops, torch, dev, g, m, cin, cout, True, shape, int8_codes=True))
            b2[B2_INT8].append(_int_matmul_row(ops, torch, dev, g, m, cin, cout, True, shape,
                                               int8_codes=True, in_scale=TC_IN_SCALES[0]))
            b2[B2_INT8_F32].append(_int_matmul_row(ops, torch, dev, g, m, cin, cout, True,
                                                   shape, int8_codes=True,
                                                   in_scale=TC_IN_SCALES[0], spec=None))
            b2[B2_IMAD].append(_int_matmul_row(ops, torch, dev, g, m, cin, cout, True, shape))
        else:
            q = torch.randint(-8, 9, (SLOT, cin, h, h), generator=g).float()
            taps = torch.randint(-8, 8, (9, cin), generator=g, dtype=torch.int8)
            mob["quant_depthwise_conv2d/int32"].append(
                _int_dw_row(ops, torch, dev, q, taps, stride, IN_SCALE, spec))
            b6[B6_POW2].append(_int_dw_row(ops, torch, dev, q, taps, stride,
                                           TC_IN_SCALES[0], spec))
    c, img, grp = GCONV["c"], GCONV["img"], GCONV["groups"]
    q = torch.randint(-8, 9, (GCONV["n"], c, img, img), generator=g).float().to(dev)
    x = q * IN_SCALE
    patches = ops.extract_patches(x, (3, 3), (1, 1), (1, 1, 1, 1))[0]
    m, kg, ng = patches.shape[0], c // grp * 9, c // grp
    xg = patches.view(m, grp, kg).permute(1, 0, 2)
    qg = ops.extract_patches(q, (3, 3), (1, 1), (1, 1, 1, 1))[0].view(m, grp, kg).permute(1, 0, 2)
    w = torch.randint(-8, 8, (grp, kg, ng), generator=g, dtype=torch.int8)
    wk = ops.pack_int4_grouped(w).to(dev)
    wf = w.float().to(dev)
    mult = torch.full((c,), 3, dtype=torch.int32, device=dev)
    kw = dict(packed=True, acc_dtype=torch.int32, requant=spec, in_scale=IN_SCALE)
    # the library yardstick: the same sums (exact in float32) on the codes,
    # without the epilogue
    mob["quant_grouped_matmul/int32"].append(dict(
        shape=f"{grp}x{m}x{kg}x{ng} int4",
        **_timed(ms=lambda: ops.quant_grouped_matmul(xg, wk, mult, **kw),
                 plain_ms=lambda: ops.quant_grouped_matmul_plain(xg, wk, mult, **kw),
                 library_ms=lambda: torch.bmm(qg, wf)),
        bytes_ms=(4 * m * grp * kg + grp * kg * ng // 2 + 4 * c + 4 * m * c)
        / HBM_BYTES_PER_S * 1e3,
        ops_ms=2 * m * grp * kg * ng / INT8_OPS * 1e3))
    return tfc, mob, b2, b6


B6_POW2 = "quant_depthwise_conv2d/int32 (power-of-two scale)"


def _int_dw_row(ops, torch, dev, q, taps, stride, in_scale, spec):
    """One B6 integer-body row (B3 epilogue) on x = q · in_scale; its
    library yardstick F.conv2d(groups=C) sums the float32 codes q (exact)
    without the epilogue."""
    import torch.nn.functional as F
    slot, cin, h = q.shape[0], q.shape[1], q.shape[2]
    ho = (h - 1) // stride + 1
    x = (q * in_scale).to(dev)
    qd, td = q.to(dev), taps.to(dev)
    wf = taps.float().t().reshape(cin, 1, 3, 3).contiguous().to(dev)
    mult = torch.full((cin,), 3, dtype=torch.int32, device=dev)
    kw = dict(kernel_shape=(3, 3), strides=(stride, stride), pads=(1, 1, 1, 1),
              acc_dtype=torch.int32, requant=spec, in_scale=in_scale)
    n_out = slot * cin * ho * ho
    return dict(shape=f"{slot}x{cin}x{h}x{h}/s{stride}",
                **_timed(ms=lambda: ops.quant_depthwise_conv2d(x, td, mult, **kw),
                         plain_ms=lambda: ops.quant_depthwise_conv2d_plain(x, td, mult, **kw),
                         library_ms=lambda: F.conv2d(qd, wf, None, stride, 1, 1, cin)),
                bytes_ms=(4 * x.numel() + 9 * cin + 4 * cin + 4 * n_out) / HBM_BYTES_PER_S * 1e3,
                ops_ms=18 * n_out / INT8_OPS * 1e3)


def profile_forward(torch, plan, x, label, model="MobileNet-224", reps=5, jit=False):
    """One plan call's device time by kernel name (torch.profiler), beside
    its wall time without the profiler: the device's busy share.  Eager
    (``jit=False``) unless ``jit`` asks for the captured CUDA graph."""
    from torch.profiler import ProfilerActivity, profile
    xd = torch.from_numpy(x).cuda()

    def run():
        for _ in range(reps):
            plan({"x": xd}, jit=jit)
        torch.cuda.synchronize()
    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for e in prof.key_averages():
        # device-side events only: an aten op repeats its kernels' time
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            by_name[e.key] = (t / reps / 1e3, e.count / reps)
    busy = sum(t for t, _ in by_name.values())
    print(f"profile[{label}]: one {model} plan call of {len(x)} rows: wall "
          f"{wall_ms:.6f} ms (no profiler), kernels {busy:.6f} ms (profiler), device busy "
          f"share {busy / wall_ms:.3f}", flush=True)
    for key, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"profile[{label}]:   {t:.6f} ms in {n:g} launches  {key[:110]}", flush=True)
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "launches": sum(n for _, n in by_name.values())}


def plan_profiles(torch, np, dev, turns=3):
    """``--plan-profiles``: only the integer plan calls' device time by
    kernel (profile_forward), TFC-w2a2 at 16 rows and the rescaled
    MobileNet-w4a4 at img 224 with SLOT rows, on the inputs of phases 3'
    and 4', ``turns`` times each.  A copy of this script in another tree
    profiles that tree's kernels, so one call can compare two trees."""
    from repro_torch.core import compile_graph
    from repro_torch.models import zoo
    tfc = compile_graph(zoo.build_tfc(2, 2), device=dev)
    mob = compile_graph(zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224)),
                        device=dev)
    xt = np.random.RandomState(3).randn(16, 784).astype(np.float32)
    xm = np.random.RandomState(13).randn(SLOT, 3, 224, 224).astype(np.float32)
    for i in range(turns):
        profile_forward(torch, tfc, xt, f"integer path, turn {i}", "TFC-w2a2")
        profile_forward(torch, mob, xm, f"integer path, turn {i}")


def walls_in_turns(torch, plans: dict, x, pairs=10, reps=5, model="MobileNet-224") -> dict:
    """Wall ms of one plan call (host clock around ``reps`` calls and a
    sync), the plans run in turns (A B, then B A, ...) ``pairs`` times;
    prints each plan's median and quartiles and returns the medians.  A
    plan is called eagerly (``jit=False``); a value ``(plan, True)`` calls
    it through its captured CUDA graph."""
    xd = torch.from_numpy(x).cuda()
    names = list(plans)
    calls = {}
    for n, p in plans.items():
        plan, jit = p if isinstance(p, tuple) else (p, False)
        calls[n] = functools.partial(plan, {"x": xd}, jit=jit)
    walls = {n: [] for n in names}
    for i in range(pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            calls[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                calls[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / reps * 1e3)
    for name, ws in walls.items():
        q = statistics.quantiles(ws, n=4)
        print(f"plan call wall[{name}], {model} {len(x)} rows, {pairs} turns: median "
              f"{statistics.median(ws):.6f} ms, quartiles {q[0]:.6f} / {q[2]:.6f} ms", flush=True)
    return {name: statistics.median(ws) for name, ws in walls.items()}


def _fmt(v) -> str:
    return "n/a" if v is None else f"{v:.6f} ms"


def report(rows, launches, err, label):
    """Print one line per timed shape; returns the per-kernel JSON entries
    (times summed over the shapes; the library time only where one call
    computes the product at every shape, else null)."""
    kernels = []
    for name, rs in rows.items():
        if not rs:
            continue
        base = name.split("/")[0].split(" (")[0]
        for r in rs:
            bound = max(r["bytes_ms"], r["ops_ms"])
            print(f"time[{label}] {name} {r['shape']}: device kernel {r['ms']:.6f} ms, plain "
                  f"{r['plain_ms']:.6f} ms, library {_fmt(r['library_ms'])}, bound "
                  f"{bound:.6f} ms ({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'}); "
                  f"per eager call: kernel {r['call_ms']:.6f} ms, plain "
                  f"{r['plain_call_ms']:.6f} ms, library {_fmt(r['library_call_ms'])}",
                  flush=True)
        by_bytes = sum(r["bytes_ms"] for r in rs if r["bytes_ms"] >= r["ops_ms"])
        by_ops = sum(r["ops_ms"] for r in rs if r["ops_ms"] > r["bytes_ms"])
        libs = [r["library_ms"] for r in rs]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[base], replaces=REPLACES[base],
            launches=launches[name], max_abs_err=err[name],
            ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
            bound_ms=by_bytes + by_ops,
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            library_ms=None if None in libs else sum(libs)))
        print(f"sum[{label}] {name} over {len(rs)} shapes: device {kernels[-1]['ms']:.6f} ms, "
              f"eager {sum(r['call_ms'] for r in rs):.6f} ms, bound "
              f"{kernels[-1]['bound_ms']:.6f} ms ({kernels[-1]['bound_by']}), plain "
              f"{kernels[-1]['plain_ms']:.6f} ms, library {_fmt(kernels[-1]['library_ms'])}",
              flush=True)
    return kernels


# ---------------------------------------------------- phase 6: the LM path

LM_ARCH = "qwen2-1.5b"
LM_B, LM_S = 4, 2048           # the prefill of (a), and the timed attention shape
LM_NEW = 16                    # the launcher's --max-new-tokens
# qwen2-1.5B at full width: layers, d_model, heads, KV heads, head_dim, d_ff, vocab
LM_SHAPE = (28, 1536, 12, 2, 128, 8960, 151936)
# Relative L2 bound on the last-token logits of B7's prefill against the
# plain attention's (the reference's chunked_attention).  The two differ
# only in the order of float32 sums inside the attention, so a bf16 output
# moves by one step here and there; under W8A8 such a step can move a code
# of the next fake quant (a bf16 x / s above 64 has steps of 0.5: half the
# codes sit on ties), and the flips compound over 28 layers.  Each bound
# lies between the sound reading and the smallest planted-fault reading
# (planted_faults: a causal mask one key late reads 0.23 and 0.17 on the
# H100, a wrong head map, scale or a missing mask about 1.3-1.4).
LM_REL_L2 = {"w8a8kv8": 0.15, "fp32": 0.05}
LM_FAULTS = ("mask one key late", "kv heads swapped", "no 1/sqrt(hd)", "no causal mask")
# card against CPU on the SMOKE config (float32 activations): the B7 path
# there sums in another order than the CPU twin, at float32 precision
LM_SMALL_REL_L2 = 1e-4


def _lm_recipe():
    from repro_torch.quantize.config import QuantRecipe
    return QuantRecipe.w_a(8.0, 8.0, kv_cache_bits=8.0)     # the launcher's default


def _finite(torch, t, shape, what):
    """Logits of the expected shape, finite, and not constant over the
    vocabulary (``_spread``)."""
    if tuple(t.shape) != tuple(shape) or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{what}: shape {tuple(t.shape)} (want {tuple(shape)}) "
                             f"or non-finite values")
    _spread(torch, t, what)


def lm_small_check(torch, dev):
    """qwen2's SMOKE config (2 layers, d 64, hd 16), float32 activations,
    one seeded init on the CPU copied to the card: prefill logits on the
    card within LM_SMALL_REL_L2 of the CPU's (the CPU path is the one the
    tests hold against the reference) and greedy tokens equal, under the
    FP32 recipe and under W8A8 with the 8-bit KV cache."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    from repro_torch.quantize.config import FP32
    from repro_torch.serve import greedy_generate
    for recipe in (FP32, _lm_recipe()):
        cfg = get_smoke_config(LM_ARCH).replace(quant=recipe)
        p_cpu = api.init_params(3, cfg, "cpu")
        p_dev = api.init_params(3, cfg, "cpu").to(dev)
        toks = torch.randint(1, cfg.vocab, (3, 9), generator=torch.Generator().manual_seed(4),
                             dtype=torch.int32)
        want, _ = api.prefill(p_cpu, {"tokens": toks}, cfg, 17)
        got, _ = api.prefill(p_dev, {"tokens": toks.to(dev)}, cfg, 17)
        _spread(torch, want, "lm small check (CPU)")
        _spread(torch, got, "lm small check (card)")
        rel = float((got.cpu() - want).norm() / want.norm())
        t_cpu = greedy_generate(p_cpu, cfg, {"tokens": toks}, 8)
        t_dev = greedy_generate(p_dev, cfg, {"tokens": toks.to(dev)}, 8).cpu()
        same = float((t_cpu == t_dev).float().mean())
        print(f"lm small check [{cfg.name}, {recipe.tag()}]: card vs CPU prefill logits rel-L2 "
              f"{rel:.3e} (bound {LM_SMALL_REL_L2}), greedy tokens equal on {same:.3f} of "
              f"{t_cpu.numel()}", flush=True)
        if rel > LM_SMALL_REL_L2 or not torch.equal(t_cpu, t_dev):
            raise AssertionError(f"LM small check {recipe.tag()}: card differs from CPU")


def _pad_left(torch, prompts):
    """The engine's slot batch: prompts left-padded with token 0."""
    S = max(len(p) for p in prompts)
    toks = torch.zeros((len(prompts), S), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = torch.as_tensor(p, dtype=torch.int32)
    return toks


def _check_slot(torch, params, cfg, prompts, results, dev, label):
    """The engine's tokens of one slot against greedy_generate on the same
    left-padded batch (the same kernels at the same shapes: equal)."""
    from repro_torch.serve import greedy_generate
    want = greedy_generate(params, cfg, {"tokens": _pad_left(torch, prompts).to(dev)},
                           LM_NEW).cpu()
    got = torch.stack(results)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: engine tokens differ from greedy_generate")


def _faulty(orig, fault):
    """The plain attention with one planted fault, as a wrong B7 would
    compute it."""
    def attn(q, k, v, **kw):
        if fault == "mask one key late":          # query i also sees key i+1
            kw["q_offset"] += 1
        elif fault == "kv heads swapped":         # a wrong GQA head map
            k, v = k.roll(1, dims=2), v.roll(1, dims=2)
        elif fault == "no 1/sqrt(hd)":
            q = q * float(q.shape[-1]) ** 0.5
        elif fault == "no causal mask":
            kw["causal"] = False
        return orig(q, k, v, **kw)
    return attn


def planted_faults(torch, api, transformer, params, toks, cfg, sound, tag):
    """The (a) comparison read again with a planted attention fault on the
    plain path, against the sound plain prefill ``sound``: each fault must
    land beyond LM_REL_L2, or the bound would not tell a wrong attention
    from a sound one."""
    for fault in LM_FAULTS:
        with mock.patch.object(transformer, "takes_flash", lambda *a, **k: False), \
                mock.patch.object(transformer, "chunked_attention",
                                  _faulty(transformer.chunked_attention, fault)):
            bad, _ = api.prefill(params, {"tokens": toks}, cfg, LM_S)
        rel = float((bad - sound).norm() / sound.norm())
        top1 = float((bad.argmax(-1) == sound.argmax(-1)).float().mean())
        print(f"lm (a) [{tag}] planted fault '{fault}': rel-L2 {rel:.4e} against the sound "
              f"plain prefill (bound {LM_REL_L2[tag]}, must exceed it), "
              f"top-1 agreement {top1:.2f}", flush=True)
        if rel <= LM_REL_L2[tag]:
            raise AssertionError(f"planted fault '{fault}' [{tag}] within the bound: {rel}")


def run_lm_path(torch, np, dev, ops):
    """Phase 6: qwen2-1.5B at full width (28 layers), W8A8 with the 8-bit
    KV cache, bf16 activations, seeded weights on the card.
    (a) prefill B=4, S=2048 with exactly 28 B7 launches and nothing else,
        held against the same prefill on the plain attention (and again
        without fake quant), relative L2 within LM_REL_L2, top-1 printed;
        then the plain prefill with planted attention faults read against
        the sound one (planted_faults);
    (b) the launcher's traffic (``python -m repro_torch.launch.serve``:
        8 requests of 4-11 tokens from default_rng(0), 16 new tokens, slots
        of 4), then the same with prompts of 512-2048 tokens through
        GenerationEngine; every result 16 tokens in the vocabulary, and
        one slot of each held against greedy_generate.
    Launch counts are set to 0 before (a) and before (b) and read after
    each.  Returns (params, cfg, tokens, launches of (b))."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import api, transformer
    from repro_torch.quantize.config import FP32
    from repro_torch.serve import GenerationEngine

    cfg = get_config(LM_ARCH).replace(quant=_lm_recipe())
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab)
    if shape != LM_SHAPE or cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name} is not qwen2-1.5B at full width: {shape}")
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, dev)
    torch.cuda.synchronize()
    print(f"lm: {cfg.name} at full width, {cfg.param_count()} float32 parameters, "
          f"{cfg.n_layers} layers, recipe {cfg.quant.tag()}, {cfg.dtype} activations; "
          f"seeded init on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    toks = torch.randint(1, cfg.vocab, (LM_B, LM_S), generator=torch.Generator().manual_seed(11),
                         dtype=torch.int32).to(dev)

    # (a) one prefill through B7, counted
    ops.reset_launch_counts()
    logits, _ = api.prefill(params, {"tokens": toks}, cfg, LM_S)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"lm (a) prefill B={LM_B} S={LM_S}: launches {counts}", flush=True)
    if counts["flash_attention"] != cfg.n_layers or sum(counts.values()) != cfg.n_layers:
        raise AssertionError(f"prefill launched {counts}, want {cfg.n_layers} x B7 only")
    _finite(torch, logits, (LM_B, cfg.vocab), "prefill logits")
    for tag, c in (("w8a8kv8", cfg), ("fp32", cfg.replace(quant=FP32))):
        a = logits if tag == "w8a8kv8" else api.prefill(params, {"tokens": toks}, c, LM_S)[0]
        # every attention call on the plain path: the reference's computation
        with mock.patch.object(transformer, "takes_flash", lambda *a, **k: False):
            b, _ = api.prefill(params, {"tokens": toks}, c, LM_S)
        rel = float((a - b).norm() / b.norm())
        top1 = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"lm (a) [{tag}]: B7 prefill vs plain-attention prefill, last-token logits "
              f"rel-L2 {rel:.4e} (bound {LM_REL_L2[tag]}), top-1 agreement {top1:.2f} "
              f"of {LM_B} rows", flush=True)
        if rel > LM_REL_L2[tag]:
            raise AssertionError(f"B7 prefill [{tag}] beyond the bound: {rel}")
        planted_faults(torch, api, transformer, params, toks, c, b, tag)
    del logits, a, b

    # (b) the launcher's traffic, then long prompts, counted together
    ops.reset_launch_counts()
    short = launcher.main(["--arch", LM_ARCH])
    rng = np.random.default_rng(0)
    eng = GenerationEngine(params, cfg, max_batch=4)
    t0 = time.perf_counter()
    long_prompts = [rng.integers(1, cfg.vocab, size=rng.integers(512, 2049)) for _ in range(8)]
    reqs = [eng.submit(p, LM_NEW) for p in long_prompts]
    eng.run_pending()
    dt = time.perf_counter() - t0
    lm_launches = ops.launch_counts()
    print(f"lm (b) launches over both traffics: {lm_launches}", flush=True)
    if lm_launches["flash_attention"] <= 0:
        raise AssertionError("B7 never launched on the LM serving path")
    n_tok = sum(int(r.result.shape[0]) for r in reqs)
    print(f"lm (b) launcher traffic ({short['requests']} requests of 4-11 tokens, slots of 4): "
          f"{short['tokens']} tokens in {short['seconds']:.3f} s, "
          f"{short['tokens_per_s']:.1f} tokens/s (host clock, first call included)", flush=True)
    print(f"lm (b) long prompts ({len(reqs)} requests of "
          f"{min(len(p) for p in long_prompts)}-{max(len(p) for p in long_prompts)} tokens, "
          f"slots of 4): {n_tok} tokens in {dt:.3f} s, {n_tok / dt:.1f} tokens/s", flush=True)
    for r in short["results"] + [r.result for r in reqs]:
        if r.shape != (LM_NEW,) or int(r.min()) < 0 or int(r.max()) >= cfg.vocab:
            raise AssertionError(f"a served result is not {LM_NEW} tokens of the vocabulary")
    rng = np.random.default_rng(0)          # the launcher's prompts, drawn again
    short_prompts = [rng.integers(1, cfg.vocab, size=rng.integers(4, 12)) for _ in range(8)]
    _check_slot(torch, params, cfg, short_prompts[:4], short["results"][:4], dev,
                "launcher slot 0")
    _check_slot(torch, params, cfg, long_prompts[4:], [r.result for r in reqs[4:]], dev,
                "long-prompt slot 1")
    print("lm (b) one slot of each traffic equals greedy_generate on its padded batch",
          flush=True)
    return params, cfg, toks, lm_launches


# ----------------------------------------------------- phase 7: LM timings

def lm_attention_timings(torch, ops, cfg, dev):
    """B7 at the prefill's attention shape (B=4, S=2048, qwen2's heads, the
    model's layout), bf16 as the model runs it and float32: kernel, twin
    and F.scaled_dot_product_attention (causal, GQA) on the same inputs,
    beside the bound (causal FLOPs 2·B·H·S²·hd at the card's peak for the
    input type, 989 TFLOP/s bf16 or 67 TFLOP/s float32, or q + k + v + out
    bytes at 3.35 TB/s).  Per launch; one prefill runs n_layers launches."""
    import torch.nn.functional as F
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device=dev).manual_seed(17)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(LM_B, LM_S, h, hd, generator=g, device=dev).to(dtype)
                   .transpose(1, 2) for h in (H, KV, KV))
        r = _timed(ms=lambda: ops.flash_attention(q, k, v),
                   plain_ms=lambda: ops.flash_attention_plain(q, k, v),
                   library_ms=lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, enable_gqa=True))
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        r["ops_ms"] = 2 * LM_B * H * LM_S ** 2 * hd / peak * 1e3
        r["bytes_ms"] = (2 * q.numel() + 2 * k.numel()) * q.element_size() / HBM_BYTES_PER_S * 1e3
        bound = max(r["ops_ms"], r["bytes_ms"])
        name = str(dtype).replace("torch.", "")
        print(f"time[lm attention {name}] B={LM_B} H={H} KV={KV} S={LM_S} hd={hd} causal, per "
              f"launch: device kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"sdpa {r['library_ms']:.6f} ms, bound {bound:.6f} ms "
              f"({'operations' if r['ops_ms'] >= r['bytes_ms'] else 'bytes'}); per eager call: "
              f"kernel {r['call_ms']:.6f} ms, plain {r['plain_call_ms']:.6f} ms, sdpa "
              f"{r['library_call_ms']:.6f} ms; x{cfg.n_layers} per prefill: kernel "
              f"{cfg.n_layers * r['ms']:.6f} ms", flush=True)
        rows[name] = r
    return rows


def _profile_lm(torch, run, label, wall_ms):
    """One call of ``run`` under torch.profiler: device time by kernel name
    and by PyTorch op, beside the call's wall time without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, by_op = {}, {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            by_name[e.key] = (t / 1e3, e.count)
        elif e.key.startswith("aten::"):
            t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            if t > 0:
                by_op[e.key] = (t / 1e3, e.count)
    busy = sum(t for t, _ in by_name.values())
    print(f"profile[{label}]: device kernels {busy:.3f} ms in "
          f"{sum(n for _, n in by_name.values())} launches (profiler), against a median "
          f"wall of {wall_ms:.3f} ms without it", flush=True)
    for key, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"profile[{label}]:   {t:.3f} ms in {n} launches  {key[:100]}", flush=True)
    # by PyTorch op (device time of the kernels each op launched; an op that
    # calls another, as aten::to calls aten::copy_, repeats its time)
    for key, (t, n) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"profile[{label}] op:   {t:.3f} ms in {n} calls  {key}", flush=True)


def lm_walls(torch, params, cfg, toks, reps=3, steps=8):
    """Prefill (B=4, S=2048) and decode-step wall times (host clock around
    work that ends in a sync; medians), then one prefill's and one decode
    step's device time by kernel name and by op (torch.profiler)."""
    from repro_torch.models import api
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": toks}, cfg, LM_S + steps + 2)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"wall[lm prefill] B={LM_B} S={LM_S}: median {statistics.median(walls):.3f} ms over "
          f"{reps} (each {', '.join(f'{w:.3f}' for w in walls)})", flush=True)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    dwalls = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.decode_step(params, cache, tok, LM_S + i, cfg)
        torch.cuda.synchronize()
        dwalls.append((time.perf_counter() - t0) * 1e3)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    print(f"wall[lm decode step] B={LM_B}, cache {LM_S}-{LM_S + steps - 1}: median "
          f"{statistics.median(dwalls):.3f} ms over {steps} steps", flush=True)
    _profile_lm(torch, lambda: api.prefill(params, {"tokens": toks}, cfg, LM_S),
                "lm prefill", statistics.median(walls))
    _profile_lm(torch, lambda: api.decode_step(params, cache, tok, LM_S + steps, cfg),
                "lm decode step", statistics.median(dwalls))
    return statistics.median(walls), statistics.median(dwalls)


def lm_kernel_entry(rows, launches, err, cfg):
    """The B7 entry of the kernels line: one prefill (n_layers launches) at
    B=4, S=2048 on the model's bf16 inputs."""
    r, L = rows["bfloat16"], cfg.n_layers
    return dict(name="flash_attention", route="cuda", source=SOURCES["flash_attention"],
                replaces=REPLACES["flash_attention"], launches=launches["flash_attention"],
                max_abs_err=err["flash_attention"], ms=L * r["ms"], plain_ms=L * r["plain_ms"],
                bound_ms=L * max(r["ops_ms"], r["bytes_ms"]),
                bound_by="operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes",
                library_ms=L * r["library_ms"])


# ----------------------------------------------------- phase 9: QAT training

TRAIN_ARGS = ["--arch", LM_ARCH, "--steps", "10"]   # the launcher's defaults otherwise
TRAIN_REL = 1e-5               # (a): loss and grad_norm, card vs CPU
TRAIN_ABS = 1e-5               # (a): parameters after 3 steps
TRAIN_MICRO = 5e-3             # (c): the reference's own microbatch bound
# (a) takes the launcher's schedule for a 3-step run: peak lr 3e-4 from the
# first step (warmup 1).  At lr 1e-3 the card and the CPU part by up to
# 1.4e-5 (ROADMAP C12: AdamW divides gradients near its eps, whose sums
# round differently on the two devices, by about eps)
TRAIN_SMALL_ARGS = ["--arch", LM_ARCH, "--smoke", "--steps", "3"]


def _state_to(torch, state, dev):
    """A train state copied onto ``dev`` (parameters, moments, counters)."""
    from repro_torch.optim.adamw import AdamWState
    opt = state["opt"]
    return {"params": copy.deepcopy(state["params"]).to(dev),
            "opt": AdamWState(opt.step.to(dev, copy=True),
                              {k: v.to(dev, copy=True) for k, v in opt.mu.items()},
                              {k: v.to(dev, copy=True) for k, v in opt.nu.items()}),
            "step": state["step"].to(dev, copy=True)}


def steps_card_vs_cpu(torch, dev, cfg, hyper, seed, stream, n):
    """``n`` train steps from one seeded state on the CPU and its copy on
    ``dev``, over the same batches of ``stream``: for each step the
    relative differences of loss and grad_norm, and its lr; then each
    parameter's max abs difference."""
    from repro_torch.data import to_device
    from repro_torch.train import loop
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the card would not compute float32 products")
    cpu = loop.init_train_state(seed, cfg, hyper, "cpu")
    card = _state_to(torch, cpu, dev)
    step = loop.make_train_step(cfg, hyper)
    rels, lrs = [], []
    for _ in range(n):
        b = stream.next()
        cpu, mc = step(cpu, to_device(b, "cpu"))
        card, md = step(card, to_device(b, dev))
        rels.append([abs(float(md[k]) / float(mc[k]) - 1) for k in ("loss", "grad_norm")])
        lrs.append(float(mc["lr"]))
    diffs = {k: float((a.detach().cpu() - b.detach()).abs().max()) for (k, a), b in
             zip(card["params"].named_parameters(), cpu["params"].parameters())}
    return rels, lrs, diffs


def train_card_vs_cpu(torch, dev):
    """Phase 9 (a): qwen2's SMOKE config (float32 activations) with the
    FP32 recipe and with W8A8, one seeded state on the CPU and its copy
    on the card, 3 steps each over the same stream: loss and grad_norm
    per step within TRAIN_REL, parameters within TRAIN_ABS."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.launch import train as launcher
    from repro_torch.quantize.config import FP32, QuantRecipe
    _, hyper = launcher.build(launcher.parse(TRAIN_SMALL_ARGS))
    for recipe in (FP32, QuantRecipe.w_a(8.0, 8.0)):
        cfg = get_smoke_config(LM_ARCH).replace(quant=recipe)
        stream = SyntheticLMStream(vocab=cfg.vocab, global_batch=4, seq_len=16, seed=1)
        rels, _, diffs = steps_card_vs_cpu(torch, dev, cfg, hyper, 5, stream, 3)
        worst = [max(r[i] for r in rels) for i in range(2)]
        dp = max(diffs.values())
        top = sorted(diffs.items(), key=lambda kv: -kv[1])[:4]
        print(f"train (a) [{cfg.name}, {recipe.tag()}, lr {hyper.peak_lr} from step 1] card vs "
              f"CPU over 3 steps: loss rel "
              f"{worst[0]:.3e}, grad_norm rel {worst[1]:.3e} (bound {TRAIN_REL}), parameters "
              f"max abs {dp:.3e} (bound {TRAIN_ABS}); largest {top}", flush=True)
        if max(worst) > TRAIN_REL or dp > TRAIN_ABS:
            raise AssertionError(f"train (a) {recipe.tag()}: the card differs from the CPU")


def _ranged(torch, fn, label):
    """``fn`` inside a profiler range named ``label``."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return wrapped


def _profile_train_step(torch, step, state, batch, wall_ms):
    """One full-width train step under torch.profiler, with ranges around
    the forward and loss, the fake quant's and the attention's calls (in
    the forward and again in the backward's recompute) and AdamW: busy
    time (the kernels' device time) against the step's wall without the
    profiler; the kernels' device time inside each range (kernels that
    start within the range's spans on the device timeline; the backward
    runs on autograd's thread, outside the ranges: it is the rest); then
    the top kernels by name, the top ops by the device time of the kernels
    each launches itself, and autograd's backward nodes."""
    import bisect
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer
    from repro_torch.quantize import layers
    from repro_torch.train import loop
    ranges = {"train: forward + loss": (loop, "loss_fn"),
              "train: fake quant (forward and recompute)": (layers, "_fake_quant"),
              "train: attention (forward and recompute)": (transformer, "chunked_attention"),
              "train: adamw": (loop, "adamw_update")}
    with contextlib.ExitStack() as stack:
        for label, (mod, name) in ranges.items():
            stack.enter_context(mock.patch.object(
                mod, name, _ranged(torch, getattr(mod, name), label)))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, batch)
            torch.cuda.synchronize()
    on_device = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    kernels = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in on_device
                     if e.name not in ranges)
    starts = [k[0] for k in kernels]
    busy = sum(d for _, d in kernels) / 1e3
    print(f"profile[train step]: device kernels {busy:.3f} ms in {len(kernels)} launches "
          f"(profiler), against a median wall of {wall_ms:.3f} ms without it: busy share "
          f"{busy / wall_ms:.3f}", flush=True)
    inside = {}
    for label in ranges:
        spans = [e.time_range for e in on_device if e.name == label]
        inside[label] = sum(d for r in spans for _, d in kernels[
            bisect.bisect_left(starts, r.start):bisect.bisect_left(starts, r.end)]) / 1e3
        print(f"profile[train step] range: {inside[label]:.3f} ms of kernels in {len(spans)} "
              f"spans  {label}", flush=True)
    rest = busy - inside["train: forward + loss"] - inside["train: adamw"]
    print(f"profile[train step] range: {rest:.3f} ms of kernels, the rest: the backward with "
          f"its recompute (and the schedule)", flush=True)
    by_name, by_op, by_node = {}, {}, {}
    for e in prof.key_averages():
        if e.key in ranges:
            continue
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            by_name[e.key] = (t / 1e3, e.count)
        elif e.key.startswith("aten::"):
            t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            by_op[e.key] = (t / 1e3, e.count)
        elif e.key.startswith("autograd::engine::evaluate_function: "):
            t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            by_node[e.key.split(": ", 1)[1]] = (t / 1e3, e.count)
    for title, table, n_top in (("", by_name, 12), (" op", by_op, 14),
                                (" backward node", by_node, 10)):
        for key, (t, n) in sorted(table.items(), key=lambda kv: -kv[1][0])[:n_top]:
            print(f"profile[train step]{title}:   {t:.3f} ms in {n} "
                  f"{'launches' if not title else 'calls'}  {key[:100]}", flush=True)
    return state, busy


def train_full_width(torch, dev, ops):
    """Phase 9 (b): qwen2-1.5B at full width (28 layers, d 1536, vocab
    151936), float32 parameters, bf16 activations, W8A8 QAT with the
    launcher's defaults (global batch 16, seq 128, remat on, peak lr 3e-4,
    warmup min(100, steps // 10 + 1)), 10 steps from init_params over
    SyntheticLMStream(seed=0), launch counts set to 0 before them and
    read after: no kernel of the port launches (B7 is forward only).
    Then one profiled step, one step with compress_grads and the
    error-feedback invariant on the next gradient, and a prefill through
    28 B7 launches."""
    from repro_torch.data import SyntheticLMStream, to_device
    from repro_torch.launch import train as launcher
    from repro_torch.models import api
    from repro_torch.optim.compress import CompressState, compress_init, compressed_grads
    from repro_torch.train import loop

    args = launcher.parse(TRAIN_ARGS)
    cfg, hyper = launcher.build(args)
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab)
    if shape != LM_SHAPE or cfg.dtype != "bfloat16" or not cfg.remat:
        raise AssertionError(f"{cfg.name} is not qwen2-1.5B at full width with remat: {shape}")
    B, S = args.global_batch, args.seq
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = loop.init_train_state(0, cfg, hyper, dev)
    torch.cuda.synchronize()
    print(f"train (b): {cfg.name} at full width, {cfg.param_count()} float32 parameters, "
          f"recipe {cfg.quant.tag()}, {cfg.dtype} activations, remat {cfg.remat}, B={B} S={S}, "
          f"peak lr {hyper.peak_lr}, warmup {hyper.warmup_steps} of {hyper.total_steps} steps; "
          f"train state on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    stream = SyntheticLMStream(vocab=cfg.vocab, global_batch=B, seq_len=S, seed=0)
    step = loop.make_train_step(cfg, hyper)
    walls, metrics = [], []
    ops.reset_launch_counts()
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, to_device(stream.next(), dev))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    print(f"train (b) losses {['%.5f' % v for v in losses]}", flush=True)
    print(f"train (b) grad_norm {['%.5f' % v for v in gnorms]}", flush=True)
    print(f"train (b) launches over {args.steps} steps: {counts}", flush=True)
    if not all(math.isfinite(v) for v in losses + gnorms):
        raise AssertionError("train (b): a loss or grad_norm is not finite")
    if not losses[-1] < losses[0] or min(gnorms) <= 0:
        raise AssertionError(f"train (b): loss did not fall ({losses[0]} -> {losses[-1]}) "
                             f"or a grad_norm is 0")
    if counts["flash_attention"] != 0 or sum(counts.values()) != 0:
        raise AssertionError(f"train (b): the train step launched {counts}; B7 must not run")
    wall = statistics.median(walls[2:])
    print(f"train (b) step wall: median {wall:.3f} ms over steps 3-{args.steps} (each "
          f"{', '.join(f'{w:.3f}' for w in walls)}); {B * S / wall * 1e3:.1f} tokens/s; peak "
          f"memory {peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated) [{card_line()}]",
          flush=True)
    state, busy = _profile_train_step(torch, step, state, to_device(stream.next(), dev), wall)
    # the step reads nothing back: one more under the sync checker
    batch = to_device(stream.next(), dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("train (b) one step under torch.cuda.set_sync_debug_mode('error'): no host "
          "sync", flush=True)

    # compress_grads: one step that fills the residual, then the invariant
    # compressed + new residual == grad + old residual, leaf by leaf
    hyper_c = dataclasses.replace(hyper, compress_grads=True)
    named = dict(state["params"].named_parameters())
    state["compress"] = compress_init(named)
    state, m = loop.make_train_step(cfg, hyper_c)(state, to_device(stream.next(), dev))
    loss, _ = loop.loss_fn(state["params"], to_device(stream.next(), dev), cfg, hyper_c)
    grads = torch.autograd.grad(loss, list(named.values()))
    worst = 0.0
    for (k, _), g in zip(named.items(), grads):
        old = state["compress"].residual[k]
        comp, new = compressed_grads({k: g}, CompressState({k: old}))
        want = g.float() + old
        err = float((comp[k] + new.residual[k] - want).abs().max())
        bound = 2.0 ** -22 * float(want.abs().max())
        worst = max(worst, err / max(bound, 1e-30))
        if err > bound:
            raise AssertionError(f"train (b) compress: leaf {k} off by {err} (bound {bound})")
    print(f"train (b) compress_grads step: loss {float(m['loss']):.5f}; on the next gradient "
          f"compressed + new residual == grad + old residual on all {len(named)} leaves, "
          f"worst {worst:.3f} of the bound 2^-22 x max|grad + residual|; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    del grads, loss

    # the trained parameters still serve through B7
    ops.reset_launch_counts()
    toks = to_device(stream.next(), dev)["tokens"][:1]
    logits, _ = api.prefill(state["params"], {"tokens": toks}, cfg, S)
    torch.cuda.synchronize()
    n = ops.launch_counts()["flash_attention"]
    _finite(torch, logits, (1, cfg.vocab), "prefill logits after training")
    print(f"train (b) a prefill of the trained model (B=1 S={S}): {n} B7 launches", flush=True)
    if n != cfg.n_layers:
        raise AssertionError(f"train (b): the prefill launched B7 {n} times, not {cfg.n_layers}")
    return wall, peak


def train_microbatches(torch, dev):
    """Phase 9 (c): qwen2's SMOKE config on the card, microbatches=2
    against 1 on the same batch: parameters within TRAIN_MICRO."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    from repro_torch.train import loop
    cfg = get_smoke_config(LM_ARCH)
    batch = api.make_batch(torch.Generator().manual_seed(1), cfg, 4, 8, dev)
    out = []
    for mbs in (1, 2):
        hyper = loop.TrainHyper(microbatches=mbs, z_loss=0.0)
        state = loop.init_train_state(1, cfg, hyper, dev)
        state, _ = loop.make_train_step(cfg, hyper)(state, batch)
        out.append(list(state["params"].parameters()))
    d = max(float((a - b).detach().abs().max()) for a, b in zip(*out))
    print(f"train (c) microbatches 2 vs 1 on the card: parameters max abs {d:.3e} "
          f"(bound {TRAIN_MICRO})", flush=True)
    if d > TRAIN_MICRO:
        raise AssertionError(f"train (c): microbatches disagree by {d}")


def train_launcher(torch):
    """Phase 9 (d): ``python -m repro_torch.launch.train --arch qwen2-1.5b
    --smoke --steps 6 --global-batch 2 --seq 16 --ckpt-every 3`` in a
    subprocess on the card; then the same run in this process with a fault
    injected at step 4: it restarts, restores step 3 with the stream's
    state and re-runs steps 4-6, whose losses match the uninterrupted
    run's within rel 1e-5.  Only SMOKE checkpoints are written."""
    import os
    import tempfile
    from repro_torch.dist import fault
    from repro_torch.launch import train as launcher
    args = ["--arch", LM_ARCH, "--smoke", "--steps", "6", "--global-batch", "2", "--seq", "16",
            "--ckpt-every", "3"]
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                              "--ckpt-dir", str(Path(tmp) / "a")],
                             env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"train launcher exited {res.returncode}: {res.stderr[-3000:]}")
        full = json.loads(res.stdout.strip().splitlines()[-1])
        real, calls = launcher.make_train_step, []

        def crashing(cfg, hyper):
            fn = real(cfg, hyper)

            def step(state, batch):
                calls.append(int(state["step"]))
                if len(calls) == 4:
                    raise RuntimeError("injected fault at step 4")
                return fn(state, batch)
            return step
        with mock.patch.object(launcher, "make_train_step", crashing), \
                mock.patch.object(fault.RestartPolicy, "delay_s", lambda *a: 0.0):
            resumed = launcher.main(args + ["--ckpt-dir", str(Path(tmp) / "b")])
    rel = max(abs(resumed["losses"][s] / full["losses"][str(s)] - 1) for s in (4, 5, 6))
    print(f"train (d) launcher --smoke --steps 6 --ckpt-every 3 on the card: exit 0 in "
          f"{wall:.3f} s, losses {full['losses']}; with a fault at step 4 it restarted, "
          f"resumed from step {resumed['start']} (calls {calls}); steps 4-6 loss rel {rel:.3e} "
          f"(bound 1e-5)", flush=True)
    if resumed["start"] != 3 or calls != [0, 1, 2, 3, 3, 4, 5] or rel > 1e-5:
        raise AssertionError("train (d): kill and resume did not reproduce the run")


def run_training(torch, dev, ops):
    """Phase 9: the QAT training path, (a) to (d)."""
    train_card_vs_cpu(torch, dev)
    wall, peak = train_full_width(torch, dev, ops)
    torch.cuda.empty_cache()
    train_microbatches(torch, dev)
    train_launcher(torch)
    return wall, peak


# ---------------------------------------------------------------- phase 10

TUNE_GATE = 0.90                # tuned plan throughput / heuristic's, at least
TUNE_TURNS = 8                  # interleaved turns of the speed gate


def _sig_text(sig) -> str:
    body = f" {sig.body}" if sig.body else ""
    groups = f" G={sig.groups}" if sig.groups > 1 else ""
    geo = f" geometry {tuple(sig.geometry)}" if sig.geometry else ""
    return (f"{sig.family}{body} m={sig.m} n={sig.n} k={sig.k}{groups} "
            f"bits={sig.bits} {sig.requant}{geo}")


TUNE_ROWS = {"TFC-w2a2": 64, "CNV-w1a1": SLOT, "MobileNet-w4a4": SLOT}
# the kernels each tuned plan's eager call must launch
TUNE_KERNELS = {"TFC-w2a2": ("quant_dequant", "quant_matmul_int4"),
                "CNV-w1a1": ("quant_dequant", "quant_matmul", "quant_matmul_int4"),
                "MobileNet-w4a4": ("quant_dequant", "quant_matmul", "quant_matmul_int4",
                                   "quant_depthwise_conv2d")}


def _tune_models(np):
    """Phase 10's models: (name, graph builder, input, CPU-oracle key), each
    graph declared at the rows it is called with (TUNE_ROWS), so that its
    signatures' row buckets are those of the calls and the tuned geometry
    runs (a call in another bucket runs the heuristic)."""
    from repro_torch.models import zoo
    rows = TUNE_ROWS
    return (("TFC-w2a2", lambda: zoo.build_tfc(2, 2, batch=rows["TFC-w2a2"]),
             np.random.RandomState(21).randn(rows["TFC-w2a2"], 784).astype(np.float32),
             "tune TFC-w2a2"),
            ("CNV-w1a1", lambda: zoo.build_cnv(1, 1, batch=rows["CNV-w1a1"]),
             np.random.RandomState(22).randn(rows["CNV-w1a1"], 3, 32, 32).astype(np.float32),
             "tune CNV-w1a1"),
            ("MobileNet-w4a4", lambda: zoo.rescale_conv_gains(
                zoo.build_mobilenet(4, 4, img=224, batch=rows["MobileNet-w4a4"])),
             np.random.RandomState(23).randn(rows["MobileNet-w4a4"], 3, 224, 224)
             .astype(np.float32), "tune MobileNet-w4a4 rescaled"))


def _tuned_vs_oracle(torch, plan, g, x, okey, n, label):
    """Hold a plan against the CPU oracle as phase 3 does, on ``x[:n]``:
    bit-exact, or for the rescaled MobileNet bit-exact before its final
    MatMul and that within the order bound.  Returns the plan's env
    (eager)."""
    env = step_plan(torch, plan, x[:n], plan.device)
    out = env[g.output_names[0]]
    if okey.endswith("rescaled"):
        oracle = _oracle(g, x, return_all=True, key=okey)
        pre, w_name = _final_matmul(plan.graph)
        ref = oracle[g.output_names[0]][:n]
        if not torch.equal(env[pre].cpu(), oracle[pre][:n]) or bool(
                ((out.cpu() - ref).abs() > order_bound(oracle[pre][:n], oracle[w_name],
                                                       ref)).any()):
            raise AssertionError(f"{label}: differs from the CPU oracle")
    elif not torch.equal(out.cpu(), _oracle(g, x, key=okey)[g.output_names[0]][:n]):
        raise AssertionError(f"{label}: differs from the CPU oracle")
    return env


def _f32_split_bound(torch, plan_log, dev) -> int:
    """B1 / B2's float32 body with each searched winner that differs from
    the heuristic, on randn x at the signature's shape: within the order
    bound of the heuristic's output (a K split reorders the float32 sums).
    Returns the cases."""
    from repro_torch.kernels import ops
    n = 0
    for rec in plan_log:
        sig = rec["sig"]
        if sig.family != "matmul" or sig.body != "f32" or rec["blocks"] == rec["default"]:
            continue
        g = torch.Generator().manual_seed(n)
        x = torch.randn(sig.m, sig.k, generator=g)
        w = torch.randint(-7, 8, (sig.k, sig.n), generator=g, dtype=torch.int8)
        s = torch.rand(sig.n, generator=g) + 0.5
        fn, wk = (ops.quant_matmul_int4, ops.pack_int4(w)) if sig.bits == 4 else \
            (ops.quant_matmul, w)
        xd, wd, sd = x.to(dev), wk.to(dev), s.to(dev)
        got = fn(xd, wd, sd, blocks=rec["blocks"])
        want = fn(xd, wd, sd, blocks=rec["default"])
        bound = 2 * sig.k * 2.0 ** -24 * (x.abs() @ w.float().abs()) * s \
            + 2.0 ** -23 * want.abs().cpu()
        torch.cuda.synchronize()
        if bool(((got - want).abs().cpu() > bound).any()):
            raise AssertionError(f"float32 body {_sig_text(sig)}: blocks {rec['blocks']} "
                                 f"beyond the order bound of {rec['default']}")
        n += 1
    return n


def _print_search(model, tier, plan, wall):
    st = plan.tuning_stats()
    log = plan.tune_log
    print(f"tune search [{model}, {tier}]: {len(log)} sigs searched in {wall:.3f} s "
          f"wall (compile included), candidates timed per sig "
          f"{[r['candidates'] for r in log]}; stats {st}", flush=True)
    for r in log:
        flag = "" if r["blocks"] == r["default"] else "  <- differs"
        print(f"  {_sig_text(r['sig'])}: heuristic {r['default']} {r['default_ms']:.6f} ms, "
              f"tuned {r['blocks']} {r['ms']:.6f} ms ({r['candidates']} timed){flag}",
              flush=True)


def _tune_one(torch, np, dev, root, model, g, x, okey):
    """Phase 10 (a)-(d) on one model."""
    from repro_torch.core import compile_graph
    from repro_torch.kernels import ops
    n = TUNE_ROWS[model]
    # (a) search
    t0 = time.perf_counter()
    tuned = compile_graph(g, tune="search", tune_cache_dir=root, device=dev)
    _print_search(model, "integer path", tuned, time.perf_counter() - t0)
    st = tuned.tuning_stats()
    if st["tuned_segments"] != st["kernel_segments"] or st["misses"] or \
            st["searched"] != len(tuned.tune_log) or not st["searched"]:
        raise AssertionError(f"{model}: search stats {st}")
    # (b) warm: no search, no miss, the manifest answers every segment
    warm = compile_graph(g, tune="cached", tune_cache_dir=root, device=dev)
    ws = warm.tuning_stats()
    if ws["searched"] or ws["misses"] or ws["graph_hit"] != 1 or \
            ws["tuned_segments"] != ws["kernel_segments"] or \
            ws["kernel_segments"] != st["kernel_segments"]:
        raise AssertionError(f"{model}: warm compile {ws}")
    # (c) parity: the heuristic plan, itself, the oracle
    heur = compile_graph(g, device=dev)
    xd = torch.from_numpy(x[:n]).to(dev)
    a = warm({"x": xd})[g.output_names[0]]
    b = warm({"x": xd})[g.output_names[0]]
    h = heur({"x": xd})[g.output_names[0]]
    torch.cuda.synchronize()
    if warm.trace_count != 1 or not torch.equal(a, b) or not torch.equal(a, h):
        raise AssertionError(f"{model}: the tuned plan made {warm.trace_count} captures, "
                             "or differs from itself or from the heuristic plan")
    ops.reset_launch_counts()
    _tuned_vs_oracle(torch, warm, g, x, okey, n, f"{model} tuned")
    check_launched(ops.launch_counts(), TUNE_KERNELS[model],
                   f"phase 10 ({model}, the tuned plan's eager call)")
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    # the float32-epilogue tier from the same root
    t0 = time.perf_counter()
    tf = compile_graph(g, use_analysis=False, tune="search", tune_cache_dir=root,
                       device=dev)
    _print_search(model, "float32 epilogue", tf, time.perf_counter() - t0)
    hf = compile_graph(g, use_analysis=False, device=dev)
    ef = _tuned_vs_oracle(torch, tf, g, x, okey, n, f"{model} tuned, float32 epilogue")
    eh = step_plan(torch, hf, x[:n], dev)
    out_f, out_h = ef[g.output_names[0]], eh[g.output_names[0]]
    if okey.endswith("rescaled"):
        pre, w_name = _final_matmul(tf.graph)
        w = _oracle(g, x, return_all=True, key=okey)[w_name]
        same = torch.equal(ef[pre], eh[pre]) and not bool(
            ((out_f - out_h).abs().cpu() > order_bound(eh[pre].cpu(), w, out_h.cpu())).any())
    else:
        same = torch.equal(out_f, out_h)
    if not same:
        raise AssertionError(f"{model}: the tuned float32-epilogue plan differs from the "
                             "heuristic one beyond the order bound")
    n_f32 = _f32_split_bound(torch, tf.tune_log, dev)
    # (d) the speed gate: captured plan calls in turns
    walls = walls_in_turns(torch, {"tuned": (warm, True), "heuristic": (heur, True)},
                           x[:n], pairs=TUNE_TURNS, reps=20, model=model)
    ratio = walls["heuristic"] / walls["tuned"]
    print(f"tune [{model}]: warm compile {ws['hits']} hits, 0 searches, 0 misses, graph "
          f"hit, 1 capture over 2 calls; tuned == heuristic plan (torch.equal) and held "
          f"against the CPU oracle on both tiers ({n_f32} float32 winners on randn within "
          f"the order bound); the tuned plan's eager launches {launched}; speed gate: "
          f"heuristic {walls['heuristic']:.6f} ms / tuned {walls['tuned']:.6f} ms median "
          f"plan call = {ratio:.4f} of the heuristic's throughput (gate {TUNE_GATE})",
          flush=True)
    if ratio < TUNE_GATE:
        raise AssertionError(f"{model}: the tuned plan runs at {ratio:.4f} of the "
                             f"heuristic's throughput (< {TUNE_GATE})")


def _tune_serving(torch, np, dev, root, g, x, okey):
    """Phase 10 (e): an engine serves TFC-w2a2 (declared at 64 rows) from
    the cache the search filled, in 64-row slots; the launcher serves the
    zoo's TFC-w2a2 (declared at one row) after one search of that graph."""
    import os
    from repro_torch.core import compile_graph
    from repro_torch.models import zoo
    from repro_torch.serve import CompiledGraphEngine
    rows = TUNE_ROWS["TFC-w2a2"]
    eng = CompiledGraphEngine(g, max_batch=rows, tune="cached", tune_cache_dir=root,
                              device=dev, report_cost=False)
    es = eng.plan.tuning_stats()
    hits = eng.metrics.counter("serve_tune_cache_hits_total",
                               labels=eng._metric_labels).value
    if es["graph_hit"] != 1 or es["searched"] or es["misses"] or \
            es["tuned_segments"] != es["kernel_segments"] or hits != es["hits"]:
        raise AssertionError(f"engine: tuning {es}, {hits} hits counted")
    reqs = [eng.submit(r) for r in x[:40]]
    eng.run_pending()
    got = np.stack([r.wait(timeout=120) for r in reqs])
    ref = _oracle(g, x, key=okey)[g.output_names[0]][:40].numpy()
    if not np.array_equal(got, ref):
        raise AssertionError("engine: tuned rows differ from the CPU oracle")
    eng.close()
    t0 = time.perf_counter()
    one = compile_graph(zoo.ZOO["TFC-w2a2"](), tune="search", tune_cache_dir=root,
                        device=dev)
    _print_search("TFC-w2a2 as the zoo declares it (one row)", "integer path", one,
                  time.perf_counter() - t0)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--graph", "TFC-w2a2",
         "--requests", "16", "--tune", "cached", "--tune-cache-dir", root],
        env=env, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"launcher --tune cached exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    line = [ln for ln in res.stderr.splitlines() if "tune[cached]" in ln]
    k = es["kernel_segments"]
    if not line or f"{k}/{k} segments tuned" not in line[-1] or \
            "manifest hit" not in line[-1]:
        raise AssertionError(f"launcher --tune cached: {line}")
    rate = [ln for ln in res.stderr.splitlines() if "req/s" in ln]
    print(f"tune serving: engine (TFC-w2a2, {rows}-row slots) {es['hits']} cache hits counted, "
          f"40 rows bit-exact vs the CPU oracle; launcher --tune cached: exit 0 in "
          f"{time.perf_counter() - t0:.3f} s, {line[-1].split(':', 2)[-1].strip()}; "
          f"{rate[-1].split(':', 2)[-1].strip() if rate else ''}", flush=True)


def run_tuning(torch, np, dev):
    """Phase 10: A15, the launch-geometry autotuner, on TFC-w2a2 (64 rows),
    CNV-w1a1 (8) and the rescaled MobileNet-w4a4 at 224 (8), each declared
    at those rows, with compile_graph's defaults (integer path, fusion on)
    from one fresh cache root: (a) tune="search" (the sigs, the candidates timed, the
    heuristic's blocks and ms against the winner's, the wall); (b) a warm
    tune="cached" compile: no search, no miss, a graph hit, every kernel
    segment tuned, one capture over two calls; (c) the tuned plan
    torch.equal to the heuristic plan and held against the oracle as phase
    3 holds it, the float32-epilogue tier likewise (and its winners on
    randn within the order bound); (d) the speed gate: captured tuned
    against heuristic plan calls in turns, the tuned plan at least
    TUNE_GATE of the heuristic's throughput; (e) an engine and the
    launcher serve TFC-w2a2 from the cache.  The root is removed at the
    end."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="tune-")
    try:
        models = _tune_models(np)
        for model, build, x, okey in models:
            _tune_one(torch, np, dev, root, model, build(), x, okey)
            torch.cuda.empty_cache()
        _tune_serving(torch, np, dev, root, models[0][1](), models[0][2], models[0][3])
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------- phase 11: the A17 families

FAMILY_ARCHS = ("llava-next-34b", "deepseek-moe-16b", "moonshot-v1-16b-a3b", "whisper-base",
                "rwkv6-7b", "recurrentgemma-2b")
FAM_TIGHT = 1e-5               # the CPU tests' float32 bound (tests/torch_lm_parity.py)
# (b): the served models at published width and their cuts (PERF.md section 4):
# arch -> (layers kept or None for all, B, prompt tokens, new tokens).
# rwkv6 keeps 16 of its 32 layers: its prefill's ~4,100 launches a layer
# make it the phase's longest model, and the default run's limit is tight
# recurrentgemma's 3,072-token prompts overrun its 2,048-slot ring: the
# prefill rolls it and every decode step wraps it
FAM_SERVE = {"whisper-base": (None, 4, 4, 64),
             "deepseek-moe-16b": (None, 4, 512, 16),
             "llava-next-34b": (24, 2, 128, 16),
             "rwkv6-7b": (16, 4, 512, 16),
             "recurrentgemma-2b": (None, 4, 3072, 16)}
# (c): depth kept for one QAT step.  The train state is 16 bytes a
# parameter, but AdamW's _foreach temporaries and the gradients take the
# step's peak to about 30 bytes a parameter: deepseek at 4 layers (2.77e9
# parameters) ran out of the card's 79 GiB in AdamW; 2 layers of each fit.
# rwkv6 at 4 layers is 1.41e9 parameters, recurrentgemma at 6 (two
# groups of rec, rec, attn) 1.12e9, most of it the 256,000-row embedding
FAM_TRAIN_LAYERS = {"whisper-base": None, "deepseek-moe-16b": 2, "llava-next-34b": 2,
                    "rwkv6-7b": 4, "recurrentgemma-2b": 6}
FAM_TRAIN_B, FAM_TRAIN_S = 2, 128
FAM_VECTOR_STD = 0.1           # live_vectors' N(0, 0.1), as tests/torch_lm_parity.py
FAM_VECTOR_SEED = 11
# the families whose prefill runs B7 once per decoder layer; the ssm has no
# attention and the hybrid's is windowed (ROADMAP C8): they launch none
FAM_B7 = ("dense", "moe", "vlm", "audio")


def _kv_quantizing(family) -> bool:
    """Whether a family's KV writes go through quant_kv: the decoder-only
    transformer's families (``transformer.PORTED_FAMILIES``).  Whisper's
    cache (ROADMAP C17), the hybrid's ring (C19) and rwkv6's states take
    none."""
    from repro_torch.models import transformer
    return family in transformer.PORTED_FAMILIES


def live_vectors(torch, model):
    """Every vector parameter of ``model`` (norm weights, biases, gates,
    decays, token-shift mixes) redrawn in place from N(0, 0.1) on a CPU
    generator seeded with FAM_VECTOR_SEED, in ``named_parameters`` order, as the
    CPU tests' weights (``tests/torch_lm_parity.reference_tree``).
    ``api.init_params`` keeps the reference's init, which leaves them at
    0: a layernorm model's logits are then exactly 0 everywhere."""
    g = torch.Generator().manual_seed(FAM_VECTOR_SEED)
    with torch.no_grad():
        for _, p in model.named_parameters():
            if p.ndim == 1:
                p.copy_(torch.randn(p.shape, generator=g) * FAM_VECTOR_STD)
    return model


def _spread(torch, logits, what) -> float:
    """The smallest std over the vocabulary of any row of ``logits``; a
    row that is constant (std 0) fails the gate."""
    std = float(logits.float().std(dim=-1).min())
    if not std > 0.0:
        raise AssertionError(f"{what}: logits constant over the vocabulary (std {std})")
    return std


def _fam_batch(torch, cfg, B, S, dev, seed):
    """Tokens (B, S) and the family's frontend stub embeddings, drawn from
    a CPU generator seeded with ``seed``, on ``dev``."""
    from repro_torch.models import api
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(1, cfg.vocab, (B, S), generator=g, dtype=torch.int32)}
    batch.update(api.frontend_batch(g, cfg, B, "cpu"))
    return {k: v.to(dev) for k, v in batch.items()}


def _hold_logits(torch, got, want, rule, what, logits=True, flipped=None):
    """The CPU tests' float32 logits rule: 'tight' every entry within
    1e-5 (abs + rel); 'w8a8' at most 1 % beyond that and none beyond 5 %
    of the largest logit (a value within ulps of a rounding tie may take
    the neighbouring code; for moe, two near-equal experts may swap).
    'w8a8-carried', the recurrent families under W8A8: none beyond 5 % of
    the largest value, and the entries beyond 1e-5 confined to batch rows
    where a code flipped, at most one row newly beyond in each tensor
    held.  ``flipped`` is the set of batch rows beyond in the tensors held
    before in the same prefill / decode chain (updated here): a flipped
    input code moves its whole row, and the recurrent state carries it to
    every later position and step of that row, so those rows are held by
    the 5 % bound only; every other row stays within 1e-5.  A share bound
    cannot fit the SMOKE size: recurrentgemma's 2 x 9 forward has 18 rows,
    and its one flip (card vs CPU, at the last position of a row) puts
    5.5 % of the logits beyond 1e-5.  Logits must also vary over the
    vocabulary on both sides (``_spread``); ``logits=False`` holds another
    tensor (a cache) by the same rule."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             "or non-finite values")
    if logits:
        _spread(torch, want, what + " (CPU)")
        _spread(torch, got, what + " (card)")
    d = (got - want).abs()
    beyond = d > FAM_TIGHT * (1 + want.abs())
    share, big = float(beyond.float().mean()), float(want.abs().max())
    within = float(d.max()) <= 0.05 * big
    if rule == "w8a8-carried":
        flipped = set() if flipped is None else flipped
        by_row = beyond.reshape(beyond.shape[0], -1).any(1)
        rows = {int(b) for b in by_row.nonzero().flatten()}
        new = rows - flipped
        flipped |= rows
        ok = within and len(new) <= 1
        if rows:
            # the first position beyond in each batch row (axis 1)
            first = {b: int(beyond[b].reshape(beyond.shape[1], -1).any(1).nonzero()[0])
                     for b in sorted(rows)} if d.ndim >= 3 else {}
            print(f"{what} [{rule}]: {share:.4f} beyond {FAM_TIGHT}, max diff {float(d.max()):.3e}"
                  f" of {big:.3e}; batch rows beyond {sorted(rows)} of {d.shape[0]}, new "
                  f"{sorted(new)}; first position beyond per row {first} of "
                  f"{d.shape[1] if d.ndim >= 3 else '-'}", flush=True)
    else:
        ok = {"tight": share == 0.0, "w8a8": share <= 0.01 and within}[rule]
    if not ok:
        raise AssertionError(f"{what} [{rule}]: {share:.4f} of entries beyond {FAM_TIGHT}, max "
                             f"diff {float(d.max()):.3e} (largest logit {big:.3e})"
                             + (f", batch rows newly beyond {sorted(new)}"
                                if rule == "w8a8-carried" else ""))
    return float(d.max()), share


def _hold_cache(torch, got, want, quantized, rule, what, flipped):
    """One cache tensor, card vs CPU, float32: unquantized by the logits'
    ``rule`` (with the chain's ``flipped`` rows); 8-bit codes (s = max|x| / 127 on each side) with the scales
    within 2^-21 and the codes within one step on at most 1 % of the
    entries (the CPU tests' rule)."""
    if not quantized:
        _hold_logits(torch, got, want, rule, what, logits=False, flipped=flipped)
        return
    got, want = got.float().cpu(), want.float().cpu()
    s_got, s_want = float(got.abs().max()) / 127, float(want.abs().max()) / 127
    if s_want == 0:
        if s_got != 0:
            raise AssertionError(f"{what}: a zero cache on the CPU, not on the card")
        return
    dc = (got / s_got - want / s_want).abs()
    if (abs(s_got / s_want - 1) > 2.0 ** -21 or float(dc.max()) > 1 + 1e-3
            or float((dc > 1e-3).float().mean()) > 0.01):
        raise AssertionError(f"{what}: scales {s_got} / {s_want}, codes off by up to "
                             f"{float(dc.max()):.3f} on {float((dc > 1e-3).float().mean()):.4f}")


def families_card_vs_cpu(torch, dev):
    """Phase 11 (a): the SMOKE configs of the six archs, one seeded init
    (its vectors live) on the CPU copied to the card (float32
    activations), under FP32 and W8A8-kv8: forward logits (with n_prefix
    and moe_aux), prefill plus two decode steps (logits and every layer's
    cache: KV entries, the hybrid's ring and recurrent states, rwkv6's
    shifts and wkv states), greedy_generate tokens (with img_embeds /
    frames) on the card against the CPU, within the CPU tests' bounds (moe
    logits by the W8A8 rule under both recipes); decode after a prefill
    against forward's last position on the card (moe at capacity 8.0, as
    the reference's test).  The hybrid's 9-token prompt overruns its SMOKE
    window of 8, so the prefill rolls the ring and every decode step wraps
    it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    from repro_torch.quantize.config import FP32
    from repro_torch.serve import greedy_generate
    for arch in FAMILY_ARCHS:
        for recipe, tag in ((FP32, "fp32"), (_lm_recipe(), "w8a8kv8")):
            cfg = get_smoke_config(arch).replace(quant=recipe)
            rule = "tight" if (tag == "fp32" and cfg.family != "moe") else "w8a8"
            if tag != "fp32" and cfg.family in ("ssm", "hybrid"):
                rule = "w8a8-carried"
            kv_q = tag == "w8a8kv8" and _kv_quantizing(cfg.family)
            p_cpu = live_vectors(torch, api.init_params(5, cfg, "cpu"))
            p_dev = live_vectors(torch, api.init_params(5, cfg, "cpu")).to(dev)
            b_cpu = _fam_batch(torch, cfg, 2, 9, "cpu", 6)
            b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
            with torch.no_grad():
                want, aux_c = api.forward(p_cpu, b_cpu, cfg)
                got, aux_d = api.forward(p_dev, b_dev, cfg)
            fwd = _hold_logits(torch, got, want, rule, f"(a) {arch} {tag} forward")
            if aux_d["n_prefix"] != aux_c["n_prefix"] or abs(
                    float(aux_d["moe_aux"]) - float(aux_c["moe_aux"])) > FAM_TIGHT * (
                    1 + abs(float(aux_c["moe_aux"]))):
                raise AssertionError(f"(a) {arch} {tag}: aux {aux_d} vs {aux_c}")
            n = 9 + api.n_prefix(cfg)
            want, c_cpu = api.prefill(p_cpu, b_cpu, cfg, n + 4)
            got, c_dev = api.prefill(p_dev, b_dev, cfg, n + 4)
            flipped = set()         # batch rows beyond 1e-5 in this chain (w8a8-carried)
            _hold_logits(torch, got, want, rule, f"(a) {arch} {tag} prefill", flipped=flipped)
            for idx in (n, n + 1):
                nxt = torch.argmax(want, -1).to(torch.int32)[:, None]
                want, c_cpu = api.decode_step(p_cpu, c_cpu, nxt, idx, cfg)
                got, c_dev = api.decode_step(p_dev, c_dev, nxt.to(dev), idx, cfg)
                _hold_logits(torch, got, want, rule, f"(a) {arch} {tag} decode at {idx}",
                             flipped=flipped)
            for i, (lc, ld) in enumerate(zip(c_cpu, c_dev)):
                for name in lc:
                    _hold_cache(torch, ld[name], lc[name], kv_q and name in ("k", "v"), rule,
                                f"(a) {arch} {tag} cache layer {i} {name}", flipped)
            t_cpu = greedy_generate(p_cpu, cfg, b_cpu, 6)
            t_dev = greedy_generate(p_dev, cfg, b_dev, 6).cpu()
            same = float((t_cpu == t_dev).float().mean())
            print(f"families (a) [{arch}, {tag}]: card vs CPU forward max diff {fwd[0]:.3e} "
                  f"({fwd[1]:.4f} beyond {FAM_TIGHT}, rule {rule}), moe_aux "
                  f"{float(aux_d['moe_aux']):.6f} vs {float(aux_c['moe_aux']):.6f}, prefill + 2 "
                  f"decode steps and {len(c_dev)} layers' caches held; greedy tokens equal on "
                  f"{same:.3f}", flush=True)
            if not torch.equal(t_cpu, t_dev):
                raise AssertionError(f"(a) {arch} {tag}: greedy tokens differ card vs CPU")
            if tag != "fp32":
                continue
            # decode against forward on the card (FP32: forward's attention
            # reads unquantized keys), moe at capacity 8.0 (no drops)
            dcfg = cfg.replace(moe_capacity_factor=8.0) if cfg.family == "moe" else cfg
            with torch.no_grad():
                full, _ = api.forward(p_dev, b_dev, dcfg)
            _, cache = api.prefill(p_dev, dict(b_dev, tokens=b_dev["tokens"][:, :8]), dcfg, n)
            last, _ = api.decode_step(p_dev, cache, b_dev["tokens"][:, 8:9], n - 1, dcfg)
            _spread(torch, last, f"(a) {arch} decode after a prefill")
            dvf = float((last - full[:, -1]).abs().max())
            print(f"families (a) [{arch}]: decode after a prefill vs forward at the last "
                  f"position, max diff {dvf:.3e} (atol 2e-3, rtol 1e-3)", flush=True)
            if not torch.allclose(last, full[:, -1], atol=2e-3, rtol=1e-3):
                raise AssertionError(f"(a) {arch}: decode differs from forward by {dvf}")


def _busy_ms(torch, run, label, top=6):
    """One call of ``run`` under torch.profiler: (device kernel time in ms,
    device kernel launches), the largest kernels printed.  Device activity only: rwkv6-7b's prefill issues ~132,000
    launches, whose host-side events took the profiler 89 s to gather
    against 25 s without them, at the same device time (H100 80GB HBM3,
    700 W).  A profile that recorded no device time is taken again, up to
    three in all (one default run on the card lost a profile of phase 12
    (g) so), and the call fails if none recorded any."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
                by_name[e.key] = (t / 1e3, e.count)
        busy = sum(t for t, _ in by_name.values())
        if busy > 0.0:
            break
        print(f"profile[{label}]: no device time recorded; profiling again", flush=True)
    else:
        raise AssertionError(f"profile[{label}]: the profiler recorded no device time "
                             f"in 3 profiles")
    for key, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"profile[{label}]:   {t:.3f} ms in {n} launches  {key[:90]}", flush=True)
    return busy, sum(n for _, n in by_name.values())


def _wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _moe_probe(transformer):
    """Patches that record each moe_ffn's aux and each dispatch's kept
    share during a prefill (the model calls them through the module)."""
    seen = {"aux": [], "kept": [], "choices": []}
    real_ffn, real_dispatch = transformer.moe_ffn, transformer.moe_dispatch

    def ffn(x, p, cfg):
        y, aux = real_ffn(x, p, cfg)
        seen["aux"].append(aux)
        return y, aux

    def dispatch(xg, top_i, cfg, C):
        buf, slot, keep = real_dispatch(xg, top_i, cfg, C)
        seen["kept"].append(keep.sum())
        seen["choices"].append(keep.numel())
        return buf, slot, keep
    return seen, (mock.patch.object(transformer, "moe_ffn", ffn),
                  mock.patch.object(transformer, "moe_dispatch", dispatch))


def serve_family(torch, dev, ops, arch):
    """Phase 11 (b), one model: bf16 activations, seeded float32
    parameters with live vectors, W8A8 (with the 8-bit KV cache where the
    family quantizes its cache: not whisper's, not the hybrid's ring, not
    rwkv6's states), depth cut as FAM_SERVE says.  One request batch
    through greedy_generate with B7's launches counted (one per decoder
    layer, in the prefill only; none for the ssm and hybrid families);
    then a prefill timed and profiled, and the decode steps timed and
    profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, transformer
    from repro_torch.quantize.config import QuantRecipe
    from repro_torch.serve import greedy_generate
    layers, B, S, new = FAM_SERVE[arch]
    cfg = get_config(arch)
    kv = 8.0 if _kv_quantizing(cfg.family) else None
    cfg = cfg.replace(quant=QuantRecipe.w_a(8.0, 8.0, kv_cache_bits=kv))
    if layers:
        cfg = cfg.replace(n_layers=layers)
    want_b7 = cfg.n_layers if cfg.family in FAM_B7 else 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = live_vectors(torch, api.init_params(0, cfg, dev))
    torch.cuda.synchronize()
    n_prefix = api.n_prefix(cfg)
    shape = f"{cfg.n_layers} {'decoder ' if cfg.family in FAM_B7 else ''}layers"
    if layers:
        shape += f", cut from {get_config(arch).n_layers}"
    if cfg.family == "audio":
        shape += f", {cfg.n_enc_layers} encoder layers, {cfg.n_frames} frames"
    if n_prefix:
        shape += f", {cfg.n_patches} image patches"
    if cfg.family == "hybrid":
        shape += (f", pattern {'/'.join(cfg.block_pattern)}, attention window {cfg.window} "
                  f"(the prompt overruns the ring: {S > cfg.window})")
    print(f"families (b) [{arch}]: {cfg.param_count()} float32 parameters ({shape}), recipe "
          f"{cfg.quant.tag()}, {cfg.dtype} activations, B={B}, prompts of {S} tokens, {new} new "
          f"tokens; init on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    batch = _fam_batch(torch, cfg, B, S, dev, 21)
    seen, patches = _moe_probe(transformer)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with patches[0], patches[1]:
        toks = greedy_generate(params, cfg, batch, new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"families (b) [{arch}] greedy_generate: {B}x{new} tokens in {gen_s:.3f} s (host "
          f"clock, first call); launches {counts} [{card_line()}]", flush=True)
    if tuple(toks.shape) != (B, new) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"(b) {arch}: generated tokens {tuple(toks.shape)} out of range")
    if counts["flash_attention"] != want_b7 or sum(counts.values()) != want_b7:
        raise AssertionError(f"(b) {arch}: {counts}; want {want_b7} B7 launches (one per "
                             "decoder layer of the one prefill; none in the ssm and hybrid "
                             "families) and nothing else")
    if cfg.family == "moe":
        L = cfg.n_layers          # the prefill's layers come first
        kept = sum(int(k) for k in seen["kept"][:L])
        total = sum(seen["choices"][:L])
        aux = sum(float(a) for a in seen["aux"][:L])
        print(f"families (b) [{arch}] prefill at capacity {cfg.moe_capacity_factor}: "
              f"{1 - kept / total:.4f} of the {total} expert choices dropped; moe_aux (summed "
              f"over {L} layers) {aux:.6f}", flush=True)
        if not math.isfinite(aux):
            raise AssertionError(f"(b) {arch}: moe_aux {aux}")

    # the prefill alone: launches, logits, wall, busy
    cache_len = S + n_prefix + new
    ops.reset_launch_counts()
    logits, cache = api.prefill(params, batch, cfg, cache_len)
    torch.cuda.synchronize()
    n_b7 = ops.launch_counts()["flash_attention"]
    _finite(torch, logits, (B, cfg.vocab), f"(b) {arch} prefill logits")
    walls = [_wall_ms(torch, lambda: api.prefill(params, batch, cfg, cache_len)) for _ in range(2)]
    wall = min(walls)
    busy, n_dev = _busy_ms(torch, lambda: api.prefill(params, batch, cfg, cache_len),
                           f"families {arch} prefill")
    print(f"families (b) [{arch}] prefill B={B} S={S + n_prefix}: wall {wall:.3f} ms (best of "
          f"{', '.join(f'{w:.3f}' for w in walls)}), device busy {busy:.3f} ms in {n_dev} "
          f"device launches (profiler), busy share {busy / wall:.3f}; B7 launches {n_b7} "
          f"(want {want_b7}; layers {cfg.n_layers}"
          f"{', 0 in the encoder and the cross-attention' if cfg.family == 'audio' else ''}) "
          f"[{card_line()}]", flush=True)
    if n_b7 != want_b7:
        raise AssertionError(f"(b) {arch}: the prefill launched B7 {n_b7} times")
    # decode steps on the prefill's cache
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    ops.reset_launch_counts()
    dwalls = []
    for i in range(min(new, 8)):
        idx = S + n_prefix + i
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.decode_step(params, cache, tok, idx, cfg)
        torch.cuda.synchronize()
        dwalls.append((time.perf_counter() - t0) * 1e3)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    d_counts = ops.launch_counts()
    _finite(torch, logits, (B, cfg.vocab), f"(b) {arch} decode logits")
    dwall = statistics.median(dwalls[1:])
    dbusy, d_dev = _busy_ms(
        torch, lambda: api.decode_step(params, cache, tok, S + n_prefix + 8, cfg),
        f"families {arch} decode step", top=4)
    peak = torch.cuda.max_memory_allocated()
    print(f"families (b) [{arch}] decode step B={B}: median wall {dwall:.3f} ms over steps 2-"
          f"{len(dwalls)} ({B / dwall * 1e3:.1f} tokens/s), device busy {dbusy:.3f} ms in "
          f"{d_dev} device launches; B7 launches in decode {d_counts['flash_attention']}; peak "
          f"memory {peak / 2 ** 30:.3f} GiB [{card_line()}]", flush=True)
    if d_counts["flash_attention"] != 0:
        raise AssertionError(f"(b) {arch}: decode launched B7")
    del params, cache, logits
    torch.cuda.empty_cache()
    return {"prefill_ms": wall, "busy_ms": busy, "decode_ms": dwall, "peak_gib": peak / 2 ** 30,
            "prefill_launches": n_dev, "decode_launches": d_dev}


def family_b7_timings(torch, ops, dev, err):
    """B7 at the served prefills' attention shapes (bf16, causal, the
    models' layout), held against its twin on the same inputs by phase 2's
    rule, then timed per launch: kernel, twin and SDPA, beside the bound.
    The ssm and hybrid families launch no B7 and have no row."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import api
    for arch, (layers, B, S, _) in FAM_SERVE.items():
        cfg = get_config(arch)
        if cfg.family not in FAM_B7:
            continue
        S = S + api.n_prefix(cfg)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        g = torch.Generator(device=dev).manual_seed(29)
        q, k, v = (torch.randn(B, S, h, hd, generator=g, device=dev).to(torch.bfloat16)
                   .transpose(1, 2) for h in (H, KV, KV))
        got, want = ops.flash_attention(q, k, v), ops.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        d, far = _hold_flash_attention(torch, got, want, f"{arch} B={B} S={S} bf16 causal")
        err["flash_attention"] = max(err["flash_attention"], d)
        del got, want
        r = _timed(ms=lambda: ops.flash_attention(q, k, v),
                   plain_ms=lambda: ops.flash_attention_plain(q, k, v),
                   library_ms=lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, enable_gqa=True))
        ops_ms = 2 * B * H * S * (S + 1) * hd / BF16_FLOPS * 1e3     # causal pairs, 4·hd each
        bytes_ms = (2 * q.numel() + 2 * k.numel()) * 2 / HBM_BYTES_PER_S * 1e3
        print(f"time[families B7 {arch}] B={B} H={H} KV={KV} S={S} hd={hd} bf16 causal, per "
              f"launch: kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, sdpa "
              f"{r['library_ms']:.6f} ms, bound {max(ops_ms, bytes_ms):.6f} ms "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}); x{layers or cfg.n_layers} "
              f"per prefill; vs twin max abs diff {d:.3e} (bf16 entries beyond {FA_TOL}: at "
              f"most {far} bf16 step apart) [{card_line()}]", flush=True)
        del q, k, v


def train_family(torch, dev, ops, arch):
    """Phase 11 (c), one model: the training launcher's configuration
    (W8A8 QAT, remat, moe_aux_weight 0.01 for moe) at published width
    with the depth cut to FAM_TRAIN_LAYERS, its vectors live, B=2, S=128
    from SyntheticLMStream with the frontend stubs; one train step with
    the launch counts at 0 before it (no kernel may launch: B7 is forward
    only).  For llava the step's loss equals loss_fn's and the
    cross-entropy of the sliced logits, computed at the same parameters
    before the step."""
    from repro_torch.data import SyntheticLMStream, to_device
    from repro_torch.launch import train as launcher
    from repro_torch.models import api
    from repro_torch.train import loop
    args = launcher.parse(["--arch", arch, "--steps", "10", "--global-batch", str(FAM_TRAIN_B),
                           "--seq", str(FAM_TRAIN_S)])
    cfg, hyper = launcher.build(args)
    layers = FAM_TRAIN_LAYERS[arch]
    if layers:
        cfg = cfg.replace(n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = loop.init_train_state(0, cfg, hyper, dev)
    live_vectors(torch, state["params"])
    stream = SyntheticLMStream(vocab=cfg.vocab, global_batch=FAM_TRAIN_B, seq_len=FAM_TRAIN_S,
                               seed=0, extra_specs=launcher.frontend_specs(cfg))
    batch = to_device(stream.next(), dev)
    check = ""
    if cfg.family == "vlm":
        # with gradients on, as in the step (outside autograd the attention
        # would take B7); each graph is dropped at once
        with torch.enable_grad():
            lf = float(loop.loss_fn(state["params"], batch, cfg, hyper)[0].detach())
            logits, _ = api.forward(state["params"], batch, cfg)
            sliced = logits[:, cfg.n_patches:].detach()
            del logits
        lse = torch.logsumexp(sliced, -1)
        ce = torch.nn.functional.cross_entropy(sliced.reshape(-1, cfg.vocab),
                                               batch["labels"].reshape(-1).long())
        manual = float(ce + hyper.z_loss * torch.square(lse).mean())
        del sliced, lse, ce
        check = f"; loss_fn {lf:.6f}, the sliced logits' loss {manual:.6f}"
    step = loop.make_train_step(cfg, hyper)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    peak = torch.cuda.max_memory_allocated()
    print(f"families (c) [{arch}]: {cfg.param_count()} float32 parameters ({cfg.n_layers} "
          f"{'decoder ' if cfg.family in FAM_B7 else ''}layers), recipe {cfg.quant.tag()}, remat {cfg.remat}, B={FAM_TRAIN_B} "
          f"S={FAM_TRAIN_S}{f' + {cfg.n_patches} patches' if cfg.family == 'vlm' else ''}: loss "
          f"{loss:.6f}, grad_norm {gn:.6f}, moe_aux {float(m['moe_aux']):.6f}{check}; step wall "
          f"{wall:.3f} ms (first step); peak memory {peak / 2 ** 30:.3f} GiB; launches "
          f"{counts} [{card_line()}]", flush=True)
    if not (math.isfinite(loss) and math.isfinite(gn) and loss > 0 and gn > 0):
        raise AssertionError(f"(c) {arch}: loss {loss} or grad_norm {gn} not finite and positive")
    if sum(counts.values()) != 0:
        raise AssertionError(f"(c) {arch}: the train step launched {counts}")
    if cfg.family == "vlm" and not (abs(loss - lf) <= FAM_TIGHT * abs(lf)
                                    and abs(loss - manual) <= FAM_TIGHT * abs(manual)):
        raise AssertionError(f"(c) {arch}: step loss {loss} vs loss_fn {lf} / sliced {manual}")
    del state, batch, m
    torch.cuda.empty_cache()
    return {"step_ms": wall, "peak_gib": peak / 2 ** 30}


def run_families(torch, dev, ops, err):
    """Phase 11: the vlm, moe, audio, ssm and hybrid families, (a) to (c);
    B7's difference from its twin at the served shapes goes into err."""
    t0 = time.perf_counter()
    families_card_vs_cpu(torch, dev)
    print(f"families (a): {time.perf_counter() - t0:.1f} s", flush=True)
    for arch in FAM_SERVE:
        serve_family(torch, dev, ops, arch)
    family_b7_timings(torch, ops, dev, err)
    for arch in FAM_TRAIN_LAYERS:
        train_family(torch, dev, ops, arch)
    print(f"families: phase 11 in {time.perf_counter() - t0:.1f} s [{card_line()}]", flush=True)


# ------------------------------------------------ phase 12: multi-device

MESH_ENTRIES = 4               # the virtual mesh's entries, all on cuda:0
MESH_TURNS = 10                # plan-call walls in alternating turns


def _mesh_models(np):
    """(key, graph builder, rows) of phase 12 (b): inputs seeded as phase 8's."""
    from repro_torch.models import zoo
    x64 = np.random.RandomState(2).randn(64, 784).astype(np.float32)
    cnv = np.random.RandomState(12).randn(3 * SLOT, 3, 32, 32).astype(np.float32)
    x16 = np.random.RandomState(13).randn(2 * SLOT, 3, 224, 224).astype(np.float32)
    return {"TFC-w1a1": (zoo.ZOO["TFC-w1a1"], x64[:16]),
            "CNV-w1a1": (zoo.ZOO["CNV-w1a1"], cnv[:16]),
            "MobileNet-w4a4 rescaled": (
                lambda: zoo.rescale_conv_gains(zoo.build_mobilenet(4, 4, img=224)), x16)}


def _mesh_bound(torch, key, build, x16, rows):
    """The order bound of the rescaled MobileNet's final MatMul over
    ``rows`` of the CPU oracle (cached with phase 3's), and its rows."""
    g = build()
    oracle = _oracle(g, x16, return_all=True, key=key)
    pre, w_name = _final_matmul(g)
    ref = oracle[g.output_names[0]][:rows]
    return ref, order_bound(oracle[pre][:rows], oracle[w_name], ref)


def _mesh_equal(torch, got, want, label, bound=None):
    """torch.equal, or (where ``bound`` is given) within it; returns how."""
    if torch.equal(got, want):
        return "bit-exact"
    if bound is not None and bool((got.cpu() - want.cpu()).abs().le(bound).all()):
        return "within the order bound"
    diff = float((got.float() - want.float()).abs().max())
    raise AssertionError(f"mesh {label}: differs from the one-device plan (max {diff})")


def _mesh_where(mesh) -> str:
    """The entries of a virtual mesh, e.g. "4 entries of cuda:0"."""
    devs = [str(d) for d in mesh.devices.flat]
    if len(set(devs)) == 1:
        return f"{len(devs)} entries of {devs[0]}"
    return f"{len(devs)} entries ({', '.join(devs)})"


def mesh_plans(torch, np, dev, ops):
    """Phase 12 (a) + (b); returns the plans (g) times."""
    from repro_torch.core import compile_graph
    from repro_torch.dist.fault import elastic_mesh
    from repro_torch.launch.mesh import make_virtual_mesh

    n = torch.cuda.device_count()
    model = max(c for c in range(1, min(16, n) + 1) if n % c == 0)
    for m, want in ((elastic_mesh(), {"data": n // model, "model": model}),
                    (elastic_mesh(prefer_model=1), {"data": n, "model": 1})):
        if m.shape != want or m.devices.flat[0] != torch.device("cuda", 0):
            raise AssertionError(f"elastic_mesh on {n} card(s): {m}, not {want}")
    models = _mesh_models(np)
    build, x = models["TFC-w1a1"]
    auto, plain = compile_graph(build(), mesh="auto"), compile_graph(build())
    name = plain.graph.input_names[0]
    if auto.n_devices != n or auto.placement()["kind"] != ("device" if n == 1 else "mesh"):
        raise AssertionError(f"mesh='auto' on {n} card(s): {auto.placement()}")
    out = plain.graph.output_names[0]
    _mesh_equal(torch, auto({name: x})[out], plain({name: x})[out], "(a) auto")
    torch.cuda.synchronize()
    print(f"mesh (a): on {n} card(s) elastic_mesh() is {elastic_mesh().shape} and "
          f"elastic_mesh(prefer_model=1) {{data {n}, model 1}}; compile_graph(mesh='auto') "
          f"spans {auto.n_devices} device(s), TFC-w1a1 at 16 rows bit-exact", flush=True)

    mesh = make_virtual_mesh(MESH_ENTRIES)
    where = _mesh_where(mesh)
    keep, window = {}, {}
    for key, (build, xs) in models.items():
        one, sharded = compile_graph(build()), compile_graph(build(), mesh=mesh)
        name, out = one.graph.input_names[0], one.graph.output_names[0]
        if sharded.placement() != {"kind": "mesh", "devices": MESH_ENTRIES,
                                   "mesh": {"data": MESH_ENTRIES, "model": 1}}:
            raise AssertionError(f"mesh {key}: placement {sharded.placement()}")
        rq = sharded.requant_stats()
        mob = key.startswith("MobileNet")
        batches = (SLOT,) if mob else (16, 1, 5, 13)
        how = {}
        for b in batches:
            xb = xs[:b]
            want = one({name: xb})[out]
            got = sharded({name: xb})[out]
            bound = _mesh_bound(torch, key, build, xs, b)[1] if mob and not \
                torch.equal(got, want) else None
            how[b] = _mesh_equal(torch, got, want, f"{key} batch {b}", bound)
        torch.cuda.synchronize()
        calls = len(batches)
        # one capture per shard signature on each distinct card
        sigs = len({-(-b // MESH_ENTRIES) for b in batches}) * len(set(sharded.shard_devices))
        if sharded.shard_counts != [calls] * MESH_ENTRIES:
            raise AssertionError(f"mesh {key}: shard counters {sharded.shard_counts}")
        # every shard replays, the first of each signature right after its capture
        if sharded.trace_count != sigs or sharded.replay_count != calls * MESH_ENTRIES:
            raise AssertionError(f"mesh {key}: {sharded.trace_count} captures and "
                                 f"{sharded.replay_count} replays for {calls} calls")
        # launches: one eager forward of each, counted on its own
        ops.reset_launch_counts()
        one({name: xs[:16 if not mob else SLOT]}, jit=False)
        torch.cuda.synchronize()
        c1 = ops.launch_counts()
        ops.reset_launch_counts()
        sharded({name: xs[:16 if not mob else SLOT]}, jit=False)
        torch.cuda.synchronize()
        cm = ops.launch_counts()
        if cm != {k: MESH_ENTRIES * v for k, v in c1.items()}:
            raise AssertionError(f"mesh {key}: launches {cm}, not {MESH_ENTRIES} x {c1}")
        for k, v in cm.items():
            window[k] = window.get(k, 0) + v
        print(f"mesh (b) {key} over {where}: "
              f"{rq['int32_segments']} of {rq['kernel_segments']} int32 segments, rows "
              f"{how} vs the one-device plan; shard counters {sharded.shard_counts}, "
              f"{sharded.trace_count} capture(s), {sharded.replay_count} replays; one eager "
              f"forward launches {cm} = {MESH_ENTRIES} x {c1}", flush=True)
        keep[key] = (one, sharded, {name: xs[:16 if not mob else SLOT]})
    check_launched(window, SERVED_KERNELS, "phase 12 (b), the mesh plans' eager forwards")

    # the float32-epilogue tier: within the order bound of the CPU oracle
    for key, rows in (("TFC-w2a2", 16), ("MobileNet-w4a4 rescaled", SLOT)):
        if key == "TFC-w2a2":
            from repro_torch.models import zoo
            build, xs = zoo.ZOO["TFC-w2a2"], models["TFC-w1a1"][1]
            g = build()
            ref = _oracle(g, xs[:rows], key="mesh TFC-w2a2")[g.output_names[0]]
            bound = None
        else:
            build, xs = models[key]
            g = build()
            ref, bound = _mesh_bound(torch, key, build, xs, rows)
        one = compile_graph(build(), use_analysis=False)
        sharded = compile_graph(build(), mesh=mesh, use_analysis=False)
        name, out = g.input_names[0], g.output_names[0]
        got, base = sharded({name: xs[:rows]})[out].cpu(), one({name: xs[:rows]})[out].cpu()
        ok = torch.equal(got, ref) if bound is None else bool(
            (got - ref).abs().le(bound).all())
        if not ok:
            raise AssertionError(f"mesh float32 tier {key}: outside the bound")
        print(f"mesh (b) float32 tier {key} at {rows} rows over {where}: "
              f"{'bit-exact' if bound is None else 'within the order bound'} vs the CPU "
              f"oracle; vs the one-device plan {'equal' if torch.equal(got, base) else 'not equal'}"
              , flush=True)
    return keep


def mesh_serving(torch, np, dev):
    """Phase 12 (c): an engine over the mesh, and two mesh-sharded workers
    behind the split-merge front with a fault injected."""
    from repro_torch.core import compile_graph
    from repro_torch.launch.mesh import make_virtual_mesh
    from repro_torch.models import zoo
    from repro_torch.serve import CompiledGraphEngine, SplitMergeFront, Worker

    x = np.random.RandomState(2).randn(64, 784).astype(np.float32)
    plain = compile_graph(zoo.ZOO["TFC-w1a1"]())
    ref = plain({plain.graph.input_names[0]: x})[plain.graph.output_names[0]].cpu().numpy()
    eng = CompiledGraphEngine(zoo.ZOO["TFC-w1a1"](), mesh=make_virtual_mesh(MESH_ENTRIES),
                              max_batch=16, report_cost=False)
    reqs = [eng.submit(r) for r in x]
    eng.run_pending()
    rows = np.stack([r.wait(timeout=120) for r in reqs])
    if not np.array_equal(rows, ref) or not np.array_equal(eng(x[:13]), ref[:13]):
        raise AssertionError("mesh engine: rows differ from the one-device plan")
    print(f"mesh (c) CompiledGraphEngine over {_mesh_where(eng.mesh)}, TFC-w1a1, 16-row "
          f"slots: 64 submitted requests and a 13-row batch bit-exact; shard counters "
          f"{eng.plan.shard_counts}, {eng.plan.trace_count} capture(s), "
          f"{eng.plan.replay_count} replays", flush=True)
    workers = [Worker(name=f"mesh{i}", engine=CompiledGraphEngine(
        zoo.ZOO["TFC-w1a1"](), mesh=make_virtual_mesh(2), max_batch=16,
        report_cost=False)) for i in range(2)]
    xs = [x[j % len(x)] for j in range(SERVE_REQUESTS)]
    for w in workers:
        w.engine(x[:1])
    with SplitMergeFront(workers) as front:
        workers[1].inject_fault()
        got = front.submit_wave(xs).wait(timeout=120)
        st = front.stats()
    if len(got) != len(xs) or not all(np.array_equal(r, ref[j % len(x)])
                                      for j, r in enumerate(got)):
        raise AssertionError("mesh splitmerge: a row is lost or out of order")
    if st["failed"] != ["mesh1"] or st["redispatched_shards"] < 1:
        raise AssertionError(f"mesh splitmerge: fault not re-dispatched ({st})")
    print(f"mesh (c) SplitMergeFront over two workers, each sharded over "
          f"{_mesh_where(workers[0].engine.mesh)}, fault "
          f"injected in mesh1: {len(got)} rows, none lost, in submission order, "
          f"bit-exact; {st}", flush=True)


def mesh_launcher():
    """Phase 12 (d): the launcher's --mesh and --devices 4, each in a
    subprocess of its own, both started together."""
    import os

    import torch
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    runs = []
    t0 = time.perf_counter()
    for flags, n in ((["--mesh"], torch.cuda.device_count()),
                     (["--devices", str(MESH_ENTRIES)], MESH_ENTRIES)):
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--graph", "TFC-w1a1",
             "--requests", "32", "--max-batch", "16", *flags],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        runs.append((flags, n, proc))
    for flags, n, proc in runs:
        try:
            _, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"launcher {flags} exited {proc.returncode}: {err[-3000:]}")
        span = [ln for ln in err.splitlines() if "mesh-sharded plan spans" in ln]
        if not span or f"spans {n} device(s)" not in span[-1] or "cuda:0" not in span[-1]:
            raise AssertionError(f"launcher {flags}: no log of {n} device(s) spanned: "
                                 f"{err[-2000:]}")
        rate = [ln for ln in err.splitlines() if "req/s" in ln]
        print(f"mesh (d) launcher --graph TFC-w1a1 {' '.join(flags)}: exit 0 by {wall:.3f} s; "
              f"{span[-1].split(':', 2)[-1].strip()}; "
              f"{rate[-1].split(':', 2)[-1].strip() if rate else ''}", flush=True)


def mesh_psum(torch, dev):
    """Phase 12 (e): quantized_psum on an NCCL group of one."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.dist import collectives
    from repro_torch.dist.fault import elastic_mesh
    g = torch.Generator().manual_seed(21)
    x = {"w": torch.randn(256, 512, generator=g), "b": torch.randn(4099, generator=g) * 5}
    res = {k: torch.randn(v.shape, generator=g) * 1e-3 for k, v in x.items()}
    want, want_res = collectives.ef_compress(x, res)
    xd = {k: v.to(dev) for k, v in x.items()}
    rd = {k: v.to(dev) for k, v in res.items()}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                rank=0, world_size=1)
        try:
            with elastic_mesh(device="cuda:0") as mesh:       # one entry: one rank
                got, got_res = collectives.quantized_psum(xd, "data", rd)
            by_group, _ = collectives.quantized_psum(xd, residual=rd, group=dist.group.WORLD)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    for k in x:
        for a, b, what in ((got[k], want[k], "summed"), (got_res[k], want_res[k], "residual"),
                           (by_group[k], want[k], "summed (group=)")):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"quantized_psum {what} {k}: differs from the CPU's")
    print(f"mesh (e) quantized_psum on an NCCL group of one (mesh {mesh.shape}): summed and "
          f"residual torch.equal to ef_compress on the CPU for {sorted(x)}, through the "
          f"ambient mesh and through group=", flush=True)


def mesh_lm(torch, np, dev, ops):
    """Phase 12 (f): the LM launcher under its (1, 1) mesh against the same
    generation with no mesh."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import api
    from repro_torch.serve import GenerationEngine

    n_req, new = 8, 8
    flags = ["--arch", LM_ARCH, "--smoke", "--requests", str(n_req), "--max-new-tokens",
             str(new)]
    if torch.cuda.device_count() > 1:
        # an LM mesh of several cards needs one process per card: torchrun
        try:
            launcher.main(flags)
        except RuntimeError as e:
            if "torchrun" not in str(e):
                raise
            print(f"mesh (f) LM launcher on {torch.cuda.device_count()} cards without "
                  f"torchrun raises, naming torchrun", flush=True)
        else:
            raise AssertionError("the LM launcher served over several cards in one process")
        flags += ["--device", "cuda:0"]
    ops.reset_launch_counts()
    res = launcher.main(flags)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    cfg = get_smoke_config(LM_ARCH).replace(quant=_lm_recipe())
    prefills = -(-n_req // 4)
    if counts["flash_attention"] != cfg.n_layers * prefills:
        raise AssertionError(f"LM launcher under its mesh: {counts}, want B7 once per "
                             f"layer in each of {prefills} prefills")
    params = api.init_params(0, cfg, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=rng.integers(4, 12)) for _ in range(n_req)]
    eng = GenerationEngine(params, cfg, max_batch=4)
    reqs = [eng.submit(p, new) for p in prompts]
    eng.run_pending()
    for j, (a, r) in enumerate(zip(res["results"], reqs)):
        if not torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(r.result).cpu()):
            raise AssertionError(f"LM launcher under its mesh: request {j}'s tokens differ")
    print(f"mesh (f) LM launcher {cfg.name} (shard_activations=True) under its "
          f"{{data 1, model 1}} mesh: {res['tokens']} tokens of {n_req} requests equal to the same "
          f"generation with no mesh; B7 {counts['flash_attention']} launches = "
          f"{cfg.n_layers} layers x {prefills} prefills", flush=True)


def mesh_b7_shards(torch, dev, ops):
    """Phase 12 (h): B7 on a DTensor's shards on the card, through
    ``transformer.attend``, over a fake 4-rank group's {data 2, model 2}
    cuda DeviceMesh (rank 0's shards); the group is destroyed."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import sharding as tsh
    from repro_torch.models import transformer

    (H, KV, hd), B, S = FA_SHAPES["qwen2"], 4, 2048
    if dist.is_initialized():
        raise AssertionError("mesh (h): a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        dm = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        sh = tsh.Sharding(dm, (Shard(0), Shard(2)), None)
        g = torch.Generator(device=dev).manual_seed(11)
        local = [torch.randn(B // 2, S, h // 2, hd, generator=g, device=dev).to(torch.bfloat16)
                 for h in (H, KV, KV)]
        q, k, v = (tsh.placed(t, sh, (B, S, 2 * t.shape[2], hd)) for t in local)
        before = ops.launch_counts()["flash_attention"]
        with torch.no_grad():
            out = transformer.attend(q, k, v, get_smoke_config(LM_ARCH), causal=True)
        torch.cuda.synchronize()
        n = ops.launch_counts()["flash_attention"] - before
        if n != 1 or not isinstance(out, DTensor) or tuple(out.placements) != sh.placements:
            raise AssertionError(f"mesh (h): {n} B7 launches (want 1), result "
                                 f"{type(out).__name__} {getattr(out, 'placements', None)}")
        want = ops.flash_attention_plain(*(t.transpose(1, 2) for t in local),
                                         causal=True).transpose(1, 2)
        d, far = _hold_flash_attention(torch, out.to_local(), want, "on a DTensor's shards")
    finally:
        dist.destroy_process_group()
    print(f"mesh (h) B7 on a DTensor's shards: q {tuple(q.shape)} / k, v {tuple(k.shape)} bf16 "
          f"over {{data 2, model 2}} (rank 0's {tuple(local[0].shape)} / "
          f"{tuple(local[1].shape)} on {dev}): {n} B7 launch through transformer.attend, "
          f"max |diff| against the twin {d} ({far} bf16 steps beyond FA_TOL)", flush=True)


def mesh_walls(torch, keep, card):
    """Phase 12 (g): one-device and mesh plan-call walls in alternating
    turns, and each call's busy time; recorded, not gated."""
    for key in ("TFC-w1a1", "MobileNet-w4a4 rescaled"):
        one, sharded, x = keep[key]
        rows = next(iter(x.values())).shape[0]
        for p in (one, sharded):
            p(x)
        torch.cuda.synchronize()
        walls = {"one-device": [], f"mesh {_mesh_where(sharded.mesh)}": []}
        plans = dict(zip(walls, (one, sharded)))
        for t in range(MESH_TURNS):
            order = list(walls) if t % 2 == 0 else list(walls)[::-1]
            for label in order:
                walls[label].append(_wall_ms(torch, lambda: plans[label](x)))
        for label, ws in walls.items():
            busy, launches = _busy_ms(torch, lambda: plans[label](x), f"mesh {key} {label}",
                                      top=3)
            print(f"mesh (g) {key} at {rows} rows, {label}: plan-call wall median "
                  f"{statistics.median(ws):.4f} ms (min {min(ws):.4f}, max {max(ws):.4f}, "
                  f"{MESH_TURNS} turns), busy {busy:.4f} ms in {launches} device launches "
                  f"({card})", flush=True)


def run_mesh(torch, np, dev, ops):
    """Phase 12: multi-device (A16) over a virtual mesh of the one card."""
    t0 = time.perf_counter()
    keep = mesh_plans(torch, np, dev, ops)
    mesh_serving(torch, np, dev)
    mesh_launcher()
    mesh_psum(torch, dev)
    mesh_lm(torch, np, dev, ops)
    mesh_b7_shards(torch, dev, ops)
    mesh_walls(torch, keep, card_line())
    print(f"mesh: phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------ phase 13: the dry-run

def run_dryrun(meshes: str, timeout: float = 900.0):
    """Phase 13: ``repro_torch.launch.dryrun --arch <arch> --mesh <meshes>
    --device-type cuda``, one child process per arch (no process group
    outlives them), as many at once as the host has cores (at most 8),
    their records in a fresh directory.  Prints per cell its status,
    trace time, collective count and bytes (per device), per-chip FLOPs
    and argument / output bytes; fails on a child's non-zero exit, on
    any ``failed`` cell, on a matrix other than 32 ok / 8 skipped per
    mesh, or on an ok record without the three measures."""
    import json as _json
    import os
    import shutil
    import tempfile
    from repro_torch.configs import all_archs
    out = Path(tempfile.mkdtemp(prefix="dryrun_torch_"))
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    pending, running, codes = list(all_archs()), [], {}
    width = max(1, min(8, len(os.sched_getaffinity(0)), len(pending)))
    t0 = time.perf_counter()
    print(f"dryrun: phase 13 (--mesh {meshes}), {len(pending)} archs, {width} at once",
          flush=True)
    try:
        while pending or running:
            while pending and len(running) < width:
                arch = pending.pop(0)
                log = open(out / f"{arch}.log", "w")
                running.append((arch, log, subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                     "--mesh", meshes, "--device-type", "cuda", "--results-dir", str(out)],
                    env=env, stdout=log, stderr=subprocess.STDOUT, text=True)))
            time.sleep(0.5)
            for item in list(running):
                arch, log, proc = item
                if proc.poll() is not None:
                    codes[arch] = proc.returncode
                    log.close()
                    running.remove(item)
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"phase 13: not done after {timeout} s "
                                     f"({[a for a, _, _ in running]} running)")
        wall = time.perf_counter() - t0
        recs = [_json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
        tails = {a: (out / f"{a}.log").read_text()[-1500:] for a, c in codes.items() if c}
    finally:
        for _, log, proc in running:
            proc.kill()
            proc.wait()
            log.close()
        shutil.rmtree(out, ignore_errors=True)
    n = {"ok": 0, "skipped": 0, "failed": 0}
    for r in recs:
        n[r["status"]] = n.get(r["status"], 0) + 1
        if r["status"] != "ok":
            print(f"dryrun [{r['status']}] {r['arch']} {r['shape']} {r['mesh']}: "
                  f"{r.get('reason', r.get('error', ''))[:120]}", flush=True)
            continue
        c = r["collectives"]
        by = " ".join(f"{k}={v}" for k, v in c["counts"].items() if v)
        print(f"dryrun [ok] {r['arch']} {r['shape']} {r['mesh']} {r['total_s']} s: "
              f"{sum(c['counts'].values())} collectives ({by}), {c['total_bytes']} B per "
              f"device, {r['cost_analysis']['flops']:.6g} FLOPs per chip, arguments "
              f"{r['memory_analysis']['argument_size_in_bytes']} B, outputs "
              f"{r['memory_analysis']['output_size_in_bytes']} B", flush=True)
    n_mesh = 2 if meshes == "both" else 1
    print(f"dryrun: phase 13 (--mesh {meshes}) {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['failed']} failed; {len(codes)} children, {len(tails)} non-zero exits; "
          f"{wall:.1f} s", flush=True)
    if tails or n != {"ok": 32 * n_mesh, "skipped": 8 * n_mesh, "failed": 0}:
        raise AssertionError(f"phase 13: {n} (want {32 * n_mesh} ok, {8 * n_mesh} skipped, "
                             f"0 failed), non-zero exits {tails}")
    for r in recs:
        if r["status"] == "ok" and not {"collectives", "cost_analysis",
                                        "memory_analysis"} <= set(r):
            raise AssertionError(f"phase 13: {r['arch']} {r['shape']} lacks a measure")


# ------------------------------------ phase 14: the launchers under torchrun

TORCHRUN_TIMEOUT = 300.0        # seconds, per child


class _Child:
    """``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
    module flags`` (NCCL on cuda:0), started in a session of its own, its
    standard error in ``tmp`` and its exit timed by a thread of its own.
    ``result()`` waits for it, killing it whole past ``TORCHRUN_TIMEOUT``
    from its start, and returns (the summary of its last stdout line, the
    child's wall); it fails on a non-zero exit or a summary without launch
    counts."""

    def __init__(self, module: str, flags: list, tmp: Path):
        import os
        import threading
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        self.what = f"torchrun {module} {flags}"
        self.log = tmp / f"{module.rsplit('.', 1)[-1]}.err"
        self.out, self.end = "", None
        self.t0 = time.perf_counter()
        with open(self.log, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "1", "-m", module, *flags],
                env=env, stdout=subprocess.PIPE, stderr=err, text=True, start_new_session=True)
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self):
        self.out, _ = self.proc.communicate()
        self.end = time.perf_counter()

    def kill(self):
        """Kill the child's session if it still runs."""
        import os
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.waiter.join()

    def result(self) -> tuple:
        self.waiter.join(max(self.t0 + TORCHRUN_TIMEOUT - time.perf_counter(), 0.0))
        if self.waiter.is_alive():
            self.kill()
            raise AssertionError(f"{self.what}: not done after {TORCHRUN_TIMEOUT} s")
        wall = self.end - self.t0
        if self.proc.returncode != 0:
            raise AssertionError(f"{self.what} exited {self.proc.returncode}: "
                                 f"{self.log.read_text()[-3000:]}")
        lines = self.out.strip().splitlines()
        summary = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
        if "launches" not in summary:
            raise AssertionError(f"{self.what}: no counts in its last line: "
                                 f"{self.out[-1000:]}")
        return summary, wall


class _KeepLastSave:
    """The one-process run's checkpoint manager: a fresh start that writes
    nothing and keeps the state of its last save, so that state is held
    against the child's checkpoint in memory (one 18.5 GB write fewer)."""
    last = None

    def __init__(self, *args, **kwargs):
        pass

    def wait(self):
        pass

    def latest_step(self):
        return None

    def save(self, step, state, extra=None):
        type(self).last = (step, state)


class _Crc32:
    """A write-only file that keeps the CRC-32 and size of what it is given."""

    def __init__(self):
        self.crc, self.size = 0, 0

    def write(self, data):
        import zlib
        self.crc = zlib.crc32(data, self.crc)
        self.size += len(data)


def _bit_equal_to(state, path: Path) -> int:
    """Hold every leaf of ``state``, serialized as the checkpoint writes it
    (``np.savez``'s .npy member), against the checkpoint ``path``'s members
    by CRC-32 and size, from its zip directory (reading the 18.5 GB back
    would cost more than writing it); returns the leaf count."""
    import zipfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from repro_torch.ckpt.manager import _flatten, _host
    with zipfile.ZipFile(path) as z:
        saved = {i.filename[:-len(".npy")]: (i.CRC, i.file_size) for i in z.infolist()}
    leaves = _flatten(state)
    if set(leaves) != set(saved):
        raise AssertionError(f"checkpoint holds other leaves: "
                             f"{sorted(set(leaves) ^ set(saved))[:5]}")

    def crc_of(k):
        crc = _Crc32()
        np.lib.format.write_array(crc, _host(leaves[k]))
        return k, (crc.crc, crc.size)

    # four leaves at a time: the copies and zlib's CRC release the GIL
    with ThreadPoolExecutor(4) as pool:
        differ = [k for k, got in pool.map(crc_of, leaves) if got != saved[k]]
    if differ:
        raise AssertionError(f"{len(differ)} of {len(leaves)} leaves differ from one "
                             f"process's: {differ[:5]}")
    return len(leaves)


def torchrun_runs(torch, ops, tmp: Path) -> tuple:
    """Phase 14's runs: the serve child beside the first train child, then
    the resumed train child beside the one-process serve launcher, then
    the one-process train launcher alone (the card holds a QAT run's ~53
    GiB and a serving run's few together, never two QAT runs).  Returns
    (the train children's summaries, the one-process train summary and its
    kept state, the serve child's summary, the one-process serve summary
    and its B7 count, the walls {what: (wall, the launcher's own
    seconds)})."""
    import shutil

    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    tflags = ["--arch", LM_ARCH, "--ckpt-every", "2", "--ckpt-dir", str(tmp / "torchrun")]
    sflags = ["--arch", LM_ARCH, "--requests", "8", "--max-new-tokens", str(LM_NEW)]
    torch.cuda.empty_cache()
    children = []
    try:
        children.append(_Child("repro_torch.launch.train", tflags + ["--steps", "2"], tmp))
        children.append(_Child("repro_torch.launch.serve", sflags, tmp))
        first, w1 = children[0].result()
        children.append(_Child("repro_torch.launch.train", tflags + ["--steps", "3"], tmp))
        child, w_child = children[1].result()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        one_serve = serve_launcher.main(sflags + ["--device", "cuda"])
        w_one_serve = time.perf_counter() - t0
        b7 = ops.launch_counts()["flash_attention"]
        torch.cuda.empty_cache()
        second, w2 = children[2].result()
    finally:
        for c in children:
            c.kill()
    shutil.rmtree(tmp / "torchrun" / f"step_{2:010d}")     # 18.5 GB: keep the disk
    ops.reset_launch_counts()          # the summary reports this process's counts
    t0 = time.perf_counter()
    with mock.patch.object(train_launcher, "CheckpointManager", _KeepLastSave):
        one = train_launcher.main(tflags + ["--device", "cuda", "--steps", "3"])
    w_one = time.perf_counter() - t0
    last_step, state = _KeepLastSave.last
    _KeepLastSave.last = None
    walls = {"train torchrun --steps 2 (beside the serve child)": (w1, first["seconds"]),
             "serve torchrun (beside the first train child)": (w_child, child["seconds"]),
             "train torchrun --steps 3, resumed (beside the one-process serve launcher)":
                 (w2, second["seconds"]),
             "serve one process (beside the resumed train child)":
                 (w_one_serve, one_serve["seconds"]),
             "train one process --steps 3 (alone)": (w_one, one["seconds"])}
    return (first, second), (one, last_step, state), child, (one_serve, b7), walls


def torchrun_train(runs: Path, first, second, one, last_step, state) -> None:
    """Phase 14 (a): the train launcher's defaults (16 x 128, W8A8, remat)
    at qwen2-1.5B's full width under torchrun (world size 1, NCCL): 2 steps
    with a checkpoint at step 2, then ``--steps 3`` resumed from it; each
    step's loss and the state after step 3 against
    ``launch.train.main(['--device', 'cuda', '--steps', '3'])`` in this
    process (the cosine schedule's learning rate at steps 1 and 2 is the
    peak for a total of 2 or 3 steps, so one uninterrupted run of 3 is the
    same computation)."""
    if (first["start"], second["start"], first["world_size"], last_step) != (0, 2, 1, 3):
        raise AssertionError(f"phase 14 (a): starts {first['start']}, {second['start']}, "
                             f"world size {first['world_size']}, last save {last_step}")
    got = {int(k): v for r in (first, second) for k, v in r["losses"].items()}
    want = one["losses"]
    if got != want:
        raise AssertionError(f"phase 14 (a): losses {got} against one process {want}")
    counts = [first["launches"], second["launches"], one["launches"]]
    if any(sum(c.values()) for c in counts):
        raise AssertionError(f"phase 14 (a): a kernel launched on the QAT step: {counts}")
    t1 = time.perf_counter()
    n_leaves = _bit_equal_to(state, runs / f"step_{3:010d}" / "arrays.npz")
    w_cmp = time.perf_counter() - t1
    print(f"torchrun (a) train {LM_ARCH} full width, 16 x 128, W8A8, remat, world size 1 "
          f"(NCCL), mesh {first['mesh']}: steps 1-2 then resumed from step 2 for step 3, "
          f"losses {got} bit-equal to one process's; the state after step 3 bit-equal "
          f"({n_leaves} leaves of the child's checkpoint by CRC-32 and size against one "
          f"process's state in memory, {w_cmp:.3f} s); launches 0 in every run", flush=True)


def torchrun_serve(child, one, b7: int) -> None:
    """Phase 14 (b): the serve launcher at full width (W8A8, 8-bit KV) under
    torchrun, 8 requests x 16 new tokens, against the one-process launcher;
    B7 once per layer in each prefill, counted in the child."""
    from repro_torch.configs import get_config
    layers = get_config(LM_ARCH).n_layers
    prefills = -(-8 // 4)
    want_b7 = layers * prefills
    if child["launches"]["flash_attention"] != want_b7 or b7 != want_b7:
        raise AssertionError(f"phase 14 (b): B7 launched {child['launches']['flash_attention']} "
                             f"times in the child, {b7} in one process; "
                             f"want {layers} layers x {prefills} prefills")
    ref = [r.tolist() for r in one["results"]]
    moved = [j for j, (a, b) in enumerate(zip(child["results"], ref)) if a != b]
    if moved or len(child["results"]) != 8:
        raise AssertionError(f"phase 14 (b): requests {moved} differ from the one-process "
                             f"launcher's tokens")
    print(f"torchrun (b) serve {LM_ARCH} full width, W8A8 + 8-bit KV, world size 1 (NCCL), "
          f"mesh {child['mesh']}: {child['tokens']} tokens of 8 requests equal to the "
          f"one-process launcher's; B7 {child['launches']['flash_attention']} launches in the "
          f"child = {layers} layers x {prefills} prefills (one process: {b7})", flush=True)


def run_torchrun(torch, ops):
    """Phase 14: both LM launchers under torchrun against one process."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    card = card_line()
    tmp = Path(tempfile.mkdtemp(prefix="torchrun_"))
    try:
        (first, second), (one, last_step, state), child, (one_serve, b7), walls = \
            torchrun_runs(torch, ops, tmp)
        torchrun_train(tmp / "torchrun", first, second, one, last_step, state)
        del state
        torch.cuda.empty_cache()
        torchrun_serve(child, one_serve, b7)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for what, (wall, inner) in walls.items():
        print(f"torchrun (c) {what}: wall {wall:.3f} s (the launcher's own steps / serving "
              f"{inner:.3f} s); {card}", flush=True)
    print(f"torchrun: phase 14 in {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------ phase 15: the examples

ROOT = Path(__file__).resolve().parent
EX_WEIGHT_ONLY = 1e-6          # (b): weight-only relative errors, card vs CPU, absolute
EX_MEAN_STEPS = 20             # (c): steps in each mean of the falling-loss gate
# (c): the QAT run's steps, cut from the example's 200 so that the default
# run keeps a margin under its 1200 s on a slow host (1,142 s there with
# 200); a multiple of the example's --ckpt-every 50, so the rerun resumes
EX_STEPS = 100


def load_file(path: str):
    """The module in ``path`` (relative to the repo root; the example
    directories are no packages), loaded once and then taken from
    ``sys.modules``."""
    import importlib.util
    name = "_ex_" + path.replace("/", "_").removesuffix(".py")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / path)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module."""
    return load_file(f"examples_torch/{name}.py")


def _windowed(ops, fn, *args):
    """(``fn(*args)``, the launches of its window, its wall in s): the
    counts are set to 0 just before the call and read just after it; the
    wall ends in a sync."""
    import torch
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {k: v for k, v in ops.launch_counts().items() if v}, wall


def stdout_of(fn, *args):
    """``fn(*args)`` with its stdout captured: (its lines, its return)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue().splitlines(), out


def _window_is(window, want: dict, what: str) -> None:
    """Print one window's launches; fail unless they are ``want`` (kernel ->
    count, or None for at least one launch), and no other kernel."""
    print(f"launches in {what}: {window}", flush=True)
    ok = set(window) == set(want) and all(n is None or window[k] == n for k, n in want.items())
    if not ok:
        raise AssertionError(f"{what}: launches {window}, want {want} (None: at least one)")


def examples_host_tier(torch, np, ops) -> dict:
    """Phase 15 (a): quickstart and export_zoo run on the card through
    their ``main``, against the same ``main`` on the CPU in this process:
    codes, node lists, counts, match flags and the round-trip's exactness
    equal; quickstart's float32 MatMul within the order bound.  Neither
    reaches a kernel."""
    walls = {}
    qs = load_example("quickstart")
    got, window, walls["quickstart"] = _windowed(ops, qs.main, ["--device", "cuda"])
    _window_is(window, {}, "phase 15 (a), quickstart")
    _, want = stdout_of(qs.main, ["--device", "cpu"])
    differ = [k for k, v in want["operators"].items()
              if not np.array_equal(got["operators"][k], v)]
    differ += [k for k in ("nodes", "cleanup", "qcdq", "qcdq_match", "reingested")
               if got[k] != want[k]]
    x, w = (torch.from_numpy(a) for a in want["operands"])
    ref = torch.from_numpy(want["out"])
    d, bound = (torch.from_numpy(got["out"]) - ref).abs(), order_bound(x, w, ref)
    print(f"examples (a) quickstart: card vs CPU, {len(want['operators'])} operator outputs "
          f"and 5 node lists / flags compared, {differ or 'all equal'}; executor output "
          f"max |diff| {float(d.max()):.3e} (order bound {float(bound.max()):.3e})", flush=True)
    if differ or not bool(d.le(bound).all()):
        raise AssertionError(f"phase 15 (a) quickstart: card differs from CPU ({differ})")

    ez = load_example("export_zoo")
    got, window, walls["export_zoo"] = _windowed(ops, ez.main, ["--device", "cuda"])
    _window_is(window, {}, "phase 15 (a), export_zoo")
    _, want = stdout_of(ez.main, ["--device", "cpu"])
    keys = ("raw_nodes", "macs", "weights", "weight_bits", "bops", "clean_nodes",
            "channels_last", "qcdq_match", "bytes", "exact")
    differ = [k for k in keys if got[k] != want[k]]
    if not np.array_equal(got["out"], want["out"]):
        differ.append("out")
    print(f"examples (a) export_zoo: card vs CPU, {len(keys)} facts and the CNV-w2a2 output "
          f"compared, {differ or 'all equal'}; matches {got['channels_last']['match']} / "
          f"{got['qcdq_match']}, exact={got['exact']}; output max |card - CPU| "
          f"{float(np.abs(got['out'] - want['out']).max()):.3e} (bound 0: the oracle's "
          f"dyadic sums are exact)", flush=True)
    if differ or not (got["exact"] and got["qcdq_match"] and got["channels_last"]["match"]):
        raise AssertionError(f"phase 15 (a) export_zoo: card differs from CPU ({differ})")
    return walls


def examples_serving(torch, np, ops, dev) -> dict:
    """Phase 15 (b): serve_quantized's ``main`` on the card (its wall and
    window), then its five sections, each in a window of its own, on
    parameters drawn on the CPU and copied to the card, against the same
    sections on the CPU: calibration, the float engine, greedy float /
    W8A8 + 8-bit KV (prefill logits within LM_SMALL_REL_L2, tokens
    equal), the weight-only matmuls (B1, B2), TFC-w2a2 behind the
    scheduler (B2, B4; rows equal to the CPU oracle, phase 4's rule)."""
    from repro_torch.models import api, zoo
    sq = load_example("serve_quantized")
    cfg = sq.lm_config()
    b7 = "flash_attention"
    walls = {}
    _, window, walls["serve_quantized"] = _windowed(ops, sq.main, ["--device", "cuda"])
    _window_is(window, {b7: 3 * cfg.n_layers, "quant_matmul": None, "quant_matmul_int4": None,
                        "quant_dequant": None}, "phase 15 (b), serve_quantized main")

    p_cpu = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    p_dev = copy.deepcopy(p_cpu).to(dev)
    samples = [sq.seeded(i, (64,), "cpu", 1.5) for i in range(8)]
    got, window, _ = _windowed(ops, sq.calibration, [s.to(dev) for s in samples])
    _window_is(window, {}, "phase 15 (b) step 1")
    want = sq.calibration(samples)
    print(f"examples (b) step 1 calibration: card {got}, CPU {want} (mse not gated: its "
          f"search sums in the device's order)", flush=True)
    if (got["minmax"], got["pct99.9"]) != (want["minmax"], want["pct99.9"]):
        raise AssertionError("phase 15 (b) step 1: calibration differs from the CPU's")

    prompts = [np.arange(1, 6 + i) for i in range(4)]
    got, window, _ = _windowed(ops, sq.float_serving, p_dev, cfg, prompts)
    _window_is(window, {b7: cfg.n_layers}, "phase 15 (b) step 2 (one prefill)")
    want = sq.float_serving(p_cpu, cfg, prompts)
    same = all(np.array_equal(g, w) for g, w in zip(got["results"], want["results"]))

    toks = torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32)
    got_q, window, _ = _windowed(ops, sq.quantized_serving, p_dev, cfg, toks.to(dev))
    _window_is(window, {b7: 2 * cfg.n_layers}, "phase 15 (b) step 3 (two prefills)")
    want_q = sq.quantized_serving(p_cpu, cfg, toks)
    same = same and all(np.array_equal(got_q[k], want_q[k]) for k in ("float", "w8a8"))
    rels = {}
    for tag, c in (("float", cfg), ("w8a8kv8", cfg.replace(quant=_lm_recipe()))):
        lg, _ = api.prefill(p_dev, {"tokens": toks.to(dev)}, c, 13)
        lc, _ = api.prefill(p_cpu, {"tokens": toks}, c, 13)
        _spread(torch, lc, f"phase 15 (b) {tag} logits (CPU)")
        rels[tag] = float((lg.cpu() - lc).norm() / lc.norm())
    print(f"examples (b) steps 2-3: tokens equal on the card and the CPU: {same}; prefill "
          f"logits rel-L2 {rels} (bound {LM_SMALL_REL_L2}); agreement "
          f"{got_q['agreement']:.2f}", flush=True)
    if not same or max(rels.values()) > LM_SMALL_REL_L2:
        raise AssertionError("phase 15 (b) steps 2-3: serving on the card differs from the CPU")

    w = sq.up_projection(p_cpu)
    x = sq.seeded(9, (4, w.shape[0]), "cpu")
    got, window, _ = _windowed(ops, sq.weight_only, w.to(dev), x.to(dev))
    _window_is(window, {"quant_matmul": 1, "quant_matmul_int4": 1},
               "phase 15 (b) step 4 (B1, B2)")
    want = sq.weight_only(w, x)
    diff = max(abs(got[k] - want[k]) for k in want)
    print(f"examples (b) step 4 weight-only rel-err: card {got}, CPU {want}, max |diff| "
          f"{diff:.3e} (bound {EX_WEIGHT_ONLY})", flush=True)
    if diff > EX_WEIGHT_ONLY:
        raise AssertionError("phase 15 (b) step 4: weight-only errors differ from the CPU's")

    rng = np.random.default_rng(0)
    rows = [rng.standard_normal(784).astype(np.float32) for _ in range(6)]
    got, window, _ = _windowed(ops, sq.graph_serving, zoo.build_tfc(2, 2), rows, dev)
    _window_is(window, {"quant_matmul_int4": None, "quant_dequant": None},
               "phase 15 (b) step 5 (TFC-w2a2's plan: warm-up and capture)")
    want = sq.graph_serving(zoo.build_tfc(2, 2), rows, "cpu")
    equal = all(np.array_equal(r, o) for r, o in zip(got["results"], want["oracle"]))
    print(f"examples (b) step 5: census {got['fused_counts']} (CPU {want['fused_counts']}); "
          f"rows equal to the CPU oracle: {equal}; maxdiff vs the card's oracle "
          f"{got['maxdiff']:.2e}; p50 {got['latency_p50_ms']:.3f} ms, p99 "
          f"{got['latency_p99_ms']:.3f} ms", flush=True)
    if got["fused_counts"] != want["fused_counts"] or not equal:
        raise AssertionError("phase 15 (b) step 5: graph serving differs from the CPU")
    return walls


def examples_train_card_vs_cpu(torch, ops, tq) -> None:
    """Phase 15 (c), first: 3 steps of train_qat_lm's own config and
    hyperparameters (W4A8, smoke-widened, lr 3e-3 warming up over 20
    steps) over its stream's 16 x 32 batches, from one state on the CPU
    and its copy on the card: the 4-bit fake quant and its STE step.
    Each step's loss and the first step's grad_norm (the same parameters
    on both) within TRAIN_REL; the parameters within 2·Σ lr, AdamW's
    reach when a near-zero gradient's sign differs (ROADMAP C12: the
    card's and the CPU's activation codes part at ties)."""
    from repro_torch.data import SyntheticLMStream
    cfg, hyper = tq.build(tq.parse(["--device", "cpu", "--steps", "3"]))
    stream = SyntheticLMStream(vocab=cfg.vocab, global_batch=16, seq_len=32, seed=0)
    (rels, lrs, diffs), window, _ = _windowed(ops, steps_card_vs_cpu, torch, "cuda", cfg,
                                              hyper, 0, stream, 3)
    _window_is(window, {}, "phase 15 (c), train_qat_lm's 3 steps, card vs CPU")
    loss_rel, gn_rel, dp = max(r[0] for r in rels), rels[0][1], max(diffs.values())
    reach = 2 * sum(lrs)
    print(f"examples (c) train_qat_lm [{cfg.name}, {cfg.quant.tag()}, 16 x 32, lr {lrs}] card "
          f"vs CPU over 3 steps: loss rel {[f'{r[0]:.3e}' for r in rels]} (bound {TRAIN_REL}), "
          f"step-1 grad_norm rel {gn_rel:.3e} (bound {TRAIN_REL}; later steps "
          f"{[f'{r[1]:.3e}' for r in rels[1:]]}), parameters max abs {dp:.3e} (bound "
          f"{reach:.3e})", flush=True)
    if cfg.quant.tag() != "w4a8" or loss_rel > TRAIN_REL or gn_rel > TRAIN_REL or dp > reach:
        raise AssertionError("phase 15 (c): the W4A8 QAT steps on the card differ from the CPU")


def examples_training(torch, ops) -> dict:
    """Phase 15 (c): train_qat_lm's first 3 steps on the card against the
    CPU; then the example at its defaults (16 x 32, W4A8,
    smoke-widened) but EX_STEPS steps, then EX_STEPS + 20 resumed from
    step EX_STEPS, then
    ``--full --steps 2`` (qwen2-1.5B at published width); no kernel in any
    window; the checkpoints in a temporary directory removed after."""
    import tempfile
    tq = load_example("train_qat_lm")
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        examples_train_card_vs_cpu(torch, ops, tq)
        smoke = ["--device", "cuda", "--ckpt-dir", str(Path(tmp) / "smoke")]
        out, window, walls[f"train_qat_lm --steps {EX_STEPS}"] = _windowed(
            ops, tq.main, smoke + ["--steps", str(EX_STEPS)])
        _window_is(window, {}, f"phase 15 (c), train_qat_lm --steps {EX_STEPS}")
        losses = [out["losses"][k] for k in sorted(out["losses"])]
        first = statistics.mean(losses[:EX_MEAN_STEPS])
        last = statistics.mean(losses[-EX_MEAN_STEPS:])
        print(f"examples (c) --steps {EX_STEPS}: {out['recipe']}, {len(losses)} steps, mean "
              f"loss of the first {EX_MEAN_STEPS} {first:.4f}, of the last {last:.4f}; "
              f"{out['tok_per_s']:.0f} tok/s", flush=True)
        if out["recipe"] != "w4a8" or len(losses) != EX_STEPS or not math.isfinite(sum(losses)) \
                or not last < first:
            raise AssertionError("phase 15 (c): the QAT run's loss is not finite and falling")

        more = EX_STEPS + 20
        lines, (out, window, walls[f"train_qat_lm --steps {more}"]) = stdout_of(
            _windowed, ops, tq.main, smoke + ["--steps", str(more)])
        print("\n".join(lines), flush=True)
        _window_is(window, {}, f"phase 15 (c), train_qat_lm --steps {more}")
        if lines[0] != f"resuming from checkpoint step {EX_STEPS}" or out["start"] != EX_STEPS \
                or sorted(out["losses"]) != list(range(EX_STEPS + 1, more + 1)):
            raise AssertionError(f"phase 15 (c): --steps {more} did not resume from step "
                                 f"{EX_STEPS}")

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full, window, walls["train_qat_lm --full --steps 2"] = _windowed(
            ops, tq.main, ["--device", "cuda", "--full", "--steps", "2",
                           "--ckpt-dir", str(Path(tmp) / "full")])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _window_is(window, {}, "phase 15 (c), train_qat_lm --full --steps 2")
        print(f"examples (c) --full: {full['arch']} {full['recipe']} {full['params']:,} "
              f"parameters, losses {full['losses']}, 2 steps in {full['seconds']:.3f} s "
              f"({full['seconds'] / 2:.3f} s a step, the first's warm-up included), peak "
              f"{peak:.3f} GiB", flush=True)
        if full["recipe"] != "w4a8" or full["params"] < 1.5e9 \
                or not all(math.isfinite(v) for v in full["losses"].values()):
            raise AssertionError("phase 15 (c): the full-width run failed")
    if Path(tmp).exists():
        raise AssertionError(f"phase 15 (c): {tmp} was not removed")
    return walls


def run_examples(torch, np, dev, ops):
    """Phase 15: the four examples of ``examples_torch/`` on the card."""
    t0 = time.perf_counter()
    card = card_line()
    walls = examples_host_tier(torch, np, ops)
    walls.update(examples_serving(torch, np, ops, dev))
    torch.cuda.empty_cache()
    walls.update(examples_training(torch, ops))
    for what, wall in walls.items():
        print(f"examples: {what} wall {wall:.3f} s; {card}", flush=True)
    print(f"examples: phase 15 in {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False     # true fp32 twins
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # phase 1: build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s)", flush=True)
    print(_build.build_info.get("log", "(library reused)"), flush=True)
    if sys.argv[1:] == ["--plan-profiles"]:
        plan_profiles(torch, np, dev)
        return 0
    if sys.argv[1:] == ["--served"]:
        run_served_tier(torch, np, dev)
        return 0
    if sys.argv[1:] == ["--train"]:
        run_training(torch, dev, ops)
        print(f"card: {card}")
        return 0
    if sys.argv[1:] == ["--tune"]:
        run_tuning(torch, np, dev)
        print(f"card: {card}")
        return 0
    if sys.argv[1:] == ["--families"]:
        run_families(torch, dev, ops, {"flash_attention": 0.0})
        print(f"card: {card}")
        return 0
    if sys.argv[1:] == ["--mesh"]:
        run_mesh(torch, np, dev, ops)
        print(f"card: {card}")
        return 0
    if sys.argv[1:] == ["--dryrun"]:
        run_dryrun("both", timeout=1000)
        print(f"card: {card}")
        return 0
    if sys.argv[1:] == ["--torchrun"]:
        run_torchrun(torch, ops)
        print(f"card: {card}")
        return 0
    if sys.argv[1:] == ["--examples"]:
        run_examples(torch, np, dev, ops)
        print(f"card: {card}")
        return 0

    # phase 2: each kernel against its twin
    err = {k: 0.0 for k in REPLACES}
    n_mm = check_matmuls(ops, torch, np, dev, err)
    n_qd = check_quant_dequant(ops, torch, np, dev, err)
    n_gm = check_grouped_matmul(ops, torch, np, dev, err)
    n_dw = check_depthwise(ops, torch, np, dev, err)
    print(f"kernels vs twins: {n_mm} matmul cases, {n_qd} quant_dequant cases, "
          f"{n_gm} grouped matmul cases, {n_dw} depthwise cases; max_abs_err {err}",
          flush=True)
    n_int = check_integer(ops, torch, np, dev, err)
    print(f"integer bodies vs twins (torch.equal): {n_int} cases", flush=True)
    check_redesign(ops, torch, np, dev, err)
    check_b4_b1_redesign(ops, torch, np, dev, err)
    n_glue = check_glue(ops, torch, np, dev)
    print(f"boundary glue on the card vs the CPU (torch.equal): {n_glue} cases", flush=True)
    check_flash_attention(ops, torch, dev, err)

    # phases 3 + 4: the float32-epilogue path (use_analysis=False); phase 3's
    # plans (fusion off) and phase 4's engines (fused plans) in windows of
    # their own
    ops.reset_launch_counts()
    plans, served, (eng, xt), (meng, xm), (lplan, x8) = run_main_path(torch, np, dev)
    check_launched(plans, ZOO_KERNELS, "phase 3 (float32 epilogue, fusion off)")
    check_launched(served, SERVED_KERNELS, "phase 4 (float32 epilogue, fused engines)")

    # phases 3 + 4 again on the integer path (compile_graph's defaults)
    ops.reset_launch_counts()
    plans, served, (ieng, ixt), (imeng, ixm), (iplan, ix8) = run_integer_path(torch, np, dev)
    check_launched(plans, ZOO_KERNELS, "phase 3 (integer path, fusion off)")
    check_launched(served, SERVED_KERNELS, "phase 4 (integer path, fused engines)")

    # phase 3'': the fused path, compile_graph's defaults on both tiers; each
    # fused plan's launches are read around its own call.  These are the
    # main path's launches in the kernels line (the float32 tier under the
    # kernel's name, the integer tier under name/int32)
    keep, fused = run_fused_path(torch, np, dev)
    check_launched(fused["f32"], ZOO_KERNELS, "phase 3'' (fused plans, float32 epilogue)")
    check_launched(fused["int"], ZOO_KERNELS, "phase 3'' (fused plans, integer path)")
    launches = dict(fused["f32"])
    launches.update({k + "/int32": fused["int"][k] for k in INT_KERNELS})
    # phase 3''': the formats
    ops.reset_launch_counts()
    run_formats(torch, np, dev)
    check_launched(ops.launch_counts(), SERVED_KERNELS, "phase 3''' (the formats' plans)")

    # phase 5: times
    rows = timings(ops, torch, dev)
    report(rows, launches, err, "TFC M=256")
    print("(sums above: one TFC forward at M=256, four matmul layers and four "
          "activation quantizers)", flush=True)
    rows = timings_mobilenet(ops, torch, dev)
    kernels = report(rows, launches, err, f"MobileNet-224 N={SLOT}")
    print(f"(sums above: one MobileNet-w4a4 forward at img 224 with {SLOT} rows; "
          "B5 over the grouped conv's one layer)", flush=True)
    report(timings_qdq_division(ops, torch, dev), {QDQ_DIV: launches["quant_dequant"]},
           {QDQ_DIV: err["quant_dequant"]},
           f"MobileNet-224 N={SLOT}, B4 division")
    print("(above: B4's largest MobileNet-224 row at a scale that is no power of two, "
          "timed in the same run)", flush=True)
    tfc_int, mob_int, b2_rows, b6_rows = int_timings(ops, torch, dev)
    report(tfc_int, launches, err, "TFC M=256, integer")
    print("(sums above: one TFC forward at M=256 on the integer bodies)", flush=True)
    kernels += report(mob_int, launches, err, f"MobileNet-224 N={SLOT}, integer")
    print(f"(sums above: the 27 int32 segments of one MobileNet-w4a4 forward at img 224 "
          f"with {SLOT} rows, B2 on its int8 tensor-core body at IN_SCALE; B5 over the "
          f"grouped conv's one layer)", flush=True)
    b2_launches = {k: launches["quant_matmul_int4/int32"] for k in b2_rows}
    report(b2_rows, b2_launches, {k: err["quant_matmul_int4/int32"] for k in b2_rows},
           f"MobileNet-224 N={SLOT}, integer, B2 bodies")
    print("(sums above: B2's 13 pointwise layers on the int8 body at a power-of-two scale, "
          "with B3 and with the float32 epilogue, and on the IMAD body at IN_SCALE, timed in "
          "the same run)", flush=True)
    report(b6_rows, {B6_POW2: launches["quant_depthwise_conv2d/int32"]},
           {B6_POW2: err["quant_depthwise_conv2d/int32"]},
           f"MobileNet-224 N={SLOT}, integer, B6 power-of-two scale")
    print("(sums above: B6's 13 depthwise layers at a power-of-two scale, the reciprocal "
          "staging of the main path's scales, timed in the same run)", flush=True)
    profile_forward(torch, lplan, x8, "float32 epilogue")
    profile_forward(torch, iplan, ix8, "integer path")
    profile_forward(torch, ieng.plan, ixt[:16], "integer path", "TFC-w2a2")
    walls_in_turns(torch, {"float32 epilogue": lplan, "integer path": iplan}, x8)
    fusion_profiles(torch, keep)
    # engines in turns: float32, integer, integer, float32
    for model, pair in (("TFC-w2a2, max_batch=16", ((eng, xt), (ieng, ixt))),
                        (f"MobileNet-w4a4 img 224, max_batch={SLOT}", ((meng, xm), (imeng, ixm)))):
        for label, (e, xs) in zip(("float32 epilogue", "integer path", "integer path",
                                   "float32 epilogue"), pair + pair[::-1]):
            rate = requests_per_s(e, xs)
            print(f"engine[{label}]: {rate:.1f} requests/s ({model}, {len(xs)} requests per "
                  f"run_pending, median of 5)", flush=True)

    # phase 6: the LM serving path (B7), counted on its own
    lm_small_check(torch, dev)
    params, cfg, toks, lm_launches = run_lm_path(torch, np, dev, ops)
    launches["flash_attention"] = lm_launches["flash_attention"]
    # phase 7: LM timings
    rows = lm_attention_timings(torch, ops, cfg, dev)
    kernels.append(lm_kernel_entry(rows, launches, err, cfg))
    lm_walls(torch, params, cfg, toks)
    # phase 8: the captured plan per slot shape and the serving tier
    run_served_tier(torch, np, dev)
    # phase 9: QAT training (no kernel of the port on its path)
    del params, toks
    torch.cuda.empty_cache()
    run_training(torch, dev, ops)
    # phase 10: the launch-geometry autotuner (A15)
    torch.cuda.empty_cache()
    run_tuning(torch, np, dev)
    # phase 11: the vlm, moe, audio, ssm and hybrid families (A17)
    torch.cuda.empty_cache()
    run_families(torch, dev, ops, err)
    # phase 12: multi-device (A16) over a virtual mesh of the card
    torch.cuda.empty_cache()
    run_mesh(torch, np, dev, ops)
    # phase 13: the dry-run, after every timed phase (the default run
    # sweeps the single-pod mesh, --dryrun both)
    run_dryrun("single")
    # phase 14: both LM launchers under torchrun (NCCL, world size 1)
    torch.cuda.empty_cache()
    run_torchrun(torch, ops)
    # phase 15: the four examples (examples_torch/)
    torch.cuda.empty_cache()
    run_examples(torch, np, dev, ops)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
