#!/usr/bin/env python3
"""Prove the PyTorch/CUDA port (``src/repro_torch``) runs its main path on
one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one GPU

Phases, each fatal on failure (nonzero exit, no result line):

1. card check -- CUDA must be available; prints ``name, power.limit``;
2. build -- compiles every CUDA kernel source in ``src/repro_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, all started together; int4
   and APoT share ``weights_only_matmul.cu``, m2q and int8
   ``m2q_matmul.cu``, relu_attn and its scale kernel ``relu_attn.cu``)
   and prints the ``-Xptxas -v`` report;
3. kernel checks -- each of the eight kernels against its plain PyTorch
   version on the card, at every distinct shape of one EfficientViT-B1
   R224 forward at batch 8 under the recipe paths below (and, for
   ``m2q_matmul``, ``dwconv_w4``, ``relu_attn`` and its scales, of one
   m2q-w8a8 forward of each of Table III's other models, B1 R256 / R288
   and B2 R224, each its own path in the sums: phase 17) and of one
   qwen1.5-0.5b decode step at batch 8 (``decode_attn_int8`` at
   B=8 T=256 Hkv=16 G=1 D=64 with ragged lengths, plus a G=4 D=128 shape,
   a windowed case and the decode shape at B=1, 2 and 4, each row with
   its launch plan; ``int4_matmul`` also at the lm_head's M=8 K=1024
   N=151936; ``m2q_matmul`` also at the mixed qwen's shapes: one decode
   step at batch 8 -- (8, 1024, 1024) x 96, (8, 2816, 1024) x 24 and
   the lm_head (8, 1024, 151936) -- and one prefill group of 8 prompts of
   128 tokens; and at the dense LM pool's shapes (phase 10):
   ``decode_attn_int8`` at each config's decode step (B=8 T=256 Hkv=8
   D=128, G = 5, 4, 3, 2), ``int4_matmul`` at the four lm_heads (M=8,
   K x N = 5120 x 151936, 4096 x 49280, 3072 x 256000, 2048 x 92672),
   ``m2q_matmul`` at minitron-4b's mixed decode step, its lm_head and a
   prefill group of 8 prompts of 64 tokens; and at the MoE LMs' shapes
   (phase 11): ``decode_attn_int8`` at llama4-scout's G 5 and dbrx's G 6
   (Hkv 8, D 128), ``int4_matmul`` at llama4-scout's lm_head (M 8, K
   5120, N 202112), ``m2q_matmul`` at dbrx's mixed decode step and
   prefill group -- attention slices at M 8 / 512, each expert's w1, w3
   (K 6144, N 10752) and w2 (K 10752, N 6144) at its capacity of 8 / 160
   rows, the lm_head (8, 6144, 100352)); and at the recurrent LMs'
   shapes (phase 12): ``int4_matmul`` at rwkv6-3b's and
   recurrentgemma-9b's lm_heads (M 8, K x N = 2560 x 65536, 4096 x
   256000), ``m2q_matmul`` at the mixed rwkv's decode step -- seven
   layer slices of 32 layers, (8, 2560, 2560) x 6 and (8, 8960, 2560),
   and the lm_head (8, 2560, 65536) -- and a prefill group of 2 x 64
   tokens (``rwkv_m2q_calls``), with kernel / plain /
   library device times (CUDA graphs
   timed by CUDA events) and the card's least time for the same work
   (m2q_matmul, int8_matmul and int4_matmul also per path: their shapes
   of different paths never run in one forward; every row but
   decode_attn_int8's also records the launch shape).  int8, dwconv and
   relu_attn (bf16 out, timed, and f32 out), m2q (f32 out) and relu_attn_scales (against
   the plain scale chain it replaces, timed as its plain version) must
   equal their plain versions bit for bit; the f32-dot kernels (int4,
   APoT) must sit within the f32 summation bound; decode_attn_int8
   within two flipped p8 codes per (b, h, g) row (f32 store), its bf16
   store (the served one, timed) equal to the f32 store rounded once, and
   two replays of one CUDA graph bit-identical;
4. main path -- ``init`` at full B1 R224 width, ``recipe.quantize(...,
   "m2q-w8a8")`` with synthesized calibration, ``serve(max_batch=8)``
   once eager (``graphs=False``) and once with the engine's CUDA graphs,
   each engine serving 12 submitted images twice (polled to completion;
   the graphed engine's first pass captures its buckets, timed apart as
   ``graph_capture_s``) and classifying them once; checks the launch
   counters in every pass (42 m2q / 20 dwconv / 14 relu_attn / 14
   relu_attn_scales launches per forward, 0 plain calls), every pass's
   logits equal to the eager engine's first at zero tolerance (the same
   batches: relu_attn's scales span the batch), and the logits against a
   plain-version forward of the same batches on the card (equal at zero
   tolerance on the integer paths, m2q-w8a8, uniform8 and the int8
   stem; within 2e-2 of max |logit| on the weights-only ones); reports
   served images/s both ways; times the batch-8 forward (eager, in a
   CUDA graph, plain) and traces it with torch.profiler; then the
   artifact:
   ``qm.save`` and ``QuantizedModel.load(..., device="cuda")`` (timed,
   with the artifact's bytes), every leaf bit-identical with equal class
   and static fields, equal cfg, recipe, reports, act_stats and
   provenance, and a new engine's graph-served logits of the 12 images
   and its launch counts equal to the original's at zero tolerance;
5. the other recipe paths, each the same way (counters, leaf types,
   logits vs the plain-version forward, the batch-8 forward in a CUDA
   graph, the artifact round trip; ``uniform8`` also eager, plain and
   traced, the others not):
   ``uniform8`` (42 int8_matmul + 14 + 14 attention per forward), the
   opt-in int8 stem (1 int8_matmul + the m2q path's 90),
   ``w4-weights-only`` (42 int4_matmul + 20 dwconv + 14 + 14 attention)
   and weights-only APoT (42 apot_matmul + 20 dwconv + 14 + 14
   attention);
6. the token path -- qwen1.5-0.5b at full width with the int8 KV cache,
   ``recipe.quantize(..., "m2q-w8a8")`` on the card (every dense leaf
   4-bit at the decode shape), ``serve(max_batch=8, max_len=256,
   seed=0)`` once eager and once with the engine's decode-step graphs,
   each engine running 16 requests (prompts of 8-96 tokens, 24-40 new
   tokens, two at temperature 0.8) to completion twice; checks leaf
   types, the launch counters in every pass (decode_attn_int8 = 24 per
   decode step, int4_matmul = one per step and per prefill group, 0
   plain calls), every handle's token count, every graph-served token
   list equal to the eager engine's pass for pass (sampled requests
   included), and teacher-forced kernel logits against
   ``reference_path()`` logits; where a served token is not the
   teacher-forced argmax, prints the logits' top-2 margin there and the
   served token's gap to the top, which must stay within the logits'
   bound; times the batch-8 decode step (eager, in a CUDA graph -- a
   step that cannot be captured fails the run -- and plain), traces one
   with torch.profiler, times the per-step dequantizes of the layer
   weights no kernel takes (``plain_dequant_ms_per_step``) and reports
   the served tokens/s both ways and, over one more graphed pass, its
   time in prefill and in decode steps;
   the artifact round trip as in phase 4 (~0.3 GB of 4-bit payload), a
   new engine's graph-served tokens of the 16 requests at seed 0 and its
   launch counts equal to the original's first graphed pass; then
   ``token-m2q``, the same run of the mixed LM: ``m2q-w8a8`` at 64 tokens
   a step, so wq, wk, wv, wo and w2 are QExpertM2Q leaves of 24 layers,
   w1/w3 perm-folded QM2Q leaves without an activation scale and the
   lm_head a calibrated QM2Q; 121 m2q_matmul (5 x 24 + 1) and 24
   decode_attn_int8 launches per decode step, 121 m2q_matmul per prefill
   group, no int4_matmul (~0.54 GB artifact);
7. the trained proxy -- the reduced B1 the JAX package trained on the
   synthetic vision task: its committed JAX-written ``m2q-w8a8`` artifact
   (``results/artifacts/proxy_efficientvit_m2q``) loaded on the card
   classifies ``expected.json``'s 256 images through the kernels (int8
   attention; the launch counts printed) and with f32 attention; both
   forwards' logits must equal the same forward's under
   ``reference_path()`` exactly, and the f32-attention ones the JAX
   package's recorded logits and predictions within ``proxy_vs_jax``'s
   bounds; reports top-1 beside JAX's, the float proxy's, and the port's
   own quantization of the float proxy on the card (its top-1, and the
   payload bytes that differ from the JAX artifact's).

8. the serving runtime -- (a) ``repro_torch.launch.serve.main`` in-process
   at full width (qwen1.5-0.5b, int8 KV, ``--max-batch 8 --max-len
   256``, 8 requests of 16 new tokens): its ``requests=`` / ``decoded=``
   / ``tok/s=`` lines, and its launches equal to what its leaves route
   (decode_attn_int8 24 per decode step, int4_matmul one per step and
   group, 0 plain calls); (b) phase 6's ``token`` artifact (kept on disk
   for this phase, as phase 4's ``m2q-w8a8`` one is) loaded on the card
   and driven through one scripted manual run, once from the engine's
   CUDA graphs and once eagerly, each at seed 0 with
   ``debug_numerics=True`` and ``raise@prefill:2,nan@decode:5``: 8
   preemptible batch-class requests (two streamed, one at temperature
   0.8), then 2 interactive ones; both runs must fail the same uids
   with the same classes (``InjectedFault`` for the prefill group,
   ``NumericalError`` for the one poisoned slot), deliver the same
   tokens at zero tolerance, preempt at least once with the evicted
   stream kept, stream what they return, reconcile, and launch
   decode_attn_int8 24 times a step; the decode step in a CUDA graph
   with the cache scan off and on; (c) a ``ServingDaemon`` over a new
   graphed engine of that artifact serving ``launch.daemon.
   serve_traffic``'s 16 requests from a foreign thread, the first
   interactive one streamed: streamed == result, reconciled, the daemon
   stopped, launches as routed; time to first token, token gaps,
   per-class p50/p99 and tokens/s printed; (d) a daemon over phase 4's
   ``m2q-w8a8`` artifact serving 12 images submitted from a foreign
   thread in the interactive and batch classes: every handle DONE,
   reconciled, 42 / 20 / 14 / 14 launches per forward (logits are not
   gated here: daemon batches form by timing, and relu_attn's scales
   span the batch);

9. supervised serving -- (a) ``python -m repro_torch.launch.daemon --arch
   qwen1.5-0.5b --recovery-smoke`` in-process at full width: its
   ``recovery smoke ok`` line (a restart, every request exact or within
   the teacher-forced bound, the journal exact) and its kernels launched,
   no plain call; (b) :func:`supervised_cases` over phase 6's ``token``
   artifact (int8 KV, ``max_batch`` 8, graphs), each engine build warmed
   and captured in the factory before it is armed: ``crash@decode`` (one
   restart), ``hang@decode`` after 2 s (a HungStepError restart whose new
   engine is built and captured after the released serve thread left), a
   streamed request across a restart (streamed == result), every build
   armed until the circuit opens (CircuitOpenError on every handle, a
   rejected submit, the torn-down engine freed before each rebuild, and
   allocated memory after restart 3 within half an engine of restart
   1's), and a second supervisor cold-starting from the journal of a
   first stopped like a dead process; goodput 100% where no circuit
   opens, the journals exact with 0 pending, replayed tokens equal to a
   fault-free run's or, only where the replay's prefill group had another
   size or padded length, within the teacher-forced
   5e-2-of-max-|logit| bound (counts printed), launches as the engines'
   steps and prefill groups route them; (c) :func:`process_kill_replay`: a child process
   serving the artifact on the card is SIGKILLed mid-flight and a fresh
   one replays its journal to exact reconciliation; (d)
   :func:`supervised_vision` over phase 4's artifact under
   ``crash@vision``: 12 images DONE after the restart, 42 / 20 / 14 / 14
   launches per forward; (e) the CLI's ``--health-file`` read while it
   serves: a ready snapshot, the JAX package's keys (``HEALTH_KEYS``), 0
   restarts, no torn file; (f) per restart, detection, teardown, backoff,
   factory and recovery seconds and allocated bytes, printed beside the
   card.  The artifacts are removed at the end.

10. the dense LM pool -- (a) qwen3-14b, granite-3-8b, minitron-4b and
   internvl2-2b at their published widths with the int8 KV cache: each
   ``init`` on the card (seed 0), ``recipe.quantize(..., "m2q-w8a8",
   release=True)`` at the decode deployment shape (every leaf 4-bit; the
   float tree handed over and dropped leaf by leaf, so qwen3-14b's 59 GB
   f32 tree quantizes within the card), then 8 greedy requests of 8-64
   prompt tokens and 16 new tokens through ``Engine(max_batch=8,
   max_len=256)`` eagerly and from its CUDA graphs (a capturing pass and
   a timed one): graph tokens equal eager tokens, no token >=
   ``vocab_size`` (granite's and internvl2's vocabularies are padded),
   every pass's launches equal to what the quantized tree routes
   (:func:`tree_launches`: decode_attn_int8 once a layer a step,
   int4_matmul once a step and a prefill group), teacher-forced kernel
   logits within 5e-2 of max |logit| of ``reference_path()``'s; prints
   init and quantize seconds, peak allocated bytes, the graphed decode
   step (qwen3-14b's also with its torch.profiler trace: busy ms, the
   costliest kernels) and tokens/s; (c) internvl2-2b's stub frontend: a prefill of 256
   patch embeddings ahead of 4 prompts, then 8 decode steps, kernels
   against plain versions within the same bound; (b) minitron-4b again
   at 64 tokens a step, the mixed LM with its relu2 group (161
   m2q_matmul and 32 decode_attn_int8 launches a decode step).

11. the MoE LMs -- at their published widths with the int8 KV cache,
   the depth cut (the f32 trees do not fit the card whole):
   llama4-scout-17b-a16e (2 of 48 layers; 16 experts top-1 and a shared
   expert, G 5, vocab 202048 -> 202112) under m2q-w8a8 at the decode
   shape (every leaf 4-bit, the experts (L, 16, K, N/2) QUniform leaves:
   decode_attn_int8 2 and int4_matmul 1 a decode step), and dbrx-132b (1
   of 40 layers; 16 experts top-4, G 6) at 256 tokens a step (64 an
   expert: the experts (L, 16, K, N) QExpertM2Q leaves, attention and the
   lm_head mixed: 53 m2q_matmul -- 16 a leaf and layer for the experts,
   4 attention slices a layer, the lm_head -- and 1 decode_attn_int8 a
   decode step), one at a time: ``init`` on the card (seed 0),
   ``quantize(..., release=True)``, the leaves checked, the artifact
   saved and loaded on the card (leaf for leaf bit-identical), then the
   loaded model served as in phase 10 (8 greedy requests x 16 tokens,
   eager and graphed tokens equal, launches as ``tree_launches`` counts
   them, 0 plain calls, teacher-forced logits within 5e-2 of max |logit|
   of ``reference_path()``'s); prints peaks, init / quantize / save /
   load seconds, the graphed decode step, tokens/s and each model's
   full-depth 4-bit tree bytes from ``abstract_quantize``.

12. the recurrent LMs -- at their published widths (``RECURRENT_CASES``):
   rwkv6-3b at full depth (32 layers, 40 heads of 64, vocab 65536) under
   m2q-w8a8 at the decode shape (all 4-bit: int4_matmul 1 a decode step
   and a prefill group) and at 64 tokens a step (mixed: 225 m2q_matmul
   a step and a group -- 7 ``QExpertM2Q`` slices of 32 layers, cw_k
   perm-folded, a mixed lm_head), and recurrentgemma-9b cut to 8 of 38
   layers (rec, rec, attn twice and two tail recurrent layers; G 16,
   window 2048, vocab 256000) under w4-weights-only (a calibrating
   recipe fails in the reference): ``recurrent_case`` = ``init`` on the
   card, ``quantize(..., release=True)``, ``leaf_problems``, then 8
   greedy requests of 8, 32 and 64 prompt tokens and 16 new tokens
   through ``Engine(max_batch=8, max_len=256)``, whose exact-length
   buckets take three prefill groups a pass, eager and graphed (tokens
   equal, none >= vocab, launches as ``tree_launches`` counts them, 0
   plain calls, teacher-forced logits within 5e-2 of max |logit| of
   ``reference_path()``'s and of the eager ``forward``'s at the same
   positions); recurrentgemma also one request of 2040 prompt tokens
   and 16 new ones at ``max_len=2304`` through a one-slot engine (its
   2048-row ring wraps during decode; its eager prefill timed alone),
   and its full-depth 4-bit tree bytes from ``abstract_quantize``.
   Prints peaks, init / quantize seconds, the graphed decode step and
   tokens/s beside the card (the MoE and recurrent decode steps are no
   longer traced: the run's time went to phase 15).

13. whisper -- whisper-large-v3 at its published width and depth (32
   encoder + 32 decoder layers, d 1280, 20 heads of 64, vocab 51866 ->
   51968, 1500 frames) under w4-weights-only (a calibrating recipe fails
   in the reference), through ``whisper_case``: ``init`` on the card
   (seed 0), ``quantize(..., release=True)``, every leaf 4-bit, the
   artifact saved and loaded bit for bit, then 8 greedy prompts of 16
   tokens over seeded (8, 1500, 1280) frames through the model's own
   ``prefill(..., frames=)`` and 32 ``decode_step`` calls, eagerly and
   with the step in a CUDA graph (tokens equal; the token Engine
   prefills without frames, so it fails a whisper request in both
   packages); the decode logits within 5e-2 of max |logit| of the
   teacher-forced ``forward(tokens, frames=)``, no id >= vocab, no kernel
   launched (no whisper leaf reaches one, as in the reference) and no
   plain call.  Prints peaks, quantize / save / load seconds and the
   artifact's bytes, ``encode`` ms at batch 8, prefill seconds, the
   decode step eager and graphed, tokens/s both ways, one traced step
   and its split into the dequantize chain, self attention and cross
   attention (``whisper_split_ms``).

14. training -- qwen1.5-0.5b at its published width and depth (24
   layers, d 1024, 16 heads of 64, d_ff 2816, vocab 151936; 620 M f32
   parameters, bf16 compute, per-layer remat) trained on SyntheticLM by
   ``python -m repro_torch.launch.train`` on the card: 50 steps of 8 x
   256 tokens (100 until PR 31), lr 1e-3 (cosine, warmup 5), every step
   logged; (a) the
   training run stops after step 4 (publishing it) and a second process
   resumes from that checkpoint to the end: every step logged once,
   every loss and grad norm finite, the last 10 steps' mean loss below
   the first 10's, no straggler; prints the first and last losses, the
   median step time, tokens/s and the trainer's peak allocated bytes;
   (b) a straight run of 10 steps whose losses and grad norms must equal
   the resumed run's exactly, and ``launch.elastic.run_supervised`` on
   the card at REDUCED width with a hard crash after step 7 (one
   restart, the replayed step logged twice with equal losses); both run
   beside (a)'s first part; (c) the final checkpoint's parameters
   restored, quantized under phase 6's ``token`` and ``token-m2q``
   recipes (calibrated on held-out SyntheticLM batches), each served
   to 8 greedy requests on held-out SyntheticLM prompts through
   ``pool_serve`` (eager and graphed tokens equal, launches as
   ``tree_launches`` counts them, 0 plain calls, teacher-forced logits
   within 5e-2 of max |logit| of ``reference_path()``'s); prints the
   float and both quantized models' cross-entropy on 4 held-out batches.
   The published steps (7.45 GB each) are removed at the end.
15. kernel dispatch and autotuning -- the port's autotune cache is a
   fresh file under ``chiprun_out`` from the top of the run, and phases
   4-14 run inside ``autotune.no_tuning()`` (their plans stay
   ``launch_plan``'s); :func:`autotune_case`: (a) the offline sweep's CI
   set walked on the card, (b) every shape re-tuned into the cache, each
   candidate checked against the plain version, and one lazy tune at
   an eager call (none inside a capture), (c) ``autotune_sweep
   --smoke`` on the cache in a child process, (d) B1 m2q-w8a8 and
   uniform8 at batch 8 from the warmed cache against an empty cache,
   and qwen token-m2q, (e) the dispatch axes: all off (no launch), a
   tripped conv axis in ``Supervisor.health()``.  Prints one line per
   tuned shape;
16. sharded serving (:func:`run_sharded`) -- two ranks on the one card
   (child processes of :func:`sharded_child`, joined through
   ``launch.daemon``'s coordinator path; gloo, since NCCL refuses two
   ranks on one device), against this process's unsharded eager engines
   on the same artifacts: (a) phase 4's ``m2q-w8a8`` B1 artifact restored
   with ``shardings=`` on a (data=2, model=1) mesh serving the 12 images
   at max_batch 8, every rank's logits equal to the unsharded engine's
   at zero tolerance, 42 / 20 / 14 / 14 launches a forward on each rank;
   (b) phase 6's ``token`` qwen1.5-0.5b artifact tensor-parallel on a
   (data=1, model=2) mesh (8 of 16 heads, FFN 1408 of 2816 and lm_head
   75968 of 151936 columns a rank; every leaf's placement checked),
   serving phase 6's 16 requests through a ``ServingDaemon`` on each
   rank (rank 0's releases the other at shutdown): the ranks' tokens
   equal, each greedy
   token the unsharded engine's or within the teacher-forced bound of
   the unsharded kernel model's logits (the margins printed), sampled
   requests equal or diverging after a first differing draw (reported),
   launches as phase 6 counts them on each rank; phase 3 checks
   ``int4_matmul`` at a rank's lm_head (N 75968) and ``decode_attn_int8``
   at its 8 heads; (c) phase 11's dbrx-132b artifact (1 of 40 layers,
   ``m2q-w8a8`` at 256 tokens a step) expert-parallel on (data=1,
   model=2): 8 of 16 experts, 24 / 4 of 48 / 8 heads and lm_head 50176
   of 100352 columns a rank; layer 0's MoE on a fixed 512-row input
   equal to the unsharded layer's at zero tolerance, the 8 LM-pool
   prompts served (16 tokens each) with greedy tokens the unsharded
   engine's or within the teacher-forced bound, ``m2q_matmul`` (8
   experts x 3, the attention slices, the lm_head shard) and
   ``decode_attn_int8`` launched as ``tree_launches`` counts a rank's
   tree; (d) recurrentgemma-9b at its published width, 3 of 38 layers
   (rec, rec, attn), ``w4-weights-only``, drawn on the card and saved,
   on the same mesh (8 of 16 query heads, the single KV head gathered,
   the recurrence replicated, ``int4_matmul`` on the lm_head shard of
   128000 columns), phase 12's 8 prompts under the same gates; phase 3
   checks ``m2q_matmul`` at dbrx's sharded attention and lm_head
   shapes, ``decode_attn_int8`` at its 4 KV heads (G 6) and
   ``int4_matmul`` at recurrentgemma's lm_head shard.  Prints the
   backend, seconds, and the sharded and unsharded eager images/s and
   tokens/s beside the card.
17. the paper's accuracy tables and Table III's models
   (:func:`run_tables`) -- (a) ``launch.tables.run`` over the committed
   trained proxy on the card (Tables I-IV, 20 rows, f32 attention) held
   by ``tables.reference_check`` against the JAX package's rows
   (``results/proxy_tables_jax.json``): every replaced leaf's sha256
   equal but for PoT elements at a rounding tie of log2 (counted), the
   Eq. 6 splits equal (or each flipped filter's penalty gap within float
   noise), at most PROXY_MISMATCHES predictions differing a row, top-1
   printed beside JAX's; (b) ``data.proxy.train_proxy`` on the card (300
   steps of 32 images, seed 0) into ``chiprun_out``: a falling loss, the
   committed proxy unchanged, the file reloading as the trained tree,
   its Table I printed with the schemes' order (reported, not gated);
   (c) B1 R256, B1 R288 and B2 R224 at full width (seeded init) under
   m2q-w8a8 calibrated on 2 SyntheticVision batches of 8 at their
   resolution, each through :func:`run_path` at batch 8: m2q_matmul,
   dwconv_w4, relu_attn and relu_attn_scales launched as
   ``main_path_calls`` counts them, no plain call, graph-served logits
   equal to eager ones and eager ones to the plain-version forward's at
   zero tolerance, the artifact round trip.
18. qlint over the port's op graphs (:func:`run_qlint`) -- the
   invariant sweep of ``python -m repro_torch.launch.qlint`` on the
   card: every config of ``analysis.traces.DEFAULT_SWEEP`` at REDUCED
   width, each hot path recorded with every dispatch axis on, and the
   sharded qwen decode on two gloo ranks of the card (child processes,
   started first and run beside the sweep); fails unless the card's
   ledger equals ``results/qlint_baseline_torch.json`` (the CPU's,
   nothing new and nothing gone: :func:`qlint_problems`) and every
   kernel node ran its kernel, not its plain version.  Prints each
   trace's verdict counts and kernel nodes, and the phase's seconds.

Each phase's wall seconds go to ``chip_smoke_phases.json``, and the
run's total seconds are printed beside the card; phase 3 draws its
inputs on the card (seeded CUDA generators).

It then prints the card's name and power limit again, one JSON line with
every kernel's numbers and, last, the ``{"ok": true, "device": ...}``
line.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12     # outside the tensor cores

BATCH = 8
N_IMAGES = 12

# The trained proxy's JAX-written m2q-w8a8 artifact served with f32
# attention, against the JAX package's dispatch-off logits (expected.json).
# Measured with the same forward on the CPU (plain versions,
# tests/test_torch_artifact.py) and on an H100 (kernels): 251 of the 256
# images' logits are bit-identical to JAX's on each, 5 differ (3 of them
# the same images on both) by up to 0.067 (CPU) and 0.146 (H100) of a max
# |logit| of 8.18 -- float summation order moves an activation across an
# int8 rounding step upstream -- and no prediction differs.  The gate: at
# most PROXY_IMAGES_OFF images differ by more than PROXY_FLOAT of JAX's
# max |logit| (a float slip; a wrong kernel or quantizer moves nearly
# every image), none by more than PROXY_LOGITS of it, and at most
# PROXY_MISMATCHES predictions differ (2 images have a JAX top-2 margin
# below five times the CPU's largest difference).
PROXY_FLOAT = 1e-3
PROXY_IMAGES_OFF = 10
PROXY_LOGITS = 5e-2
PROXY_MISMATCHES = 2


def proxy_vs_jax(got, want):
    """The proxy gate: (numbers, failures) of f32-attention logits ``got``
    against the JAX package's ``want``, both (images, classes)."""
    import numpy as np
    top = float(np.abs(want).max())
    per_image = np.abs(got - want).max(1)
    res = dict(logits_max_abs_diff=float(per_image.max()),
               jax_logits_max_abs=top,
               images_off=int((per_image > PROXY_FLOAT * top).sum()),
               predictions_differing=int((got.argmax(-1) != want.argmax(-1))
                                         .sum()))
    failures = []
    if res["images_off"] > PROXY_IMAGES_OFF:
        failures.append(f"{res['images_off']} images' logits differ from "
                        f"JAX's by more than {PROXY_FLOAT} of {top} (bound "
                        f"{PROXY_IMAGES_OFF} images)")
    if not res["logits_max_abs_diff"] <= PROXY_LOGITS * top:
        failures.append(f"logits differ from JAX's by "
                        f"{res['logits_max_abs_diff']} (bound {PROXY_LOGITS}"
                        f" of {top})")
    if res["predictions_differing"] > PROXY_MISMATCHES:
        failures.append(f"{res['predictions_differing']} predictions differ "
                        f"from JAX's (bound {PROXY_MISMATCHES})")
    return res, failures


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms over ``iters`` back-to-back eager calls
    (CUDA events): device time plus whatever launch gaps the host leaves."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def capture(fn, iters: int = 1):
    """(graph, output of the last call): ``iters`` calls of ``fn``
    captured in a CUDA graph after three warm-up calls on a side stream.
    The capture is begun by hand, after what ``torch.cuda.graph`` does
    first (a synchronize, the allocator's cache emptied) but its full
    garbage collection: this script captures hundreds of graphs (three a
    kernel row in phase 3), and each collection walks the whole process;
    the phases collect at their own boundaries instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    # no garbage collection inside the capture: freeing an engine of an
    # earlier path (engines sit in reference cycles) would free its CUDA
    # graphs, a CUDA call that invalidates this capture
    gc.disable()
    try:
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                for _ in range(iters):
                    y = fn()
            finally:
                graph.capture_end()
    finally:
        gc.enable()
    torch.cuda.current_stream().wait_stream(side)
    return graph, y


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn`` call in ms: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so host launch
    overhead is out of the measurement."""
    import torch
    graph, _ = capture(fn, iters)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def device_profile(fn, iters: int = 3, top: int = 8) -> dict:
    """Trace ``iters`` eager calls of ``fn`` with torch.profiler: device
    busy ms per call (kernels on one stream do not overlap), the busy share
    of the traced span (deflated: the profiler slows the host's launches),
    and the kernels that took the most device time.  Empty when the trace
    holds no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return {}
    busy = sum(e.time_range.elapsed_us() for e in kern)
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern))
    by_name = Counter()  # keyed by the name's first 120 characters, so
    for e in kern:       # kernels that share them are summed, not dropped
        by_name[e.name[:120]] += e.time_range.elapsed_us()
    ranked = by_name.most_common(top)
    return {"busy_share_profiled": busy / span,
            "span_ms": span / 1e3 / iters,
            "busy_ms": busy / 1e3 / iters,
            "kernels_per_call": len(kern) // iters,
            "top_ms_per_call": {n: t / 1e3 / iters for n, t in ranked}}


def main_path_calls(cfg, batch: int):
    """Every kernel call of one forward, in order: m2q (path, M, K, N),
    dwconv (path, B, H, W, C, k, stride), attention (B, N, heads, D)."""
    r = -(-cfg.img_res // 2)  # after the stride-2 stem
    m2q, dw, attn = [], [], []
    cin = cfg.widths[0]
    for si, (w, d) in enumerate(zip(cfg.widths, cfg.depths)):
        for bi in range(d):
            stride = 2 if (bi == 0 and si > 0) else 1
            p = f"stages/{si}/{bi}"
            mid = cin * 4
            m2q.append((f"{p}/mb/w_pw1", batch * r * r, cin, mid))
            dw.append((f"{p}/mb/w_dw", batch, r, r, mid, 3, stride))
            r = -(-r // stride)
            m2q.append((f"{p}/mb/w_pw2", batch * r * r, mid, w))
            if si >= len(cfg.widths) - 2:
                m2q.append((f"{p}/msa/w_qkv", batch * r * r, w, 3 * w))
                dw.append((f"{p}/msa/w_agg", batch, r, r, 3 * w, 5, 1))
                heads = w // cfg.dim_per_head
                attn += [(batch, r * r, heads, cfg.dim_per_head)] * 2
                m2q.append((f"{p}/msa/w_proj", batch * r * r, 2 * w, w))
            cin = w
    m2q.append(("head/w_in", batch * r * r, cin, cin * 4))
    m2q.append(("head/w", batch, cin * 4, cfg.n_classes))
    return m2q, dw, attn


class Tally:
    """One kernel's checks and times, per distinct shape and summed over
    one forward (each shape weighted by its launches per forward)."""

    KEYS = ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
            "bytes_ms", "ops_ms")

    def __init__(self, name: str, source: str = None):
        self.name = name
        self.source = source or name
        self.rows = []
        self.total = dict.fromkeys(self.KEYS, 0.0)
        self.by_path = {}  # recipe path -> its own sums, where paths differ
        self.err = 0.0
        self.err_ratio = None  # largest err / bound of the f32-dot kernels

    def measure(self, shape: dict, count: int, kernel, plain, library,
                nbytes: float, ops_ms: float, err_bound=None,
                path: str = None, timed=None) -> None:
        """Hold ``kernel()`` against ``plain()`` and time kernel, plain and
        ``library`` (a PyTorch yardstick, or None).  ``path``: the recipe
        path this shape belongs to, where one kernel serves two paths that
        never run in one forward; each gets its own sums.  ``timed``: the
        launch to time in place of ``kernel`` (the served one, where the
        check holds another store of the same kernel).

        ``err_bound`` None: the kernel's integer sums are exact and its
        float steps repeat the plain version's operations in the same
        order with IEEE rounding, so equality is expected; 1e-6 of the
        output's magnitude leaves room only for a rounding-order slip.
        ``err_bound`` a number or a per-element tensor: the limit itself
        (0.0 demands bit equality; the f32-dot kernels pass the f32
        summation bound), and the row records the largest err / bound."""
        import torch
        y, y_ref = kernel(), plain()
        if isinstance(y, tuple):  # (sq, sk, sv)
            y, y_ref = torch.stack(y), torch.stack(y_ref)
        torch.cuda.synchronize()
        diff = (y - y_ref).abs()
        err = float(diff.max())
        scale = float(y_ref.abs().max())
        if err_bound is None:
            err_bound = 1e-6 * max(scale, 1.0)
        ratio = float((diff / err_bound).nan_to_num(0.0).max()) \
            if torch.is_tensor(err_bound) else None
        if not bool(torch.all(diff <= err_bound)):
            fail(f"{self.name} {shape}: max_abs_err {err} vs |y| {scale} "
                 f"(err / bound {ratio})")
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        timed = timed or kernel
        row = dict(shape, count=count, err=err, ms=graph_ms(timed),
                   eager_ms=cuda_ms(timed), plain_ms=graph_ms(plain, 5),
                   library_ms=graph_ms(library) if library else None,
                   bound_ms=max(b_ms, ops_ms), bytes_ms=b_ms, ops_ms=ops_ms)
        row["bound_by"] = "bytes" if b_ms >= ops_ms else "operations"
        if ratio is not None:
            row["err_over_bound"] = ratio
            self.err_ratio = max(self.err_ratio or 0.0, ratio)
        self.rows.append(row)
        sums = [self.total]
        if path is not None:
            row["path"] = path
            sums.append(self.by_path.setdefault(
                path, dict.fromkeys(self.KEYS, 0.0)))
        for total in sums:
            for key in self.KEYS:
                total[key] += count * (row[key] or 0.0)
        self.err = max(self.err, err)

    @staticmethod
    def _sums(t: dict, library: bool) -> dict:
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                             else "operations"),
                "library_ms": t["library_ms"] if library else None}

    def entry(self, replaces: str, launches: int, library: bool) -> dict:
        e = {"name": self.name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{self.source}.cu",
             "replaces": replaces, "launches": launches,
             "max_abs_err": self.err, **self._sums(self.total, library),
             "err_over_bound": self.err_ratio}
        if self.by_path:
            e["per_path"] = {p: self._sums(t, library)
                             for p, t in self.by_path.items()}
        return e


def _randn(torch, rng, shape, std=1.0, dtype=None):
    """Normals of ``std`` on the card, drawn by a CUDA generator seeded
    from ``rng`` (drawing them on the host took most of phase 3's time at
    the billion-weight lm_heads)."""
    g = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(2 ** 63 - 1)))
    t = torch.randn(tuple(shape), generator=g, device="cuda") * std
    return t if dtype is None else t.to(dtype)


def check_m2q(torch, rng, calls_by_path) -> Tally:
    """m2q_matmul at every distinct (M, K, N) of each path in
    ``calls_by_path`` (the B1 forward's mixed layers; the mixed qwen's
    decode step and prefill group), summed per path, bf16 x, bit-exact;
    each row records the launch shape the wrapper chose (tile, K splits,
    blocks).  Yardstick: one bf16 torch.matmul on the dequantized
    weight.  The entry's top-level ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` sum every path given (one B1 forward, one decode step
    and one prefill group); the B1 forward's own sums, the figure the
    entry gave before the LM paths joined it, are
    ``per_path["m2q-w8a8"]``.  One weight is drawn and quantized per (K,
    N) and shared by the paths that run that shape (a decode step and a
    prefill group); each row's activation scale is its own x's."""
    import dataclasses
    from repro_torch.core.qtensor import QM2Q
    from repro_torch.core.quant import act_scale_from_stats
    from repro_torch.core.scheme_select import select_schemes
    from repro_torch.kernels import m2q_matmul as k
    tally = Tally("m2q_matmul")
    weights = {}
    for path, calls in calls_by_path.items():
        for (M, K, N), n in Counter([c[1:] for c in calls]).items():
            x = _randn(torch, rng, (M, K), dtype=torch.bfloat16)
            if (K, N) not in weights:
                w = _randn(torch, rng, (K, N), std=K ** -0.5)
                asn = select_schemes(w)
                weights[K, N] = QM2Q.quantize(w, asn.apot_idx,
                                              asn.uniform_idx)
                del w
            qt = dataclasses.replace(weights[K, N], act_scale=(
                act_scale_from_stats(torch.tensor(float(x.abs().max())))
                .to(x.device)))
            args = (x, qt.act_scale, qt.payload, qt.u_scale.reshape(-1),
                    qt.u_zp.reshape(-1), qt.a_scale.reshape(-1))
            w_deq = qt.dequant(torch.bfloat16)
            # each column is computed by its own engine: int8 MACs on the
            # uniform half, bf16-exact MACs on the APoT half
            ops_ms = 2.0 * M * K * (qt.n_uniform / INT8_OPS_PER_S
                                    + qt.n_apot / BF16_FLOPS_PER_S) * 1e3
            tally.measure(dict(M=M, K=K, N=N), n,
                          lambda: k.m2q_matmul(*args),
                          lambda: k.m2q_matmul_plain(*args),
                          lambda: torch.matmul(x, w_deq),
                          M * K * 2 + K * N + 3 * N * 4 + 4 + M * N * 4,
                          ops_ms, err_bound=0.0, path=path)
            tally.rows[-1]["launch"] = k.launch_plan(M, K, N)
            del qt, args, w_deq
    return tally


def check_dwconv(torch, rng, calls_by_path) -> Tally:
    """dwconv_w4 at every distinct conv shape of each path in
    ``calls_by_path`` (one forward of each EfficientViT config), summed
    per path, with bf16 x and bf16 y, the launch the served paths make,
    bit for bit against the plain version cast to bf16; the f32-out
    launch is held bit for bit too (untimed).
    Each row records the launch shape (``launch_plan``).  Bytes count y at
    its stored 2 B.  Yardstick: one cuDNN grouped conv2d (bf16,
    channels-last view, symmetric padding)."""
    import torch.nn.functional as F
    from repro_torch.core.qtensor import QUniform
    from repro_torch.kernels import dwconv_w4 as k
    tally = Tally("dwconv_w4")
    for path, calls in calls_by_path.items():
        for (B, H, W, C, ks, s), n in Counter(
                [c[1:] for c in calls]).items():
            x = _randn(torch, rng, (B, H, W, C), dtype=torch.bfloat16)
            qt = QUniform.quantize(
                _randn(torch, rng, (ks * ks, C), std=1 / ks), bits=4)
            args = (x, qt.payload, qt.scale.reshape(-1),
                    qt.zero_point.reshape(-1), ks, ks, s)
            y32, y32_ref = (k._launch(*args, torch.float32),
                            k.dwconv_w4_plain(*args, torch.float32))
            if not torch.equal(y32, y32_ref):
                fail(f"dwconv_w4 {(B, H, W, C, ks, s)} f32 out: "
                     f"max_abs_err {float((y32 - y32_ref).abs().max())}")
            del y32, y32_ref
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last view, no copy
            w_oihw = qt.dequant(torch.bfloat16).reshape(ks, ks, C).permute(
                2, 0, 1).unsqueeze(1).contiguous()
            HO, WO = -(-H // s), -(-W // s)
            nbytes = (B * H * W * C * 2 + ks * ks * C // 2 + 2 * C * 4
                      + B * HO * WO * C * 2)
            ops_ms = (2.0 * B * HO * WO * C * ks * ks / F32_FLOPS_PER_S
                      * 1e3)
            tally.measure(dict(B=B, H=H, W=W, C=C, k=ks, stride=s), n,
                          lambda: k.dwconv_w4(*args, torch.bfloat16),
                          lambda: k.dwconv_w4_plain(*args, torch.bfloat16),
                          lambda: F.conv2d(x_nchw, w_oihw, stride=s,
                                           padding=ks // 2, groups=C),
                          nbytes, ops_ms, err_bound=0.0, path=path)
            tally.rows[-1]["launch"] = k.launch_plan(B, H, W, C, ks, s)
            tally.rows[-1]["f32_out_exact"] = True
    return tally


def _attn_qkv(torch, rng, B, N, Hh, D):
    """bf16 q, k, v as the MSA hands them over: column slices of one
    (B, N, 3C) tensor."""
    C = Hh * D
    qkv = _randn(torch, rng, (B, N, 3 * C), dtype=torch.bfloat16)
    return [t.reshape(B, N, Hh, D) for t in torch.split(qkv, C, dim=-1)]


def check_attn(torch, rng, calls_by_path) -> Tally:
    """relu_attn at both MSA token counts, on strided q/k/v slices of one
    qkv tensor, with bf16 q/k/v and bf16 y (the launch the served paths
    make), bit for bit against the plain version rounded once to bf16;
    the f32-out launch is held bit for bit too (untimed).  Each row
    records the launch plan (token slices a cluster, CTAs).  Bytes count
    y at its stored 2 B.  No single PyTorch call computes int8 linear
    attention; the f32 einsum path (the port's other token mixer) is
    timed as the yardstick but reported as no
    library."""
    from repro_torch.kernels import relu_attn as k
    from repro_torch.kernels import relu_attn_scales as ks
    from repro_torch.nn.attention import relu_linear_attention
    tally = Tally("relu_attn")
    for path, calls in calls_by_path.items():
        for (B, N, Hh, D), n in Counter(calls).items():
            q, kk, v = _attn_qkv(torch, rng, B, N, Hh, D)
            sc = ks.relu_attn_scales_plain(q, kk, v)
            y32, y32_ref = (k._launch(q, kk, v, *sc, 1e-6),
                            k.relu_attn_plain(q, kk, v, *sc))
            if not torch.equal(y32, y32_ref):
                fail(f"relu_attn {(B, N, Hh, D)} f32 out: max_abs_err "
                     f"{float((y32 - y32_ref).abs().max())}")
            del y32, y32_ref
            C = Hh * D
            ops = B * Hh * (4.0 * N * D * D + 3.0 * N * D)
            tally.measure(dict(B=B, N=N, H=Hh, D=D), n,
                          lambda: k.relu_attn(q, kk, v, *sc,
                                              out_dtype=torch.bfloat16),
                          lambda: k.relu_attn_plain(
                              q, kk, v, *sc, out_dtype=torch.bfloat16),
                          lambda: relu_linear_attention(q, kk, v,
                                                        attn="f32"),
                          3 * B * N * C * 2 + 3 * 4 + B * N * C * 2,
                          ops / INT8_OPS_PER_S * 1e3, err_bound=0.0,
                          path=path)
            tally.rows[-1]["launch"] = k.launch_plan(B, N, Hh, D)
            tally.rows[-1]["f32_out_exact"] = True
    return tally


def check_scales(torch, rng, calls_by_path) -> Tally:
    """relu_attn_scales at both MSA shapes, on the same strided bf16
    slices, bit for bit against the plain chain it replaces (q.max,
    k.max, |v|.max and the scalar steps after each: ~20 launches, timed
    as the plain version).  Each row records the launch plan (the one
    cluster's CTAs).  Bytes: q, k and v read once, three f32 scales
    written; operations: one comparison an element at the f32 rate.  No single PyTorch call computes the three scales (library:
    none)."""
    from repro_torch.kernels import relu_attn_scales as ks
    tally = Tally("relu_attn_scales", source="relu_attn")
    for path, calls in calls_by_path.items():
        for (B, N, Hh, D), n in Counter(calls).items():
            q, kk, v = _attn_qkv(torch, rng, B, N, Hh, D)
            elems = 3 * B * N * Hh * D
            tally.measure(dict(B=B, N=N, H=Hh, D=D), n,
                          lambda: ks.relu_attn_scales(q, kk, v),
                          lambda: ks.relu_attn_scales_plain(q, kk, v), None,
                          elems * 2 + 3 * 4, elems / F32_FLOPS_PER_S * 1e3,
                          err_bound=0.0, path=path)
            tally.rows[-1]["launch"] = ks.launch_plan(B, N, Hh * D, True)
    return tally


def _int_mm_fits(M, K, N) -> bool:
    """torch._int_mm's shape rules on CUDA: M > 16, K and N multiples of
    8."""
    return M > 16 and K % 8 == 0 and N % 8 == 0


def check_int8(torch, rng, calls_by_path) -> Tally:
    """int8_matmul at every distinct (M, K, N) of each path in
    ``calls_by_path`` (the uniform8 PWConvs; the int8 stem's im2col'd
    conv), summed per path, with bf16 x and bf16 y, the launch the served
    paths make, bit for bit against the plain version cast to bf16; the
    f32-y launch is held bit for bit too (untimed).  Each row records the
    launch shape (``launch_plan``).  Bytes count y at its stored 2 B.
    Yardstick: torch._int_mm on the quantized activations where its shape
    rules allow, else one bf16 torch.matmul on the dequantized weight."""
    from repro_torch.core.qtensor import QUniform
    from repro_torch.core.quant import quantize_act
    from repro_torch.kernels import int8_matmul as k
    tally = Tally("int8_matmul", source="m2q_matmul")
    for path, calls in calls_by_path.items():
        for (M, K, N), n in Counter([c[1:] for c in calls]).items():
            x = _randn(torch, rng, (M, K), dtype=torch.bfloat16)
            qt = QUniform.quantize(_randn(torch, rng, (K, N), std=K ** -0.5),
                                   bits=8, act_max_abs=float(x.abs().max()))
            args = (x, qt.payload, qt.act_scale, qt.scale.reshape(-1),
                    qt.zero_point.reshape(-1))
            y32, y32_ref = k._launch(*args), k.int8_matmul_plain(*args)
            if not torch.equal(y32, y32_ref):
                fail(f"int8_matmul {(M, K, N)} f32 out: max_abs_err "
                     f"{float((y32 - y32_ref).abs().max())}")
            del y32, y32_ref
            if _int_mm_fits(M, K, N):
                xq = quantize_act(x, qt.act_scale)
                library = lambda: torch._int_mm(xq, qt.payload)  # noqa: E731
            else:
                w_deq = qt.dequant(torch.bfloat16)
                library = lambda: torch.matmul(x, w_deq)  # noqa: E731
            tally.measure(dict(M=M, K=K, N=N), n,
                          lambda: k.int8_matmul(*args, torch.bfloat16),
                          lambda: k.int8_matmul_plain(*args, torch.bfloat16),
                          library,
                          M * K * 2 + K * N + 2 * N * 4 + 4 + M * N * 2,
                          2.0 * M * K * N / INT8_OPS_PER_S * 1e3,
                          err_bound=0.0, path=path)
            tally.rows[-1]["launch"] = k.launch_plan(M, K, N)
            tally.rows[-1]["f32_out_exact"] = True
    return tally


def check_weights_only(torch, rng, name, calls_by_path) -> Tally:
    """``int4_matmul`` (the w4-weights-only PWConvs; the qwen lm_head) or
    ``apot_matmul`` (the weights-only APoT PWConvs) at every distinct
    (M, K, N) of each path in ``calls_by_path``, summed per path; within
    the f32 summation bound (each row records its largest err / bound and
    the launch shape: kernel, tile, K splits, blocks).  Yardstick: one
    bf16 torch.matmul on the dequantized weight.  Operations count at the
    bf16 tensor-core rate: x is bf16 and each decoded weight is a
    bf16-exact value ((q - zp) an integer in [-15, 15]; an APoT value has
    at most 8 significant bits) times a per-filter scale the epilogue
    applies: the kernel's bf16 MMA with f32 sums, within the same
    summation bound."""
    from repro_torch.core.qtensor import QAPoT, QUniform
    from repro_torch.kernels import apot_matmul, int4_matmul
    k = int4_matmul if name == "int4_matmul" else apot_matmul
    kernel, plain = getattr(k, name), getattr(k, f"{name}_plain")
    tally = Tally(name, source="weights_only_matmul")
    for path, calls in calls_by_path.items():
        for (M, K, N), n in Counter([c[1:] for c in calls]).items():
            x = _randn(torch, rng, (M, K), dtype=torch.bfloat16)
            w = _randn(torch, rng, (K, N), std=K ** -0.5)
            if k is int4_matmul:
                qt = QUniform.quantize(w, bits=4)
                args = (x, qt.payload, qt.scale.reshape(-1),
                        qt.zero_point.reshape(-1))
                w_bytes = K * N // 2 + 2 * N * 4
            else:
                qt = QAPoT.quantize(w)
                args = (x, qt.codes, qt.scale.reshape(-1))
                w_bytes = K * N + N * 4
            del w
            w_hat = qt.dequant()
            w_deq = w_hat.to(torch.bfloat16)
            tally.measure(dict(M=M, K=K, N=N), n, lambda: kernel(*args),
                          lambda: plain(*args),
                          lambda: torch.matmul(x, w_deq),
                          M * K * 2 + w_bytes + M * N * 4,
                          2.0 * M * K * N / BF16_FLOPS_PER_S * 1e3,
                          err_bound=int4_matmul.f32_dot_bound(x.float(),
                                                              w_hat),
                          path=path if len(calls_by_path) > 1 else None)
            tally.rows[-1]["launch"] = int4_matmul.launch_plan(M, K, N)
            del w_hat, w_deq, qt, args
    return tally


def decode_valid_rows(lengths, T: int, window=None):
    """Cache rows the decode attention must read per batch row: the valid
    ones, or all T where every position is masked (length 0)."""
    rows = []
    for n in lengths:
        lo = max(0, n - window) if window is not None else 0
        hi = min(n, T)
        rows.append(hi - lo if hi > lo else T)
    return rows


def graph_replays(torch, fn):
    """``fn()`` captured once in a CUDA graph and replayed twice: the two
    replays' outputs (cloned)."""
    graph, y = capture(fn)
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(y.clone())
    return outs


def sdpa_reference_ms(torch, q, k8, v8, lengths, window):
    """Device ms of torch.nn.functional.scaled_dot_product_attention on
    bf16 q, k and v of the same shape (k and v repeated over the group)
    under the same mask: a float attention, not the same function, timed
    as a reference only."""
    import torch.nn.functional as F
    B, H, G, D = q.shape
    T = k8.shape[1]
    qs = q.reshape(B, H * G, 1, D)
    k, v = (t.to(torch.bfloat16).permute(0, 2, 1, 3)
            .repeat_interleave(G, dim=1).contiguous() for t in (k8, v8))
    pos = torch.arange(T, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = pos < lens
    if window is not None:
        valid &= pos >= lens - window
    mask = valid[:, None, None, :]
    return graph_ms(lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask))


def check_decode_attn(torch, rng, n_layers: int, pool=()) -> Tally:
    """decode_attn_int8 at the token path's decode shape (B=8, T=256,
    Hkv=16, G=1, D=64, bf16 q, ragged lengths as the served run holds
    them; ``n_layers`` launches per decode step), at the decode shape of
    each ``(name, cfg)`` of ``pool`` (B=8, T=256, its Hkv, G and D, lengths
    9-80 as its served run holds them; ``cfg.n_layers`` launches per
    step; each a path of its own, as the qwen step is), plus a GQA shape
    (G=4, D=128), a windowed case and the decode shape at batch 1, 2 and
    4, which no path runs (0 launches).  Each row: the f32 store
    within two flipped p8 codes per (b, h, g) row of the plain version
    (the share of elements within 1e-6 of max |out| recorded); the bf16
    store (the served one, timed) equal to the f32 store rounded once,
    at zero tolerance; two replays of one CUDA graph of the bf16 launch
    bit-identical to each other and to the eager launch; the launch plan
    (``launch_plan``).  No single PyTorch call computes int8 decode
    attention (library: none); scaled_dot_product_attention on bf16 q, k
    and v of the same shape and mask is timed as a reference and marked
    not the same function.  Bytes: bf16 q, the valid cache rows (int8 k
    and v, f32 row scales), bf16 out."""
    from repro_torch.kernels import decode_attn_int8 as k
    from repro_torch.nn.attention import quantize_kv_rows
    tally = Tally("decode_attn_int8")
    cases = [  # (B, T, Hkv, G, D, lengths, window, launches per step,
        #          path)
        (8, 256, 16, 1, 64, [1, 256] + list(rng.integers(8, 137, 6)), None,
         n_layers, "qwen1.5-0.5b decode step"),
        (8, 256, 4, 4, 128, list(rng.integers(1, 257, 8)), None, 0, None),
        (8, 256, 16, 1, 64, list(rng.integers(1, 257, 8)), 64, 0, None),
    ] + [(B, 256, 16, 1, 64, list(rng.integers(8, 137, B)), None, 0, None)
         for B in (1, 2, 4)] + [
        (8, 256, c.n_kv_heads, c.n_heads // c.n_kv_heads, c.head_dim,
         list(rng.integers(9, 81, 8)), None, c.n_layers,
         f"{name} decode step") for name, c in pool]
    for B, T, H, G, D, lengths, window, n, path in cases:
        lengths = [int(x) for x in lengths]
        q = _randn(torch, rng, (B, H, G, D), dtype=torch.bfloat16)
        k8, ks = quantize_kv_rows(_randn(torch, rng, (B, T, H, D)))
        v8, vs = quantize_kv_rows(_randn(torch, rng, (B, T, H, D)))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        args = (q, k8, v8, ks, vs, lens, D ** -0.5, window)
        shape = dict(B=B, T=T, Hkv=H, G=G, D=D, window=window,
                     lengths=lengths)

        def served():
            return k.decode_attn_int8(*args, out_dtype=torch.bfloat16)
        y32, y16 = k.decode_attn_int8(*args), served()
        if not torch.equal(y16, y32.to(torch.bfloat16)):
            fail(f"decode_attn_int8 {shape}: the bf16 store differs from "
                 "the f32 store rounded to bf16")
        replays = graph_replays(torch, served)
        if not (torch.equal(replays[0], replays[1])
                and torch.equal(replays[0], y16)):
            fail(f"decode_attn_int8 {shape}: two replays of one CUDA graph "
                 "(or the eager launch) differ")
        rows = sum(decode_valid_rows(lengths, T, window))
        nbytes = (B * H * G * D * 2 + rows * H * (2 * D + 8)
                  + B * H * G * D * 2 + B * 4)
        ops_ms = 4.0 * rows * H * G * D / INT8_OPS_PER_S * 1e3
        tally.measure(shape, n, lambda: k.decode_attn_int8(*args),
                      lambda: k.decode_attn_int8_plain(*args), None,
                      nbytes, ops_ms, err_bound=k.error_bound(*args),
                      timed=served, path=path)
        y_ref = k.decode_attn_int8_plain(*args)
        err = (y32 - y_ref).abs()
        row = tally.rows[-1]
        row["share_within_1e-6_of_max"] = float(
            (err <= 1e-6 * float(y_ref.abs().max())).float().mean())
        # the bound over every cache row, as if all T were valid
        row["bound_all_rows_ms"] = (B * H * G * D * 4 + B * T * H * (2 * D + 8)
                                    + B * 4) / HBM_BYTES_PER_S * 1e3
        row["launch"] = k.launch_plan(B, T, H, G, D)
        row["bf16_store_is_f32_cast"] = True
        row["graph_replays_identical"] = True
        row["sdpa_ms_not_same_function"] = sdpa_reference_ms(
            torch, q, k8, v8, lens, window)
    return tally


def _get(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


# per recipe path: the leaf each (dense, depthwise, stem) weight becomes,
# as leaf_kind() names it, and the kernel launches of one forward as
# multiples of (dense, depthwise, attention) calls plus fixed extras
PATHS = {
    "m2q-w8a8": (("QM2Q+act", "QUniform4", "float"),
                 {"m2q_matmul": "dense", "dwconv_w4": "dw",
                  "relu_attn": "attn", "relu_attn_scales": "attn"}),
    "uniform8": (("QUniform8+act", "QUniform8", "float"),
                 {"int8_matmul": "dense", "relu_attn": "attn",
                  "relu_attn_scales": "attn"}),
    "int8-stem": (("QM2Q+act", "QUniform4", "QUniform8+act"),
                  {"int8_matmul": 1, "m2q_matmul": "dense",
                   "dwconv_w4": "dw", "relu_attn": "attn",
                   "relu_attn_scales": "attn"}),
    "w4-weights-only": (("QUniform4", "QUniform4", "float"),
                        {"int4_matmul": "dense", "dwconv_w4": "dw",
                         "relu_attn": "attn", "relu_attn_scales": "attn"}),
    "apot-weights-only": (("QAPoT", "QUniform4", "float"),
                          {"apot_matmul": "dense", "dwconv_w4": "dw",
                           "relu_attn": "attn",
                           "relu_attn_scales": "attn"}),
}


# the paths whose served logits equal the plain-version forward's exactly
# (integer kernels only)
EXACT_PATHS = ("m2q-w8a8", "uniform8", "int8-stem")


def path_recipe(name: str):
    """The recipe of one path, built through the port's public API (the
    int8 stem and weights-only APoT are recipes, not presets)."""
    from repro_torch import recipe
    from repro_torch.core.policy import M2QPolicy
    from repro_torch.models import efficientvit as ev
    if name == "int8-stem":
        return recipe.PRESETS["m2q-w8a8"].replace(
            rules=tuple(ev.QUANT_RULES) + (ev.STEM_RULE,),
            overrides=(ev.STEM_OVERRIDE,))
    if name == "apot-weights-only":
        return recipe.QuantRecipe(name=name, policy=M2QPolicy(
            compute_scheme="apot", quantize_activations=False))
    return recipe.PRESETS[name]


def leaf_kind(leaf) -> str:
    from repro_torch.core.qtensor import QAPoT, QM2Q, QUniform
    act = "+act" if getattr(leaf, "act_scale", None) is not None else ""
    if isinstance(leaf, QM2Q):
        return "QM2Q" + act
    if isinstance(leaf, QUniform):
        return f"QUniform{leaf.bits}" + act
    if isinstance(leaf, QAPoT):
        return "QAPoT" + act
    return "float"


ARTIFACTS = ROOT / "build" / "chip_smoke_artifacts"
# the artifacts later phases serve again (phases 8 and 16; phase 11's
# dbrx, phase 16 (c)); main() removes them at the end
KEPT_ARTIFACTS = ("m2q-w8a8", "token", "dbrx-132b")


def _bits(torch, t):
    """``t``'s bits as an integer tensor (equal bits, not equal values)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def check_same_model(torch, what, a, b, device: str = "cuda") -> None:
    """Fail unless ``b`` (a loaded artifact) holds ``a``'s model: every
    leaf of the same class with equal static fields and bit-identical
    tensors on ``device`` (the card), and equal cfg, recipe, reports and
    act_stats."""
    import dataclasses
    from repro_torch.core.tree import leaves_with_path
    la, lb = dict(leaves_with_path(a.params)), dict(leaves_with_path(b.params))
    if sorted(la) != sorted(lb):
        fail(f"{what}: the loaded tree's leaves differ: "
             f"{sorted(set(la) ^ set(lb))[:5]}")
    for key, x in la.items():
        y = lb[key]
        if type(x) is not type(y):
            fail(f"{what}: {key} loaded as {type(y).__name__}, saved as "
                 f"{type(x).__name__}")
        pairs = ({"": (x, y)} if isinstance(x, torch.Tensor) else
                 {f.name: (getattr(x, f.name), getattr(y, f.name))
                  for f in dataclasses.fields(x)})
        for field, (u, v) in pairs.items():
            if isinstance(u, torch.Tensor):
                same = (isinstance(v, torch.Tensor) and u.dtype == v.dtype
                        and u.shape == v.shape and v.device.type == device
                        and torch.equal(_bits(torch, u), _bits(torch, v)))
            else:
                same = u == v
            if not same:
                fail(f"{what}: {key} {field} is not bit-identical after "
                     "save and load")
    for field in ("cfg", "recipe", "report", "act_stats", "provenance"):
        if getattr(a, field) != getattr(b, field):
            fail(f"{what}: the loaded {field} differs from the saved one")


def round_trip(torch, qm, what: str, device: str = "cuda",
               root: Path = ARTIFACTS):
    """``qm.save`` under ``root`` and ``QuantizedModel.load(...,
    device=device)`` (the card), timed; fails unless the loaded model is
    ``qm``'s.  Returns (the loaded model, {artifact_bytes, save_s,
    load_s}).  The artifact is removed, but for the paths in
    ``KEPT_ARTIFACTS``."""
    import shutil
    from repro_torch import recipe
    path = Path(root) / what
    if path.exists():
        shutil.rmtree(path)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
    try:  # fail() exits through here too: no artifact stays behind
        t0 = time.perf_counter()
        step_dir = qm.save(path)
        t1 = time.perf_counter()
        loaded = recipe.QuantizedModel.load(path, device=device)
        if on_card:
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = sum(f.stat().st_size for f in step_dir.iterdir())
        check_same_model(torch, what, qm, loaded, device)
    finally:
        if what not in KEPT_ARTIFACTS:
            shutil.rmtree(path, ignore_errors=True)
    return loaded, {"artifact_bytes": size, "save_s": t1 - t0,
                    "load_s": t2 - t1}


def poll_until_done(engine, handles, what: str) -> None:
    """Poll a VisionEngine until every handle is done (300 s at most)."""
    t0 = time.perf_counter()
    while not all(h.done() for h in handles):
        if time.perf_counter() - t0 > 300:
            fail(f"{what}: requests still pending after 300 s of polling")
        engine.poll()
        time.sleep(0.001)


def run_path(torch, cfg, name, calls, out_dir, full: bool,
             calib_batches=None):
    """Quantize a full-width EfficientViT (``cfg``, B1 R224 in phases
    4-5) under one recipe path, from ``calib_batches`` or synthesized
    calibration, serve 12 images eagerly and from the engine's CUDA
    graphs, and check leaves, launch counters and logits (equal to the
    plain-version forward's at zero tolerance on the integer paths,
    ``EXACT_PATHS``).  ``full``: also time the eager and plain-version
    forwards and trace one with torch.profiler."""
    import numpy as np
    from repro_torch import kernels, recipe
    from repro_torch.kernels import ops
    from repro_torch.models import efficientvit

    # B1 R224's results keep their names; another config's carry its own
    label = name if cfg.name == "efficientvit-b1-r224" \
        else f"{cfg.name}-{name}"
    m2q_calls, dw_calls, attn_calls = calls
    leaves_want, per_fwd = PATHS[name]
    n_calls = {"dense": len(m2q_calls), "dw": len(dw_calls),
               "attn": len(attn_calls)}
    want = {k: n_calls[v] if isinstance(v, str) else v
            for k, v in per_fwd.items()}

    t0 = time.perf_counter()
    params = efficientvit.init(cfg, seed=0, device="cuda")
    qm = recipe.quantize(cfg, params, path_recipe(name),
                         calib_batches=calib_batches)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    roles = ([(path, 0) for path, *_ in m2q_calls]
             + [(path, 1) for path, *_ in dw_calls] + [("stem/w", 2)])
    for path, role in roles:
        got = leaf_kind(_get(qm.params, path))
        if got != leaves_want[role]:
            fail(f"{label}: {path} is a {got} leaf, expected "
                 f"{leaves_want[role]}")
    for path, M, K, N in m2q_calls:
        leaf = _get(qm.params, path)
        rows = getattr(leaf, "payload", getattr(leaf, "codes", None))
        if rows.shape[0] != K:
            fail(f"{label}: {path} payload {tuple(rows.shape)}, K={K}")

    rng = np.random.default_rng(1)
    images = rng.normal(0, 1, (N_IMAGES, cfg.img_res, cfg.img_res, 3)
                        ).astype(np.float32)

    def check_launches(counts, forwards, what):
        for kname, c in counts.items():
            if c["launches"] != want.get(kname, 0) * forwards \
                    or c["plain_calls"] != 0:
                fail(f"{label} {what}: {kname} {c} over {forwards} forwards, "
                     f"expected {want.get(kname, 0) * forwards} launches "
                     "and 0 plain calls")

    # each mode serves the 12 images twice (the graph mode's first pass
    # captures its buckets) and classifies them once; every pass runs the
    # same batches (8, then 4), so every logit must equal the first pass's
    served, seconds, classify_s, pass_counts = {}, {}, {}, {}
    for graphs in (False, True):
        mode = "graph" if graphs else "eager"
        engine = qm.serve(max_batch=BATCH, max_delay_ms=50.0, graphs=graphs)
        for rep in ("warm", "timed"):
            b0 = engine.stats.batches
            kernels.reset_counts()
            t1 = time.perf_counter()
            handles = [engine.submit(img) for img in images]
            poll_until_done(engine, handles, label)
            torch.cuda.synchronize()
            seconds[mode, rep] = time.perf_counter() - t1
            counts = kernels.counts()
            # re-raises failures, a failed capture's included
            served[mode, rep] = np.stack([h.result() for h in handles])
            forwards = engine.stats.batches - b0
            if forwards != 2 or engine.stats.buckets_used != {8, 4}:
                fail(f"{label} {mode}: expected batches of 8 and 4, got "
                     f"{forwards} batches over buckets "
                     f"{sorted(engine.stats.buckets_used)}")
            check_launches(counts, forwards, f"{mode} {rep}")
            pass_counts[mode, rep] = counts
            if graphs and rep == "warm":
                capture_s = engine.step_graphs.capture_s
                if len(engine.step_graphs) != 2:
                    fail(f"{label}: {len(engine.step_graphs)} graphs "
                         "captured for buckets 8 and 4")
        kernels.reset_counts()
        t1 = time.perf_counter()
        served[mode, "classify"] = engine.classify(images)
        classify_s[mode] = time.perf_counter() - t1
        check_launches(kernels.counts(), 2, f"{mode} classify")
    logits = served["eager", "warm"]
    for key, got in served.items():
        if not np.array_equal(got, logits):
            fail(f"{label}: {key} logits differ from the eager engine's by "
                 f"{float(np.abs(got - logits).max())} on the same batches")
    if logits.shape != (N_IMAGES, cfg.n_classes) \
            or not np.all(np.isfinite(logits)):
        fail(f"{label}: logits shape {logits.shape} or non-finite values")

    # the artifact: save, load on the card, serve the same 12 images from
    # a new engine's CUDA graphs; logits and launches equal the original's
    loaded, artifact = round_trip(torch, qm, label)
    engine2 = loaded.serve(max_batch=BATCH, max_delay_ms=50.0, graphs=True)
    kernels.reset_counts()
    handles = [engine2.submit(img) for img in images]
    poll_until_done(engine2, handles, f"{label} loaded")
    if kernels.counts() != pass_counts["graph", "warm"]:
        fail(f"{label}: the loaded model's launches {kernels.counts()} "
             f"differ from the original's {pass_counts['graph', 'warm']}")
    got = np.stack([h.result() for h in handles])
    if not np.array_equal(got, served["graph", "warm"]):
        fail(f"{label}: the loaded model's graph-served logits differ from "
             f"the original's by "
             f"{float(np.abs(got - served['graph', 'warm']).max())}")
    del loaded, engine2

    with ops.reference_path():
        ref = np.concatenate([
            qm.forward(images[:BATCH]).float().cpu().numpy(),
            qm.forward(images[BATCH:]).float().cpu().numpy()])
    diff = float(np.abs(logits - ref).max())
    top = float(np.abs(ref).max())
    same_argmax = int((logits.argmax(-1) == ref.argmax(-1)).sum())
    # the integer paths' kernels repeat their plain versions' operations
    # exactly; the f32-dot ones (bf16 activations: one bf16 ulp is 2^-8
    # of a value) get a few ulps of the largest logit for a rounding slip
    # anywhere upstream
    if not diff <= (0.0 if name in EXACT_PATHS else 2e-2 * top):
        fail(f"{label}: served logits differ from the plain forward by "
             f"{diff} (max |logit| {top})")

    x8 = torch.from_numpy(images[:BATCH]).cuda()
    with torch.inference_mode():
        fwd_graph_ms = graph_ms(lambda: qm.forward(x8), iters=3)
    res = dict(cfg=cfg.name, path=name, quantize_s=t_quant,
               serve_12_images_s={m: seconds[m, "timed"]
                                  for m in ("eager", "graph")},
               images_per_s={m: N_IMAGES / seconds[m, "timed"]
                             for m in ("eager", "graph")},
               serve_12_images_first_pass_s={
                   m: seconds[m, "warm"] for m in ("eager", "graph")},
               graph_capture_s=capture_s,
               classify_12_images_s=classify_s,
               classify_images_per_s={m: N_IMAGES / t
                                      for m, t in classify_s.items()},
               forwards=forwards,
               launches_per_forward={k: c["launches"] // forwards
                                     for k, c in counts.items()
                                     if c["launches"]},
               logits_max_abs_diff=diff, logits_max_abs=top,
               logits_exact=bool(diff == 0.0), same_argmax=same_argmax,
               forward_b8_graph_ms=fwd_graph_ms, artifact=artifact,
               serve_stats=engine.stats.summary())
    if full:
        res["forward_b8_ms"] = cuda_ms(lambda: qm.forward(x8), iters=10)
        with ops.reference_path():
            res["plain_forward_b8_ms"] = cuda_ms(lambda: qm.forward(x8),
                                                 iters=3, warmup=1)
        trace = device_profile(lambda: qm.forward(x8))
        if trace:  # busy share of the unprofiled eager forward
            trace["busy_share"] = trace["busy_ms"] / res["forward_b8_ms"]
        res["forward_b8_trace"] = trace
    (out_dir / f"chip_smoke_path_{label}.json").write_text(
        json.dumps(res, indent=1))
    print(f"path {label}:", json.dumps(res), flush=True)
    del qm, params, engine
    torch.cuda.empty_cache()
    return counts


# the token paths: qwen1.5-0.5b at full width, int8 KV cache
TOKEN_BATCH = 8
TOKEN_MAX_LEN = 256
N_REQUESTS = 16
# one prefill group of the m2q_matmul checks: 8 prompts of 128 tokens
PREFILL_LEN = 128
# the stacked layer matmuls a calibrated mixed qwen runs per layer
LM_MIXED = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w2")
LM_FOLDED = ("mlp/w1", "mlp/w3")


def token_recipe(name: str):
    """``token``: m2q-w8a8 at the decode deployment shape (2 tokens a step
    from the calibration batch: every leaf 4-bit); ``token-m2q``: at 64
    tokens a step, the prefill side of the same server (the mixed LM)."""
    from repro_torch import recipe
    rec = recipe.PRESETS["m2q-w8a8"]
    return rec.replace(tokens_per_step=64) if name == "token-m2q" else rec


def token_m2q_calls(cfg, batch: int, prefill_len: int,
                    label: str = "token-m2q"):
    """m2q_matmul's calls (path, M, K, N) in one decode step and in one
    prefill group of ``prefill_len``-token prompts of a mixed LM (qwen;
    ``label`` names another, as minitron-4b's): the five stacked matmuls
    of every layer, then the lm_head (on the last position of each
    prompt)."""
    def layers(M):
        shapes = {"attn/wq": (cfg.d_model, cfg.q_dim),
                  "attn/wk": (cfg.d_model, cfg.kv_dim),
                  "attn/wv": (cfg.d_model, cfg.kv_dim),
                  "attn/wo": (cfg.q_dim, cfg.d_model),
                  "mlp/w2": (cfg.d_ff, cfg.d_model)}
        return [(f"layers/{p}@{i}", M, *shapes[p])
                for i in range(cfg.n_layers) for p in LM_MIXED]
    head = ("lm_head", batch, cfg.d_model, cfg.padded_vocab)
    return {f"{label} decode step": layers(batch) + [head],
            f"{label} prefill group": layers(batch * prefill_len) + [head]}


def token_requests(cfg):
    """16 seeded requests: prompts of 8-96 tokens, 24-40 new tokens, the
    last two at temperature 0.8."""
    import numpy as np
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(N_REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(8, 97)),
                              dtype=np.int32)
        reqs.append((prompt, int(rng.integers(24, 41)),
                     0.8 if i >= N_REQUESTS - 2 else 0.0))
    return reqs


def token_margins(logits, served) -> dict:
    """Where a served token (``served`` (steps, B)) is not the argmax of
    the teacher-forced ``logits`` (steps, B, vocab): the logits' top-2
    margin there and the served token's gap below the top."""
    import numpy as np
    from repro_torch.launch.daemon import token_gaps
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = token_gaps(logits, served)
    at = np.argwhere(served != logits.argmax(-1))
    rows = [{"step": int(t), "request": int(b),
             "top2_margin": float(top2[t, b, 1] - top2[t, b, 0]),
             "served_gap": float(gap[t, b])} for t, b in at]
    return {"positions": int(served.size), "mismatches": rows,
            "largest_top2_margin": max((r["top2_margin"] for r in rows),
                                       default=0.0),
            "largest_gap": max((r["served_gap"] for r in rows), default=0.0)}


def check_token_leaves(qm, name: str) -> None:
    """``token``: every quantized leaf a 4-bit QUniform (axis 0 embed, 1
    lm_head, 2 the stacked layers).  ``token-m2q``: wq, wk, wv, wo and w2
    QExpertM2Q leaves of L layers with (L, 1, 1) activation scales, w1
    and w3 perm-folded 3-D QM2Q leaves without one, a calibrated 2-D QM2Q
    lm_head and a 4-bit axis-0 QUniform embed."""
    from repro_torch.core.qtensor import QExpertM2Q, QM2Q, QUniform
    L = qm.cfg.n_layers
    if len(qm.report) != 9:
        fail(f"{name} path: {len(qm.report)} quantized leaves, expected 9")
    for r in qm.report:
        leaf = _get(qm.params, r.path)
        got = f"{type(leaf).__name__} payload " \
              f"{tuple(getattr(leaf, 'payload', leaf).shape)}"
        if name == "token" or r.path == "embed":
            want_axis = {"embed": 0, "lm_head": 1}.get(r.path, 2)
            ok = (isinstance(leaf, QUniform) and leaf.bits == 4
                  and leaf.axis == want_axis and leaf.act_scale is None
                  and (want_axis != 2 or leaf.payload.shape[0] == L))
            want = f"a 4-bit QUniform with axis {want_axis}"
        elif r.path == "lm_head":
            ok = (type(leaf) is QM2Q and leaf.payload.ndim == 2
                  and leaf.act_scale is not None)
            want = "a 2-D QM2Q with an activation scale"
        elif r.path.split("/", 1)[1] in LM_FOLDED:
            ok = (type(leaf) is QM2Q and leaf.payload.ndim == 3
                  and leaf.payload.shape[0] == L and leaf.act_scale is None
                  and r.decision == "mixed(perm-folded)")
            want = f"a perm-folded QM2Q of {L} layers, no activation scale"
        else:
            ok = (isinstance(leaf, QExpertM2Q) and leaf.payload.ndim == 3
                  and leaf.payload.shape[0] == L
                  and leaf.act_scale is not None
                  and tuple(leaf.act_scale.shape) == (L, 1, 1))
            want = f"a QExpertM2Q of {L} layers, (L, 1, 1) activation scale"
        if not ok:
            fail(f"{name} path: {r.path} is {got}, expected {want}")


def token_launches(cfg, name: str, steps: int, groups: int) -> dict:
    """The kernel launches of ``steps`` decode steps and ``groups``
    prefill groups: decode_attn_int8 once per layer and step; the lm_head
    on int4_matmul (``token``), or every stacked layer matmul and the
    lm_head on m2q_matmul (``token-m2q``), in each step and group."""
    want = {"decode_attn_int8": cfg.n_layers * steps}
    if name == "token":
        want["int4_matmul"] = steps + groups
    else:
        want["m2q_matmul"] = (len(LM_MIXED) * cfg.n_layers + 1) \
            * (steps + groups)
    return want


def plain_dequant_ms(torch, qm) -> dict:
    """Device ms one decode step spends dequantizing the stacked layer
    weights that no kernel takes (their ``x @ dequant(W)`` in bf16): per
    such leaf, its layer-0 slice's ``dequant(bfloat16)`` timed in a CUDA
    graph, times the layer count."""
    from repro_torch.core.qtensor import slice_layer
    from repro_torch.kernels import ops
    out = {}
    for r in qm.report:
        if not r.path.startswith("layers/"):
            continue
        layer = slice_layer(_get(qm.params, r.path), 0)
        if not ops.kernel_supported(layer):
            out[r.path] = qm.cfg.n_layers * graph_ms(
                lambda: layer.dequant(torch.bfloat16), iters=5)
    return out


def run_token_path(torch, out_dir, name: str):
    """Quantize qwen1.5-0.5b at full width (int8 KV cache) under the
    ``name`` recipe (:func:`token_recipe`) on the card, serve 16 requests
    through the token Engine eagerly and from its CUDA graphs, and check
    leaves, launch counters, token counts, graph-vs-eager tokens and
    teacher-forced logits against reference_path(); time the decode step
    and trace one."""
    import numpy as np
    from repro_torch import kernels, recipe
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.daemon import (TEACHER_FORCED_BOUND,
                                           teacher_forced_logits)
    from repro_torch.models import dense_lm

    cfg = ARCHS["qwen1.5-0.5b"].replace(kv_cache_dtype="int8")
    t0 = time.perf_counter()
    params = dense_lm.init(cfg, seed=0, device="cuda")
    qm = recipe.quantize(cfg, params, token_recipe(name))
    del params
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    check_token_leaves(qm, name)

    # each mode serves the 16 requests twice from seed 0 (the graph
    # mode's first pass captures its two decode steps); the second pass
    # draws on from the first's generator state, so every pass's tokens
    # must equal the eager engine's pass for pass
    reqs = token_requests(cfg)
    served, seconds, passes, pass_counts = {}, {}, {}, {}
    for graphs in (False, True):
        mode = "graph" if graphs else "eager"
        engine = qm.serve(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN,
                          seed=0, graphs=graphs)
        for rep in ("warm", "timed"):
            s0 = (engine.stats.steps, engine.stats.prefill_batches)
            kernels.reset_counts()
            t1 = time.perf_counter()
            handles = [engine.submit(p, max_new_tokens=n, temperature=t)
                       for p, n, t in reqs]
            engine.run()
            torch.cuda.synchronize()
            seconds[mode, rep] = time.perf_counter() - t1
            counts = kernels.counts()
            # re-raises failures, a failed capture's included
            outs = served[mode, rep] = [h.handle.result() for h in handles]
            steps = engine.stats.steps - s0[0]
            groups = engine.stats.prefill_batches - s0[1]
            passes[f"{mode} {rep}"] = {"decode_steps": steps,
                                       "prefill_groups": groups}
            pass_counts[f"{mode} {rep}"] = counts
            for (p, n, _), toks in zip(reqs, outs):
                if len(toks) != n \
                        or not all(0 <= t < cfg.vocab_size for t in toks):
                    fail(f"{name} path: a request asked for {n} tokens "
                         f"and got {len(toks)} (or ids outside the vocab)")
            want = token_launches(cfg, name, steps, groups)
            for kname, c in counts.items():
                if c["launches"] != want.get(kname, 0) \
                        or c["plain_calls"] != 0:
                    fail(f"{name} path {mode} {rep}: {kname} {c} over {steps}"
                         f" decode steps and {groups} prefill groups, "
                         f"expected {want.get(kname, 0)} launches and 0 "
                         "plain calls")
            if graphs and rep == "warm":
                capture_s = engine.step_graphs.capture_s
                if len(engine.step_graphs) != 2:
                    fail(f"{name} path: {len(engine.step_graphs)} decode "
                         "graphs captured, expected a greedy and a drawing "
                         "one")
    for rep in ("warm", "timed"):
        for i, (a, b) in enumerate(zip(served["eager", rep],
                                       served["graph", rep])):
            if a != b:
                fail(f"{name} path {rep}: request {i}'s graph-served tokens "
                     f"differ from the eager engine's: {b} vs {a}")
    outs = served["eager", "warm"]
    generated = sum(len(t) for t in outs)
    stats = engine.stats

    # where a graphed pass's time goes: one more pass with every prefill
    # group and decode step timed between synchronizes
    split = Counter()

    def timed(fn, key):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                torch.cuda.synchronize()
                split[key] += time.perf_counter() - t
        return call

    engine._prefill_group = timed(engine._prefill_group, "prefill_s")
    engine._decode = timed(engine._decode, "decode_s")
    t1 = time.perf_counter()
    for p, n, t in reqs:
        engine.submit(p, max_new_tokens=n, temperature=t)
    engine.run()
    torch.cuda.synchronize()
    split["pass_s"] = time.perf_counter() - t1
    del engine._prefill_group, engine._decode

    # the artifact (~0.3 GB of 4-bit payload; ~0.54 GB mixed): save, load,
    # serve the 16 requests from a new engine's decode-step graphs at
    # seed 0; tokens and launches equal the original's first graph pass
    loaded, artifact = round_trip(torch, qm, name)
    engine2 = loaded.serve(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN,
                           seed=0, graphs=True)
    kernels.reset_counts()
    handles = [engine2.submit(p, max_new_tokens=n, temperature=t)
               for p, n, t in reqs]
    engine2.run()
    if kernels.counts() != pass_counts["graph warm"]:
        fail(f"{name} path: the loaded model's launches {kernels.counts()} "
             f"differ from the original's {pass_counts['graph warm']}")
    for i, h in enumerate(handles):
        if h.handle.result() != served["graph", "warm"][i]:
            fail(f"{name} path: request {i}'s tokens from the loaded model "
                 "differ from the original's")
    del loaded, engine2

    # teacher-forced logits, kernels vs plain versions: two greedy
    # requests, their served tokens fed back
    pick = [0, 1]
    steps = min(reqs[i][1] for i in pick) - 1
    prompts = [reqs[i][0] for i in pick]
    forced = np.array([outs[i][:steps] for i in pick]).T
    got = teacher_forced_logits(cfg, qm.params, prompts, forced,
                                TOKEN_MAX_LEN)
    with ops.reference_path():
        ref = teacher_forced_logits(cfg, qm.params, prompts, forced,
                                    TOKEN_MAX_LEN)
    diff = float((got - ref).abs().max())
    top = float(ref.abs().max())
    same_argmax = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    served = np.array([outs[i][:steps + 1] for i in pick]).T  # (steps+1, B)
    served_match = float(np.mean(served == got.argmax(-1).cpu().numpy()))
    margins = token_margins(got.cpu().numpy(), served)
    # bf16 activations through 24 layers: a flipped p8 code in any
    # layer's attention, or the lm_head's f32 sums landing on the other
    # side of a bf16 rounding, moves every later value by a bf16 ulp;
    # 5e-2 of the largest logit is ~8 bf16 ulps of it (0.051-0.086 of a
    # 5.19 max |logit| measured on an H100 at 700 W); a served token may
    # sit below the teacher-forced argmax by no more than that bound
    bound = TEACHER_FORCED_BOUND * top
    if not diff <= bound:
        fail(f"{name} path: teacher-forced logits differ from the plain "
             f"versions' by {diff} (max |logit| {top})")
    within_bound = bool(margins["largest_gap"] <= bound)
    print(f"{name} path served-vs-teacher-forced mismatches:", json.dumps(dict(
        margins, bound=bound, within_bound=within_bound)), flush=True)
    if not within_bound:
        fail(f"{name} path: a served token sits {margins['largest_gap']} "
             f"below the teacher-forced argmax, over the bound {bound}")

    # the batch-8 decode step at the served run's cache lengths
    cache = {k: v.clone() for k, v in engine.cache.items()}
    cache["lengths"].copy_(torch.tensor(
        [min(len(p) + 30, TOKEN_MAX_LEN - 1) for p, _, _ in
         reqs[:TOKEN_BATCH]], dtype=torch.int32, device="cuda"))
    tok = torch.zeros((TOKEN_BATCH, 1), dtype=torch.int64, device="cuda")

    def step():
        return dense_lm.decode_step(cfg, qm.params, cache, tok)

    res = dict(path=f"qwen1.5-0.5b int8-kv m2q-w8a8, "
                    f"{qm.recipe.tokens_per_step} tokens/step",
               quantize_s=t_quant,
               serve_s={m: seconds[m, "timed"] for m in ("eager", "graph")},
               requests=len(reqs), tokens=generated,
               tokens_per_s={m: generated / seconds[m, "timed"]
                             for m in ("eager", "graph")},
               serve_first_pass_s={m: seconds[m, "warm"]
                                   for m in ("eager", "graph")},
               graph_capture_s=capture_s, graph_pass_split=split,
               passes=passes, artifact=artifact,
               decode_steps=passes["graph timed"]["decode_steps"],
               prefill_groups=passes["graph timed"]["prefill_groups"],
               launches={k: c["launches"] for k, c in counts.items()
                         if c["launches"]},
               teacher_forced_max_abs_diff=diff, logits_max_abs=top,
               teacher_forced_same_argmax=same_argmax,
               served_tokens_match_teacher_forced_argmax=served_match,
               mismatch_margins=margins,
               serve_stats=stats.summary(),
               decode_lengths=cache["lengths"].tolist())
    with torch.no_grad():
        res["decode_step_ms"] = cuda_ms(step, iters=10)
        with ops.reference_path():
            res["plain_decode_step_ms"] = cuda_ms(step, iters=3, warmup=1)
        try:
            res["decode_step_graph_ms"] = graph_ms(step, iters=3)
        except Exception as e:  # noqa: BLE001 -- a failed phase fails the run
            fail(f"{name} path: the decode step did not run in a CUDA graph: "
                 f"{e!r}"[:400])
        trace = device_profile(step, top=8)
        res["plain_dequant_ms_per_step"] = plain_dequant_ms(torch, qm)
    if trace:
        trace["busy_share"] = trace["busy_ms"] / res["decode_step_ms"]
    res["decode_step_trace"] = trace
    (out_dir / f"chip_smoke_path_{name}.json").write_text(
        json.dumps(res, indent=1))
    print(f"path {name}:", json.dumps(res), flush=True)
    del qm, engine, cache
    torch.cuda.empty_cache()
    return counts


def payload_diff(torch, a, b) -> dict:
    """Where two quantized trees of one model differ: payload / code
    bytes, Eq. 6 splits, and the largest relative difference of each
    kind of scale."""
    import dataclasses
    from repro_torch.core.qtensor import is_qtensor
    from repro_torch.core.tree import leaves_with_path
    lb = dict(leaves_with_path(b))
    out = {"payload_bytes": 0, "payload_bytes_differing": 0,
           "leaves_differing": [], "splits_differing": [],
           "max_rel_diff": {}}
    for key, x in leaves_with_path(a):
        y = lb[key]
        if not is_qtensor(x):
            continue
        if getattr(x, "n_apot", None) != getattr(y, "n_apot", None):
            out["splits_differing"].append(key)
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if not isinstance(u, torch.Tensor) or v is None:
                continue
            if f.name in ("payload", "codes"):
                n = int((u.view(torch.uint8) != v.view(torch.uint8)).sum())
                out["payload_bytes"] += u.numel()
                out["payload_bytes_differing"] += n
                if n:
                    out["leaves_differing"].append(key)
            else:
                rel = float(((u - v).abs() / u.abs().clamp(min=1e-30))
                            .max())
                out["max_rel_diff"][f.name] = max(
                    rel, out["max_rel_diff"].get(f.name, 0.0))
    return out


def run_proxy(torch, out_dir):
    """The trained proxy (the reduced B1 trained by the JAX package): load
    its committed JAX-written m2q-w8a8 artifact on the card and classify
    the 256 images of ``expected.json`` through the kernels with int8
    attention (counters zeroed before, read after) and with f32
    attention.  Both are held against the same forward under
    ``reference_path()`` (exactly), and the f32-attention logits against
    the JAX package's (:func:`proxy_vs_jax`).  Reports top-1 beside
    JAX's, the float proxy's top-1, and the port's own quantization of the
    float proxy on the card (same four calibration batches): its top-1 and
    how its payloads differ from JAX's."""
    import numpy as np
    from repro_torch import kernels, recipe
    from repro_torch.data import proxy
    from repro_torch.kernels import ops

    expected = json.loads((proxy.ARTIFACT / "expected.json").read_text())
    labels = np.array(expected["labels"])
    jax_preds = np.array(expected["quantized"]["predictions"])
    jax_logits = np.array(expected["quantized"]["logits"], np.float32)
    t0 = time.perf_counter()
    qm = recipe.QuantizedModel.load(proxy.ARTIFACT, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def run(params, attn):
        out, y = proxy.logits(params, attn=attn)
        if not np.array_equal(y, labels):
            fail("proxy: the images' labels differ from expected.json's")
        if out.shape != (len(labels), proxy.CFG.n_classes) \
                or not np.all(np.isfinite(out)):
            fail(f"proxy {attn}: logits shape {out.shape} or non-finite "
                 "values")
        return out, out.argmax(-1), float(np.mean(out.argmax(-1) == labels))

    kernels.reset_counts()
    logits_int8, preds_int8, acc_int8 = run(qm.params, "int8")
    counts = kernels.counts()
    launched = {k: c["launches"] for k, c in counts.items() if c["launches"]}
    print("proxy forward launches (8 batches of 32, int8 attention):",
          json.dumps(launched), flush=True)
    want = ("m2q_matmul", "dwconv_w4", "relu_attn", "relu_attn_scales")
    if any(c["plain_calls"] for c in counts.values()) \
            or sorted(launched) != sorted(want):
        fail(f"proxy: launches {counts}, expected kernels {want} only and "
             "no plain calls")
    logits_f32, preds_f32, acc_f32 = run(qm.params, "f32")

    # the kernels at the reduced shapes against their plain versions: all
    # four are bit-exact with them and the activations are f32, so exact
    vs_plain = {}
    with ops.reference_path():
        for attn, got in (("int8", logits_int8), ("f32", logits_f32)):
            ref, _, _ = run(qm.params, attn)
            diff = float(np.abs(got - ref).max())
            vs_plain[attn] = dict(logits_max_abs_diff=diff,
                                  logits_max_abs=float(np.abs(ref).max()))
            if diff != 0.0:
                fail(f"proxy {attn}: kernel logits differ from the plain "
                     f"forward by {diff}")

    # the f32-attention forward against the JAX package's
    if not np.array_equal(jax_logits.argmax(-1), jax_preds):
        fail("proxy: expected.json's logits and predictions disagree")
    vs_jax, failures = proxy_vs_jax(logits_f32, jax_logits)
    if failures:
        fail("proxy: f32 attention: " + "; ".join(failures))

    float_params = proxy.load_proxy("cuda")
    float_logits, float_preds, acc_float = run(float_params, "f32")
    t0 = time.perf_counter()
    port = recipe.quantize(proxy.CFG, float_params, "m2q-w8a8",
                           calib_batches=proxy.calib_batches(), attn="f32")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    _, _, port_acc_int8 = run(port.params, "int8")
    _, port_f32, port_acc_f32 = run(port.params, "f32")
    res = dict(
        cfg=proxy.CFG.name, images=len(labels), artifact_load_s=load_s,
        jax=dict(float_top1=expected["float"]["accuracy"],
                 m2q_top1=expected["quantized"]["accuracy"]),
        float_top1=acc_float,
        float_predictions_differing=int(
            (float_preds != np.array(expected["float"]["predictions"]))
            .sum()),
        float_logits_max_abs_diff_vs_jax=float(np.abs(
            float_logits - np.array(expected["float"]["logits"],
                                    np.float32)).max()),
        jax_artifact=dict(top1_int8_attn=acc_int8, top1_f32_attn=acc_f32,
                          vs_plain=vs_plain, f32_vs_jax=vs_jax,
                          bounds=dict(float=PROXY_FLOAT,
                                      images_off=PROXY_IMAGES_OFF,
                                      logits=PROXY_LOGITS,
                                      predictions=PROXY_MISMATCHES),
                          int8_predictions_differing=int(
                              (preds_int8 != jax_preds).sum())),
        port_quantized=dict(quantize_s=quant_s, top1_int8_attn=port_acc_int8,
                            top1_f32_attn=port_acc_f32,
                            f32_predictions_differing=int(
                                (port_f32 != jax_preds).sum()),
                            vs_jax_artifact=payload_diff(
                                torch, qm.params, port.params)),
        launches=launched)
    (out_dir / "chip_smoke_proxy.json").write_text(json.dumps(res, indent=1))
    print("proxy:", json.dumps(res), flush=True)
    del qm, port, float_params
    torch.cuda.empty_cache()
    return counts


# ---- phase 8: the serving runtime -----------------------------------------
# (b)'s fault spec: the second prefill group raises, and the fifth decode
# step NaN-poisons one live slot's cache rows
RUNTIME_SPEC = "raise@prefill:2,nan@decode:5"
RUNTIME_BATCH = 8


def runtime_requests(cfg):
    """(b)'s requests: 8 batch-class ones (preemptible, 16 new tokens; the
    first two streamed, the last at temperature 0.8), then 2 interactive
    ones (8 new tokens)."""
    import numpy as np
    from repro_torch.serving.slo import BATCH, INTERACTIVE
    rng = np.random.default_rng(4)

    def prompt(lo, hi):
        return rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi)),
                            dtype=np.int32)
    batch = [dict(prompt=prompt(8, 33), max_new_tokens=16,
                  temperature=0.8 if i == 7 else 0.0,
                  priority=BATCH.priority, preemptible=True, stream=i < 2)
             for i in range(8)]
    inter = [dict(prompt=prompt(4, 17), max_new_tokens=8,
                  priority=INTERACTIVE.priority, stream=False)
             for _ in range(2)]
    return batch, inter


def drive_runtime_script(engine) -> dict:
    """(b)'s manual drive of a token engine with ``max_batch`` 8 built with
    ``faults=RUNTIME_SPEC``: the batch requests fill the slots in one
    prefill group and decode 3 steps; both interactive requests arrive, so
    the next step evicts one batch slot (the first of equals: a streamer),
    the first interactive request's group raises (prefill 2), the second
    takes the slot, and decode step 5 poisons slot 0.  Returns what two
    runs must agree on, with the kernels' counts over the drive."""
    from repro_torch import kernels
    batch, inter = runtime_requests(engine.cfg)
    kernels.reset_counts()
    s0 = engine.stats.steps, engine.stats.prefill_batches
    reqs, streams = [], {}

    def submit(kw):
        kw = dict(kw)
        seen = [] if kw.pop("stream") else None
        r = engine.submit(**kw, on_token=None if seen is None
                          else seen.append)
        if seen is not None:
            streams[r.uid] = seen
        reqs.append(r)

    for kw in batch:
        submit(kw)
    for _ in range(3):
        engine.step()
    before = {uid: list(s) for uid, s in streams.items()}
    for kw in inter:
        submit(kw)
    engine.run()
    s = engine.stats
    return dict(
        outcomes=[(r.uid, r.handle.state,
                   type(r.handle.exception()).__name__
                   if r.handle.exception() is not None else None)
                  for r in reqs],
        tokens={r.uid: r.handle.result() for r in reqs
                if r.handle.state == "DONE"},
        streams=streams, before=before,
        preemptions={r.uid: r.preemptions for r in reqs},
        steps=s.steps - s0[0], groups=s.prefill_batches - s0[1],
        counts=kernels.counts(),
        stats=dict(s.summary(), preemptions=s.preemptions,
                   streamed_tokens=s.streamed_tokens, resolved=s.resolved))


def runtime_script_problems(cfg, runs: dict, device: str) -> list:
    """What is wrong with (b)'s runs (mode -> drive_runtime_script()):
    per run, exactly one NumericalError, a failed prefill group of
    InjectedFault, at least one preemption with its pre-eviction stream
    kept, every DONE stream equal to its result, every submit resolved,
    decode_attn_int8 once per layer and step and no call of the other
    route (``launches`` on CUDA, ``plain_calls`` on the CPU); across
    runs, equal outcomes, DONE tokens and preemptions."""
    out = []
    field, other = (("launches", "plain_calls") if device == "cuda"
                    else ("plain_calls", "launches"))
    for mode, r in runs.items():
        kinds = Counter(e for _, _, e in r["outcomes"])
        if kinds["NumericalError"] != 1 or not kinds["InjectedFault"]:
            out.append(f"{mode}: failures {dict(kinds)}, expected one "
                       "NumericalError and a group of InjectedFault")
        if sum(r["preemptions"].values()) < 1 \
                or r["stats"]["preemptions"] != sum(
                    r["preemptions"].values()):
            out.append(f"{mode}: preemptions {r['preemptions']}, stats "
                       f"{r['stats']['preemptions']}")
        for uid, n in r["preemptions"].items():
            toks = r["tokens"].get(uid)
            if n and uid in r["before"] and (
                    toks is None or toks[:len(r["before"][uid])]
                    != r["before"][uid]):
                out.append(f"{mode}: preempted request {uid} lost its "
                           "pre-eviction tokens")
        for uid, seen in r["streams"].items():
            if uid in r["tokens"] and seen != r["tokens"][uid]:
                out.append(f"{mode}: request {uid} streamed {seen}, "
                           f"result {r['tokens'][uid]}")
        if r["stats"]["submitted"] != r["stats"]["resolved"]:
            out.append(f"{mode}: submitted {r['stats']['submitted']} != "
                       f"resolved {r['stats']['resolved']}")
        c = r["counts"]
        if c["decode_attn_int8"][field] != cfg.n_layers * r["steps"] \
                or any(v[other] for v in c.values()):
            out.append(f"{mode}: counts {c} over {r['steps']} steps")
    first = next(iter(runs.values()))
    for mode, r in list(runs.items())[1:]:
        for key in ("outcomes", "tokens", "preemptions"):
            if r[key] != first[key]:
                out.append(f"{mode}: {key} differ from the first run's")
    return out


def _printed(fn, *args):
    """(fn's return value, or its SystemExit code; its standard output),
    the output echoed as well."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            ret = fn(*args)
    except SystemExit as e:
        ret = e.code
    finally:
        print(buf.getvalue(), end="", flush=True)
    return ret, buf.getvalue()


def _line(pattern, text, what):
    import re
    m = re.search(pattern, text)
    if m is None:
        fail(f"no {what} line in {text[-400:]!r}")
    return m


def _check_counts(counts, want, what):
    for kname, c in counts.items():
        if c["launches"] != want.get(kname, 0) or c["plain_calls"]:
            fail(f"phase 8 {what}: {kname} {c}, expected "
                 f"{want.get(kname, 0)} launches and 0 plain calls")


def run_runtime(torch, out_dir, card):
    """Phase 8, the serving runtime: (a) ``launch.serve.main`` at full
    width, (b) a scripted fault / preemption / streaming drive of the
    token engine from phase 6's artifact, graphed and eager, (c) token
    traffic through a ``ServingDaemon`` by ``launch.daemon.serve_traffic``,
    (d) vision traffic through a daemon over phase 4's artifact.  Returns
    the kernels' counts of the four parts."""
    import argparse
    import gc
    import threading
    import numpy as np
    from repro_torch import kernels, recipe
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import daemon as launch_daemon
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving.daemon import ServingDaemon
    from repro_torch.serving.faults import FaultInjector

    total = Counter()

    def add(counts):
        total.update({k: c["launches"] for k, c in counts.items()})

    # (a) the serve CLI, in-process, at full width over the int8 cache
    kernels.reset_counts()
    t0 = time.perf_counter()
    _, text = _printed(launch_serve.main, [
        "--arch", "qwen1.5-0.5b", "--max-batch", str(RUNTIME_BATCH),
        "--max-len", str(TOKEN_MAX_LEN), "--requests", "8",
        "--max-new", "16", "--kv-cache-dtype", "int8"])
    serve_s = time.perf_counter() - t0
    counts = kernels.counts()
    add(counts)
    m = _line(r"requests=(\d+) decoded=(\d+) steps=(\d+) tok/s=([\d.]+)",
              text, "phase 8 requests=")
    flushes = _line(r"flushes=(\{.*\})", text, "phase 8 flushes=")
    groups = sum(json.loads(flushes[1].replace("'", '"')).values())
    steps = int(m[3])
    if (int(m[1]), int(m[2])) != (8, 8 * 15) or not float(m[4]) > 0:
        fail(f"phase 8 (a): the serve CLI printed {m[0]!r}, expected 8 "
             "requests and 120 decoded tokens")
    _check_counts(counts, token_launches(ARCHS["qwen1.5-0.5b"], "token",
                                         steps, groups),
                  f"(a) over {steps} steps and {groups} groups")
    res = dict(serve_cli=dict(line=m[0], steps=steps, prefill_groups=groups,
                              tokens_per_s=float(m[4]), wall_s=serve_s,
                              launches={k: c["launches"]
                                        for k, c in counts.items()
                                        if c["launches"]}))
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the scripted drive, graphed and eager, on phase 6's artifact
    tok = recipe.QuantizedModel.load(ARTIFACTS / "token", device="cuda")
    runs = {}
    for graphs in (True, False):
        mode = "graph" if graphs else "eager"
        eng = tok.serve(max_batch=RUNTIME_BATCH, max_len=TOKEN_MAX_LEN,
                        seed=0, graphs=graphs, debug_numerics=True,
                        faults=FaultInjector.parse(RUNTIME_SPEC))
        runs[mode] = drive_runtime_script(eng)
        add(runs[mode]["counts"])
        if graphs and len(eng.step_graphs) != 2:
            fail(f"phase 8 (b): {len(eng.step_graphs)} decode graphs, "
                 "expected a greedy and a drawing one")
        _check_counts(runs[mode]["counts"], token_launches(
            tok.cfg, "token", runs[mode]["steps"], runs[mode]["groups"]),
            f"(b) {mode}")
        del eng
    problems = runtime_script_problems(tok.cfg, runs, "cuda")
    if problems:
        fail("phase 8 (b): " + "; ".join(problems)[:1500])
    # the decode step with the cache scan off and on, in CUDA graphs
    step_ms = {"scan_off": [], "scan_on": []}
    for scan in (False, True, True, False):
        eng = tok.serve(max_batch=RUNTIME_BATCH, max_len=TOKEN_MAX_LEN,
                        graphs=False, debug_numerics=scan)
        eng.cache["lengths"].fill_(96)
        eng._live.fill_(True)
        with torch.no_grad():
            step_ms["scan_on" if scan else "scan_off"].append(
                graph_ms(lambda: eng._decode_step(False), iters=3))
        del eng
    res["script"] = dict(
        spec=RUNTIME_SPEC, outcomes=runs["graph"]["outcomes"],
        preemptions=runs["graph"]["preemptions"],
        steps=runs["graph"]["steps"], groups=runs["graph"]["groups"],
        stats={m: r["stats"] for m, r in runs.items()},
        decode_step_graph_ms=step_ms)
    print("phase 8 (b):", json.dumps(res["script"]), flush=True)

    # (c) token traffic through the daemon: submits from a foreign thread,
    # the first interactive request streamed; this thread leaves the card
    # alone until the daemon has stopped (its graphs are captured on the
    # daemon's thread)
    eng = tok.serve(max_batch=RUNTIME_BATCH, max_len=TOKEN_MAX_LEN, seed=0)
    gc.collect()
    torch.cuda.synchronize()
    kernels.reset_counts()
    args = argparse.Namespace(requests=16, max_new=16, timeout=300.0,
                              stream=False)
    daemon = ServingDaemon(eng).start()
    t0 = time.perf_counter()
    try:
        ok, text = _printed(launch_daemon.serve_traffic, daemon, args)
    finally:
        daemon.shutdown(drain=False, timeout=60.0)
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    add(counts)
    if ok is not True or daemon.running or daemon._thread.is_alive() \
            or daemon.crashed is not None:
        fail(f"phase 8 (c): serve_traffic returned {ok}, daemon running "
             f"{daemon.running}, crashed {daemon.crashed!r}")
    s = eng.stats
    _check_counts(counts, token_launches(tok.cfg, "token", s.steps,
                                         s.prefill_batches),
                  f"(c) over {s.steps} steps")
    stream = _line(r"stream ttft=([\d.]+)ms tokens=(\d+) gap "
                   r"p50=([\d.]+)ms max=([\d.]+)ms gaps_ms=(\[.*\])",
                   text, "phase 8 stream")
    generated = s.decoded_tokens + s.prefills
    res["token_daemon"] = dict(
        requests=s.submitted, tokens=generated, wall_s=wall,
        tokens_per_s=generated / wall, ttft_ms=float(stream[1]),
        gap_p50_ms=float(stream[3]), gap_max_ms=float(stream[4]),
        gaps_ms=json.loads(stream[5]),
        steps=s.steps, prefill_groups=s.prefill_batches,
        preemptions=s.preemptions, graph_capture_s=eng.step_graphs.capture_s,
        classes=daemon.stats_summary()["classes"], card=card)
    print("phase 8 (c):", json.dumps(res["token_daemon"]), flush=True)
    del eng, daemon, tok
    gc.collect()
    torch.cuda.empty_cache()

    # (d) vision traffic through the daemon over phase 4's artifact
    vis = recipe.QuantizedModel.load(ARTIFACTS / "m2q-w8a8", device="cuda")
    eng = vis.serve(max_batch=BATCH)
    rng = np.random.default_rng(6)
    images = rng.normal(0, 1, (N_IMAGES, vis.cfg.img_res, vis.cfg.img_res,
                               3)).astype(np.float32)
    gc.collect()
    torch.cuda.synchronize()
    kernels.reset_counts()
    handles = []
    daemon = ServingDaemon(eng).start()
    t0 = time.perf_counter()
    try:
        th = threading.Thread(target=lambda: handles.extend(
            daemon.submit(img, slo="interactive" if i % 3 == 0 else "batch")
            for i, img in enumerate(images)))
        th.start()
        th.join(300.0)
        for h in handles:
            h.result(timeout=300.0)
        daemon.shutdown(drain=True, timeout=300.0)
    finally:
        daemon.shutdown(drain=False, timeout=60.0)
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    add(counts)
    s = eng.stats
    if len(handles) != N_IMAGES or any(h.state != "DONE" for h in handles) \
            or s.submitted != s.resolved or daemon._thread.is_alive():
        fail(f"phase 8 (d): {len(handles)} handles, states "
             f"{Counter(h.state for h in handles)}, submitted {s.submitted}"
             f", resolved {s.resolved}")
    per_fwd = {"m2q_matmul": 42, "dwconv_w4": 20, "relu_attn": 14,
               "relu_attn_scales": 14}
    _check_counts(counts, {k: n * s.batches for k, n in per_fwd.items()},
                  f"(d) over {s.batches} forwards")
    res["vision_daemon"] = dict(
        images=N_IMAGES, wall_s=wall, images_per_s=N_IMAGES / wall,
        forwards=s.batches, buckets=sorted(s.buckets_used),
        graph_capture_s=eng.step_graphs.capture_s,
        classes=daemon.stats_summary()["classes"], card=card)
    print("phase 8 (d):", json.dumps(res["vision_daemon"]), flush=True)
    (out_dir / "chip_smoke_runtime.json").write_text(
        json.dumps(res, indent=1))
    del eng, daemon, vis
    torch.cuda.empty_cache()
    return total


# ---- phase 9: supervised serving -------------------------------------------
# the top-level keys of Supervisor.health() over a daemon without a
# journal: the JAX package's (tests/test_torch_supervisor.py holds this set
# against it); the port's trip_latches value is {"axes": trip_counts()}
HEALTH_KEYS = frozenset({
    "state", "ready", "restarts", "last_recovery_s", "replayed",
    "supervised_outstanding", "unix_time", "trip_latches", "stats",
    "daemon_state", "queue_depth", "daemon_outstanding", "heartbeat_age_s",
    "step_in_flight_s", "crashed"})
SUP_MAX_NEW = 16
SUP_WAIT = 300.0  # seconds: every wait of phase 9 is bounded
# the circuit case's budget: restarts 1-3 rebuild, the 4th opens it
SUP_CIRCUIT_RESTARTS = 3


def supervised_requests(cfg, n: int = 8):
    """Phase 9's prompts: ``n`` of 8-40 tokens, seeded."""
    import numpy as np
    rng = np.random.default_rng(9)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 41)),
                         dtype=np.int32) for _ in range(n)]


def timed_injector(spec: str):
    """A FaultInjector for ``spec`` that also records the wall-clock time
    of each call it fires on (``fired_unix``): where detection starts."""
    from repro_torch.serving.faults import FaultInjector
    inj = FaultInjector.parse(spec)
    inj.fired_unix = []
    on_call = inj.on_call

    def timed(site):
        act = on_call(site)
        if act is not None:
            inj.fired_unix.append(time.time())
        return act

    inj.on_call = timed
    return inj


class Builds:
    """A supervisor's engine factory over one quantized model: each build
    is ``qm.serve(**serve_kw)`` warmed by ``warm`` (fault-free; on the
    card this captures its graphs), and only then armed with ``arm`` --
    the first build, or every one with ``arm_every``.  Keeps per-build
    figures (``rows``): never the engines, each of which holds a KV cache
    and a graph pool on the card.  ``mem_in`` / ``mem_out``: allocated
    bytes on entry and after the build, each after a collection but for
    a rebuild's entry, read as the supervisor leaves the card: a restart
    must already have freed the torn-down engine.  ``groups``: a token
    engine's served prefill groups
    (:class:`~repro_torch.launch.daemon.PrefillGroups`), warm-ups
    excluded."""

    def __init__(self, qm, serve_kw, warm, arm=None, arm_every=False):
        from repro_torch.core.tree import device_of
        from repro_torch.launch.daemon import PrefillGroups
        self.qm, self.serve_kw, self.warm = qm, serve_kw, warm
        self.arm, self.arm_every = arm, arm_every
        self.cuda = device_of(qm.params).type == "cuda"
        self.rows = []
        self.groups = PrefillGroups()

    def _allocated(self, collect=True):
        import gc
        import torch
        if not self.cuda:
            return None
        if collect:
            gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def __call__(self):
        row = {"entered_unix": time.time(),
               "mem_in": self._allocated(collect=not self.rows)}
        t0 = time.perf_counter()
        eng = self.qm.serve(**self.serve_kw)
        self.warm(eng)
        if hasattr(eng, "_prefill_group"):
            self.groups.watch(eng)
        row["mem_out"] = self._allocated()
        row["build_s"] = time.perf_counter() - t0
        graphs = eng.step_graphs
        row["graphs"] = 0 if graphs is None else len(graphs)
        row["capture_s"] = 0.0 if graphs is None else graphs.capture_s
        row["stats"] = eng.stats
        if self.arm is not None and (self.arm_every or not self.rows):
            eng.faults = row["injector"] = timed_injector(self.arm)
        self.rows.append(row)
        return eng


def _outcomes(handles, timeout=SUP_WAIT):
    """Per client handle: (state, tokens or None, error class name)."""
    out = []
    for h in handles:
        try:
            res = h.result(timeout=timeout)
            out.append((h.state, [int(t) for t in res], None))
        except BaseException as e:  # noqa: BLE001 -- recorded, judged later
            out.append((h.state, None, type(e).__name__))
    return out


def restart_figures(sup, builds) -> list:
    """Per restart: detection (fault -> watchdog), teardown (-> the old
    serve thread gone), backoff, factory (engine + warm-up + captures),
    recovery (detection -> new daemon serving) seconds, and the allocated
    bytes before and after the new build."""
    rows = []
    for k, e in enumerate(sup.restart_log):
        inj = builds.rows[min(k, len(builds.rows) - 1)].get("injector")
        new = builds.rows[k + 1] if k + 1 < len(builds.rows) else {}
        rows.append(dict(
            restart=e["restart"], reason=e["reason"],
            detection_s=(e["detected_unix"] - inj.fired_unix[0]
                         if inj is not None and inj.fired_unix else None),
            teardown_s=e["teardown_s"],
            serve_thread_exited=e["serve_thread_exited"],
            backoff_s=e.get("backoff_s"), factory_s=e.get("factory_s"),
            recovery_s=e.get("recovery_s"),
            capture_s=new.get("capture_s"), graphs=new.get("graphs"),
            mem_after_teardown=new.get("mem_in"),
            mem_after_restart=new.get("mem_out")))
    return rows


def expected_launches(cfg, stats) -> Counter:
    """The token engines' launches over ``stats`` (each engine's): the
    ``token`` path's routing (:func:`token_launches`)."""
    want = Counter()
    for s in stats:
        want.update(token_launches(cfg, "token", s.steps, s.prefill_batches))
    return want


def launch_problems(counts, want, what, field) -> list:
    """``counts`` against ``want`` in ``field`` (``launches`` on the card,
    ``plain_calls`` on the CPU), and nothing in the other field."""
    other = "plain_calls" if field == "launches" else "launches"
    return [f"{what}: {k} {c}, expected {want.get(k, 0)} {field}"
            for k, c in counts.items()
            if c[field] != want.get(k, 0) or c[other]]


def die_like_a_process(sup) -> bool:
    """Stop ``sup`` as a killed process stops: its watchdog and serve
    thread halt, nothing is cancelled, no terminal is journaled for what
    was in flight, and the journal file is closed.  Returns whether the
    serve thread exited."""
    sup._stop_evt.set()
    sup._watchdog.join(SUP_WAIT)
    daemon = sup._daemon
    daemon.abort()
    exited = daemon.join(SUP_WAIT)
    sup.journal.close()
    return exited


def supervised_cases(qm, serve_kw, workdir, hang_s: float = 2.0):
    """Phase 9 (b): supervisors over engines of the token model ``qm``
    (``serve_kw``: its ``serve`` arguments), each build warmed and
    captured in the factory before it is armed.  Five cases: crash@decode
    (one restart), hang@decode detected after ``hang_s`` (one
    HungStepError restart; the new engine built after the old thread
    left), a streamed request across a crash (streamed == result), every
    build armed until the circuit opens, and a second supervisor
    cold-starting from the journal of a first stopped like a dead
    process.  Replayed tokens are held against one fault-free reference
    run (exact, or within the teacher-forced bound where a replay's
    prefill group differed from the reference's).  Returns (results,
    problems); ``results["counts"]`` the kernel counts of every served
    run."""
    from repro_torch import kernels
    from repro_torch.core.tree import device_of
    from repro_torch.launch.daemon import PrefillGroups, replay_agreement
    from repro_torch.serving.journal import RequestJournal
    from repro_torch.serving.supervisor import RestartPolicy, Supervisor
    cfg = qm.cfg
    max_len = serve_kw["max_len"]
    prompts = supervised_requests(cfg)
    cuda = device_of(qm.params).type == "cuda"
    field = "launches" if cuda else "plain_calls"
    problems, cases, total = [], {}, Counter()

    def warm(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=SUP_MAX_NEW)
        eng.run()

    kernels.reset_counts()
    ref_groups = PrefillGroups()
    ref = ref_groups.watch(qm.serve(**serve_kw))
    ref_reqs = [ref.submit(p, max_new_tokens=SUP_MAX_NEW) for p in prompts]
    ref.run()
    expected = [[int(t) for t in r.handle.result()] for r in ref_reqs]
    problems += launch_problems(kernels.counts(), expected_launches(
        cfg, [ref.stats]), "reference", field)
    total.update({k: c[field] for k, c in kernels.counts().items()})
    del ref, ref_reqs

    def policy(**kw):
        return RestartPolicy(**dict(dict(hang_threshold_s=10.0,
                                         backoff_base_s=0.05,
                                         poll_interval_s=0.02), **kw))

    def finish(name, sup, builds, outs, want_idx, extra_stats=()):
        """Counts, goodput, replay agreement and restart figures of one
        case, after its supervisor stopped."""
        counts = kernels.counts()
        total.update({k: c[field] for k, c in counts.items()})
        problems.extend(launch_problems(counts, expected_launches(
            cfg, [r["stats"] for r in builds.rows] + list(extra_stats)),
            name, field))
        done = [o for o in outs if o[0] == "DONE"]
        agree = replay_agreement(
            cfg, qm.params, [prompts[i] for i in want_idx],
            [o[1] for o in outs], [expected[i] for i in want_idx], max_len,
            builds.groups, ref_groups) if len(done) == len(outs) else None
        if agree is not None and agree["off"]:
            problems.append(f"{name}: replayed tokens off the reference "
                            f"beyond the bound: {agree['rows']}")
        cases[name] = dict(
            restarts=sup.restarts, replayed=sup.replayed,
            goodput=len(done) / len(outs), agreement=agree,
            outcomes=[o[0] if o[2] is None else o[2] for o in outs],
            log=sup.restart_log, figures=restart_figures(sup, builds),
            builds=[{k: v for k, v in r.items()
                     if k not in ("stats", "injector")}
                    for r in builds.rows])
        return cases[name]

    def journal_exact(path, name):
        with RequestJournal(path) as j:
            rec = j.reconcile()
        if not rec["exact"] or rec["pending"]:
            problems.append(f"{name}: journal {rec}")
        return rec

    # (1) crash@decode -> one restart
    builds = Builds(qm, serve_kw, warm, arm="crash@decode:4")
    jpath = workdir / "crash.jsonl"
    kernels.reset_counts()
    sup = Supervisor(builds, journal=RequestJournal(jpath),
                     policy=policy()).start()
    hs = [sup.submit(p, request_id=f"crash-{i}", max_new_tokens=SUP_MAX_NEW)
          for i, p in enumerate(prompts)]
    outs = _outcomes(hs)
    sup.shutdown()
    c = finish("crash", sup, builds, outs, range(len(prompts)))
    c["journal"] = journal_exact(jpath, "crash")

    # (2) hang@decode -> a HungStepError restart; the factory's captures
    # come after the old serve thread left
    builds = Builds(qm, serve_kw, warm, arm="hang@decode:4")
    kernels.reset_counts()
    sup = Supervisor(builds, policy=policy(hang_threshold_s=hang_s,
                                           poll_interval_s=0.05)).start()
    hs = [sup.submit(p, max_new_tokens=SUP_MAX_NEW) for p in prompts]
    outs = _outcomes(hs)
    sup.shutdown()
    c = finish("hang", sup, builds, outs, range(len(prompts)))
    if c["log"] and len(builds.rows) > 1:
        e = c["log"][0]
        c["built_after_teardown"] = bool(
            builds.rows[1]["entered_unix"] >= e["detected_unix"]
            + e["teardown_s"])
        if not (e["serve_thread_exited"] and c["built_after_teardown"]
                and (builds.rows[1]["graphs"] or not cuda)):
            problems.append(f"hang: teardown {e}, rebuild "
                            f"{c['builds'][1]}")

    # (3) a streamed request across a restart
    builds = Builds(qm, serve_kw, warm, arm="crash@decode:6")
    kernels.reset_counts()
    sup = Supervisor(builds, policy=policy()).start()
    streamed = []
    hs = [sup.submit(prompts[0], max_new_tokens=SUP_MAX_NEW,
                     on_token=streamed.append)]
    hs += [sup.submit(p, max_new_tokens=SUP_MAX_NEW) for p in prompts[1:4]]
    outs = _outcomes(hs)
    sup.shutdown()
    c = finish("stream", sup, builds, outs, range(4))
    c["streamed"] = len(streamed)
    if streamed != outs[0][1]:
        problems.append(f"stream: streamed {streamed} != result "
                        f"{outs[0][1]}")

    # (4) every build armed: restarts until the circuit opens (the last
    # case's supervisor and engine go first: the first build's entry is
    # the memory baseline)
    sup = None
    builds = Builds(qm, serve_kw, warm, arm="crash@decode:1",
                    arm_every=True)
    kernels.reset_counts()
    sup = Supervisor(builds, policy=policy(
        backoff_base_s=0.01, max_restarts=SUP_CIRCUIT_RESTARTS,
        restart_window_s=300.0)).start()
    hs = [sup.submit(p, max_new_tokens=SUP_MAX_NEW) for p in prompts[:4]]
    outs = _outcomes(hs)
    ready = sup.ready()
    try:
        sup.submit(prompts[0], max_new_tokens=SUP_MAX_NEW)
        rejected = None
    except Exception as e:  # noqa: BLE001 -- judged below
        rejected = type(e).__name__
    health = sup.health()
    sup.shutdown()
    c = finish("circuit", sup, builds, outs, range(4))
    c.update(ready=ready, rejected=rejected,
             rejected_count=health["stats"]["rejected"])
    if (any(o[2] != "CircuitOpenError" for o in outs)
            or sup.restarts != SUP_CIRCUIT_RESTARTS + 1
            or ready != {"ready": False, "reason": "circuit_open"}
            or rejected != "CircuitOpenError"
            or health["stats"]["rejected"] != 1):
        problems.append(f"circuit: outcomes {c['outcomes']}, restarts "
                        f"{sup.restarts}, ready {ready}, rejected "
                        f"{rejected} / {health['stats']['rejected']}")
    if cuda:
        # allocated once restart 1's and restart 3's new engine is built
        # and captured: the card then holds the parameters, the new
        # engine, and whatever the restart's thread allocated on first
        # use; the slack, half of one engine (its KV cache, decode buffers
        # and the graph pool's live outputs), is below what one leaked
        # engine adds.  On entry to each rebuild the supervisor has freed
        # the torn-down engine: the card holds no more than before the
        # first build, within the same slack
        rows = builds.rows
        footprint = rows[0]["mem_out"] - rows[0]["mem_in"]
        c["memory"] = dict(engine_bytes=footprint, slack=footprint // 2,
                           before_first_build=rows[0]["mem_in"],
                           after_restart_1=rows[1]["mem_out"],
                           after_restart_3=rows[3]["mem_out"],
                           teardowns=[r["mem_in"] for r in rows[1:]])
        if rows[3]["mem_out"] > rows[1]["mem_out"] + footprint // 2:
            problems.append(f"circuit: memory grew with restarts: "
                            f"{c['memory']}")
        if any(r["mem_in"] > rows[0]["mem_in"] + footprint // 2
               for r in rows[1:]):
            problems.append(f"circuit: a torn-down engine was still on "
                            f"the card at a rebuild: {c['memory']}")

    # (5) cold start from the journal of a supervisor stopped like a dead
    # process (a short first request completes before the stop)
    jpath = workdir / "cold.jsonl"
    kernels.reset_counts()
    first = Builds(qm, serve_kw, warm)
    dead = Supervisor(first, journal=RequestJournal(jpath),
                      policy=policy()).start()
    hs = [dead.submit(p, request_id=f"cold-{i}",
                      max_new_tokens=4 if i == 0 else SUP_MAX_NEW)
          for i, p in enumerate(prompts)]
    hs[0].result(timeout=SUP_WAIT)
    if not die_like_a_process(dead):
        problems.append("cold start: the first supervisor's serve thread "
                        "did not exit")
    with RequestJournal(jpath) as j:
        left = [r["rid"] for r in j.pending()]
    builds = Builds(qm, serve_kw, warm)
    sup = Supervisor(builds, journal=RequestJournal(jpath),
                     policy=policy()).start()
    got = sup.handles()
    rids = sorted(got, key=lambda r: int(r.split("-")[1]))
    outs = _outcomes([got[r] for r in rids])
    sup.shutdown()
    c = finish("cold_start", sup, builds, outs,
               [int(r.split("-")[1]) for r in rids],
               extra_stats=[first.rows[0]["stats"]])
    c["journal"] = journal_exact(jpath, "cold start")
    c["left_pending"] = len(left)
    if not left or rids != left or sup.replayed != len(left):
        problems.append(f"cold start: {len(left)} left pending, replayed "
                        f"{sup.replayed} ({rids})")

    for name, c in cases.items():
        if name != "circuit" and (c["goodput"] != 1.0
                                  or c["restarts"] != (name != "cold_start")):
            problems.append(f"{name}: goodput {c['goodput']}, restarts "
                            f"{c['restarts']}, outcomes {c['outcomes']}")
    return dict(cases=cases, counts=total), problems


def supervised_vision(vis, n_images: int = N_IMAGES, max_batch: int = BATCH):
    """Phase 9 (d): a supervised VisionEngine over ``vis`` under
    ``crash@vision:1``, every bucket warmed and captured before the first
    build is armed; ``n_images`` submitted in both classes must all end
    DONE after the restart, with finite logits and every forward's
    launches as routed.  Returns (results, problems)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.serving.supervisor import RestartPolicy, Supervisor
    cfg = vis.cfg
    rng = np.random.default_rng(6)
    images = rng.normal(0, 1, (max(n_images, max_batch), cfg.img_res,
                               cfg.img_res, 3)).astype(np.float32)

    def warm(eng):
        n = max_batch
        while n >= 1:
            eng.classify(images[:n])
            n //= 2

    builds = Builds(vis, dict(max_batch=max_batch), warm,
                    arm="crash@vision:1")
    field = "launches" if builds.cuda else "plain_calls"
    kernels.reset_counts()
    sup = Supervisor(builds, policy=RestartPolicy(
        hang_threshold_s=10.0, backoff_base_s=0.02,
        poll_interval_s=0.02)).start()
    hs = [sup.submit(img, slo="interactive" if i % 3 == 0 else "batch")
          for i, img in enumerate(images[:n_images])]
    outs = []
    for h in hs:
        try:
            outs.append(np.asarray(h.result(timeout=SUP_WAIT)))
        except BaseException as e:  # noqa: BLE001 -- judged below
            outs.append(type(e).__name__)
    sup.shutdown()
    counts = kernels.counts()
    m2q, dw, attn = main_path_calls(cfg, 1)
    # the MSA mixer runs int8 (relu_attn and its scales) on the card, f32
    # einsums on the CPU (the attn axis's backend default)
    n_attn = len(attn) if builds.cuda else 0
    per_fwd = {"m2q_matmul": len(m2q), "dwconv_w4": len(dw),
               "relu_attn": n_attn, "relu_attn_scales": n_attn}
    forwards = sum(r["stats"].batches for r in builds.rows)
    problems = launch_problems(
        counts, {k: n * forwards for k, n in per_fwd.items()},
        f"vision over {forwards} forwards", field)
    done = sum(1 for h in hs if h.state == "DONE")
    if done != n_images or sup.restarts != 1 or not all(
            isinstance(o, np.ndarray) and o.shape == (cfg.n_classes,)
            and np.isfinite(o).all() for o in outs):
        problems.append(f"vision: {done} of {n_images} DONE, restarts "
                        f"{sup.restarts}, outcomes "
                        f"{[o if isinstance(o, str) else 'logits' for o in outs]}")
    return dict(images=n_images, done=done, restarts=sup.restarts,
                forwards=forwards, log=sup.restart_log,
                figures=restart_figures(sup, builds),
                counts={k: c[field] for k, c in counts.items()}), problems


def kill_child() -> None:
    """One process of (c), run as ``python -c "import chip_smoke;
    chip_smoke.kill_child()" PHASE ARTIFACT JOURNAL SERVE_KW``: ``serve``
    submits phase 9's requests under a journal-backed supervisor (the
    first of 4 tokens, the rest of 16), waits until the first is
    journaled terminal, and SIGKILLs itself; ``replay`` cold-starts a
    supervisor from the journal and prints its results."""
    import os
    import signal
    from repro_torch.launch.daemon import PrefillGroups
    from repro_torch.recipe import QuantizedModel
    from repro_torch.serving.journal import RequestJournal
    from repro_torch.serving.supervisor import Supervisor
    phase, art, jpath, serve_kw = sys.argv[1:5]
    serve_kw = json.loads(serve_kw)
    device = serve_kw.pop("device")
    qm = QuantizedModel.load(art, device=device)
    groups = PrefillGroups()
    sup = Supervisor(lambda: groups.watch(qm.serve(**serve_kw)),
                     journal=RequestJournal(jpath)).start()
    if phase == "serve":
        hs = [sup.submit(p, request_id=f"req-{i}",
                         max_new_tokens=4 if i == 0 else SUP_MAX_NEW)
              for i, p in enumerate(supervised_requests(qm.cfg))]
        hs[0].result(timeout=SUP_WAIT)
        # its terminal is journaled by a done-callback on the serve
        # thread, which may run after this wait returns
        t0 = time.monotonic()
        while sup.journal.terminal_state("req-0") is None \
                and time.monotonic() - t0 < SUP_WAIT:
            time.sleep(0.01)
        print("KILL-READY", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)  # no shutdown, no drain
    results = {rid: [int(t) for t in h.result(timeout=SUP_WAIT)]
               for rid, h in sup.handles().items()}
    rec = sup.journal.reconcile()
    sup.shutdown()
    print("REPLAY-RESULT " + json.dumps(
        {"results": results, "reconcile": rec, "replayed": sup.replayed,
         "groups": groups}), flush=True)


def process_kill_replay(qm, art, workdir, serve_kw, device):
    """Phase 9 (c): a child process serving ``art`` (``qm`` saved) under a
    journal-backed supervisor is SIGKILLed mid-flight; a fresh one
    replays its journal.  The replayed tokens are held against a
    fault-free run of ``qm`` in this process.  Returns (results,
    problems)."""
    import os
    import signal
    from repro_torch.launch.daemon import PrefillGroups, replay_agreement
    from repro_torch.serving.journal import RequestJournal
    jpath = str(workdir / "kill.jsonl")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(SRC), str(ROOT)])}
    arg = json.dumps(dict(serve_kw, device=device))
    res, problems = {}, []

    def child(phase):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             "chip_smoke.kill_child()", phase, str(art), jpath, arg],
            env=env, cwd=ROOT, capture_output=True, text=True,
            timeout=SUP_WAIT)
        res[f"{phase}_s"] = time.perf_counter() - t0
        return p

    p1 = child("serve")
    if "KILL-READY" not in p1.stdout or p1.returncode != -signal.SIGKILL:
        return res, [f"kill: the serving child ended rc {p1.returncode}: "
                     f"{p1.stdout[-400:]} {p1.stderr[-1200:]}"]
    with RequestJournal(jpath) as j:
        res["after_kill"] = j.reconcile()
    p2 = child("replay")
    lines = [ln for ln in p2.stdout.splitlines()
             if ln.startswith("REPLAY-RESULT ")]
    if p2.returncode != 0 or not lines:
        return res, [f"kill: the replaying child ended rc {p2.returncode}: "
                     f"{p2.stderr[-1200:]}"]
    out = json.loads(lines[0].split(" ", 1)[1])
    prompts = supervised_requests(qm.cfg)
    idx = sorted(int(r.split("-")[1]) for r in out["results"])
    ref_groups = PrefillGroups()
    eng = ref_groups.watch(qm.serve(**serve_kw))
    refs = [eng.submit(prompts[i], max_new_tokens=4 if i == 0 else
                       SUP_MAX_NEW) for i in idx]
    eng.run()
    agree = replay_agreement(
        qm.cfg, qm.params, [prompts[i] for i in idx],
        [out["results"][f"req-{i}"] for i in idx],
        [r.handle.result() for r in refs], serve_kw["max_len"],
        out["groups"], ref_groups)
    with RequestJournal(jpath) as j:
        final = j.reconcile()
    res.update(replayed=out["replayed"], reconcile=out["reconcile"],
               final=final, agreement=agree)
    pending = res["after_kill"]["pending"]
    if (pending < 1 or res["after_kill"]["submitted"] != len(prompts)
            or out["replayed"] != len(idx) or len(idx) != pending
            or not final["exact"] or final["pending"] or agree["off"]):
        problems.append(f"kill: {json.dumps(res)[:1500]}")
    return res, problems


def run_supervised(torch, out_dir, card):
    """Phase 9, supervised serving on the card: (a) the daemon CLI's
    ``--recovery-smoke`` at full width, (b) :func:`supervised_cases` over
    phase 6's ``token`` artifact, (c) :func:`process_kill_replay` of it,
    (d) :func:`supervised_vision` over phase 4's ``m2q-w8a8`` artifact,
    (e) the CLI's ``--health-file`` read while it serves, (f) the restart
    figures printed beside the card.  Returns the kernels' counts of (a),
    (b), (d) and (e) (the process-kill children count their own)."""
    import gc
    import tempfile
    import threading
    from repro_torch import kernels, recipe
    from repro_torch.launch import daemon as launch_daemon

    total = Counter()
    res = {"card": card}

    def add(counts, what):
        plain = {k: c["plain_calls"] for k, c in counts.items()
                 if c["plain_calls"]}
        if plain:
            fail(f"phase 9 {what}: plain calls {plain}")
        total.update({k: c["launches"] for k, c in counts.items()})

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) the recovery smoke CLI, in-process, at full width (bf16 cache)
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc, text = _printed(launch_daemon.main, [
        "--arch", "qwen1.5-0.5b", "--recovery-smoke", "--timeout",
        str(SUP_WAIT)])
    counts = kernels.counts()
    add(counts, "(a)")
    m = _line(r"recovery smoke ok: crash@decode -> (\d+) restart\(s\), "
              r"(\d+) replayed, goodput=100%, results match fault-free "
              r"reference \((\d+) exact, (\d+) within the teacher-forced "
              r"bound\), journal exact \((\d+) submits == (\d+) "
              r"terminals\), (\d+) engine builds", text,
              "phase 9 (a) recovery smoke ok")
    log = json.loads(_line(r"restart log: (\[.*\])", text,
                           "phase 9 (a) restart log")[1])
    if rc != 0 or int(m[1]) < 1 or m[5] != m[6] \
            or not counts["int4_matmul"]["launches"]:
        fail(f"phase 9 (a): rc {rc}, {m[0]!r}, counts {counts}")
    res["recovery_cli"] = dict(
        line=m[0], restarts=int(m[1]), replayed=int(m[2]), exact=int(m[3]),
        bounded=int(m[4]), log=log, wall_s=time.perf_counter() - t0,
        launches={k: c["launches"] for k, c in counts.items()
                  if c["launches"]})
    print("phase 9 (a):", json.dumps(res["recovery_cli"]), flush=True)
    release()

    # (b) the scripted supervisor cases, (c) the process kill
    tok = recipe.QuantizedModel.load(ARTIFACTS / "token", device="cuda")
    serve_kw = dict(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN, seed=0)
    with tempfile.TemporaryDirectory(dir=ARTIFACTS) as wd:
        b, problems = supervised_cases(tok, serve_kw, Path(wd), hang_s=2.0)
        if problems:
            fail("phase 9 (b): " + "; ".join(problems)[:2000])
        total.update(b["counts"])
        res["cases"] = b["cases"]
        print("phase 9 (b):", json.dumps({
            name: {k: c[k] for k in ("restarts", "replayed", "goodput",
                                     "agreement", "outcomes")}
            for name, c in b["cases"].items()}), flush=True)
        print("phase 9 (b) circuit memory:",
              json.dumps(b["cases"]["circuit"]["memory"]), flush=True)
        release()
        k, problems = process_kill_replay(tok, ARTIFACTS / "token",
                                          Path(wd), serve_kw, "cuda")
        if problems:
            fail("phase 9 (c): " + "; ".join(problems)[:2000])
        res["process_kill"] = k
        print("phase 9 (c):", json.dumps(k), flush=True)
    del tok
    release()

    # (d) a supervised vision daemon under crash@vision
    vis = recipe.QuantizedModel.load(ARTIFACTS / "m2q-w8a8", device="cuda")
    v, problems = supervised_vision(vis)
    if problems:
        fail("phase 9 (d): " + "; ".join(problems)[:2000])
    total.update(v["counts"])
    res["vision"] = v
    print("phase 9 (d):", json.dumps(v), flush=True)
    del vis
    release()

    # (e) --health-file, its snapshots read while the CLI serves
    hpath = ARTIFACTS / "health.json"
    snaps, torn, stop = [], [], threading.Event()

    def poll():
        while not stop.is_set():
            try:
                snaps.append(json.loads(hpath.read_text()))
            except FileNotFoundError:
                pass
            except json.JSONDecodeError as e:
                torn.append(repr(e))
            stop.wait(0.02)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    kernels.reset_counts()
    try:
        rc, text = _printed(launch_daemon.main, [
            "--arch", "qwen1.5-0.5b", "--health-file", str(hpath),
            "--max-batch", str(TOKEN_BATCH), "--max-len", "128",
            "--requests", "8", "--max-new", str(SUP_MAX_NEW),
            "--timeout", str(SUP_WAIT)])
    finally:
        stop.set()
        th.join(SUP_WAIT)
    counts = kernels.counts()
    add(counts, "(e)")
    final = json.loads(hpath.read_text())
    serving = [s for s in snaps if s["state"] == "running"
               and s["ready"]["ready"]]
    res["health_file"] = dict(
        snapshots=len(snaps), ready_snapshots=len(serving), torn=torn,
        keys=sorted(final), final_state=final["state"],
        restarts=final["restarts"], stats=final["stats"],
        trip_latches=final["trip_latches"])
    if (rc != 0 or not serving or torn or set(final) != HEALTH_KEYS
            or any(s["restarts"] for s in snaps) or final["restarts"]
            or final["trip_latches"] != {"axes": {
                "dense": 0, "conv": 0, "attn": 0}}
            or final["stats"]["completed"] != 8
            or not counts["int4_matmul"]["launches"]):
        fail(f"phase 9 (e): rc {rc}, {json.dumps(res['health_file'])}")
    print("phase 9 (e):", json.dumps(res["health_file"]), flush=True)
    release()

    # (f) per restart: detection, teardown, backoff, factory, recovery
    # seconds and allocated bytes, beside the card
    figures = {f"(b) {name}": c["figures"]
               for name, c in res["cases"].items() if c["figures"]}
    figures["(d) vision"] = v["figures"]
    figures["(a) cli"] = [{k: e.get(k) for k in (
        "reason", "teardown_s", "backoff_s", "factory_s", "recovery_s")}
        for e in log]
    print(card, flush=True)
    for what, rows in figures.items():
        for row in rows:
            print(f"phase 9 (f) {what}:", json.dumps(row), flush=True)
    res["figures"] = figures
    (out_dir / "chip_smoke_supervised.json").write_text(
        json.dumps(res, indent=1, default=str))
    return total


# ---- phase 10: the dense LM pool -------------------------------------------
# each config at its published width, random weights from seed 0, int8 KV
LM_POOL = ("qwen3-14b", "granite-3-8b", "minitron-4b", "internvl2-2b")
POOL_REQUESTS = 8
POOL_NEW = 16
POOL_PREFIX_STEPS = 8
# one prefill group of the pool's traffic: 8 prompts of 8-64 tokens,
# padded to 64
POOL_PREFILL_LEN = 64
# the pool case whose decode step is traced (the others are graph-timed
# only): the largest, whose breakdown PERF.md cites
TRACED_POOL = (("qwen3-14b", "decode"),)


def pool_requests(cfg, n: int = POOL_REQUESTS):
    """``n`` seeded prompts of 8-64 tokens."""
    import numpy as np
    rng = np.random.default_rng(10)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(8, 65)),
                         dtype=np.int32) for _ in range(n)]


def kernel_of(leaf):
    """The kernel ``ops.qtensor_matmul`` sends ``leaf`` (a 2-D leaf or a
    layer slice) to, or None where it takes the plain ``x @ dequant``."""
    from repro_torch.core.qtensor import QAPoT, QExpertM2Q, QM2Q, QUniform
    from repro_torch.kernels import ops
    if not ops.kernel_supported(leaf):
        return None
    if isinstance(leaf, (QM2Q, QExpertM2Q)):
        return "m2q_matmul"
    if isinstance(leaf, QAPoT):
        return "apot_matmul"
    return "int8_matmul" if leaf.bits == 8 else "int4_matmul"


def tree_launches(qm, steps: int, groups: int) -> Counter:
    """The kernel launches of ``steps`` decode steps and ``groups``
    prefill groups, worked out from the quantized tree: each stacked
    layer matmul (a leaf of 3 or more dimensions: (L, K, N), or an MoE
    expert leaf (L, E, K, N)) whose layer slice a kernel takes once per
    layer of its stack (recurrentgemma's ``rec`` and ``attn`` stacks
    hold different counts), an expert leaf whose layer slice
    ``m2q_matmul`` takes once per expert and layer, a kernel-run lm_head
    once, in every step and group; with an int8 cache, decode_attn_int8
    once per layer and step."""
    from repro_torch.core.qtensor import slice_layer
    from repro_torch.kernels import ops
    cfg = qm.cfg
    per_pass = Counter()
    for r in qm.report:
        leaf = _get(qm.params, r.path)
        if len(r.shape) >= 3:
            layer = slice_layer(leaf, 0)
            if ops.expert_kernel_supported(layer):
                per_pass["m2q_matmul"] += r.shape[0] * cfg.moe_experts
            else:
                per_pass[kernel_of(layer)] += r.shape[0]
        elif r.path != "embed":  # the embedding is a row gather
            per_pass[kernel_of(leaf)] += 1
    per_pass.pop(None, None)
    want = Counter({k: v * (steps + groups) for k, v in per_pass.items()})
    if cfg.kv_cache_dtype == "int8":
        want["decode_attn_int8"] += cfg.n_layers * steps
    return want


def _sync_peak(torch, device, reset: bool):
    """Synchronize the card and return its peak allocated bytes since the
    last reset (resetting it if asked); None off the card."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return peak


def pool_quantize(torch, cfg, kind: str, device="cuda"):
    """``init`` of ``cfg`` on ``device`` (seed 0), then ``recipe.quantize``
    under m2q-w8a8 -- at the decode deployment shape (``kind``
    ``"decode"``: 2 tokens a step, from the calibration batch), at 64
    tokens a step (``"mixed"``) or at ``kind`` tokens a step (an int) --
    or under the preset ``kind`` names (``"w4-weights-only"``), with the
    float tree handed over (``release=True``: each float leaf leaves the
    card once its QTensor exists).  Returns (qm, {init_s, quantize_s,
    init_peak_bytes, quantize_peak_bytes})."""
    from repro_torch import recipe
    from repro_torch.models import get_model
    if kind in recipe.PRESETS:
        rec = recipe.PRESETS[kind]
    else:
        rec = recipe.PRESETS["m2q-w8a8"]
        if kind != "decode":
            rec = rec.replace(tokens_per_step=64 if kind == "mixed"
                              else kind)
    _sync_peak(torch, device, reset=True)
    t0 = time.perf_counter()
    params = get_model(cfg).init(cfg, seed=0, device=device)
    init_peak = _sync_peak(torch, device, reset=True)
    t1 = time.perf_counter()
    qm = recipe.quantize(cfg, params, rec, release=True)
    del params
    quant_peak = _sync_peak(torch, device, reset=True)
    return qm, {"init_s": t1 - t0, "quantize_s": time.perf_counter() - t1,
                "init_peak_bytes": init_peak,
                "quantize_peak_bytes": quant_peak}


def pool_serve(torch, qm, device="cuda",
               requests: int = POOL_REQUESTS, max_new: int = POOL_NEW,
               max_len: int = TOKEN_MAX_LEN, prompts=None,
               max_batch: int = TOKEN_BATCH, trace: bool = True):
    """Serve ``requests`` greedy requests of ``max_new`` tokens
    (``prompts``, or :func:`pool_requests`') through the token Engine
    (``max_batch`` 8; an int8 KV cache where the config has one),
    eagerly (one pass) and
    from its CUDA graphs (two passes: the first captures the decode step,
    the second is timed; on the CPU every pass runs eagerly), and hold
    the run: graph tokens equal eager tokens, every token below
    ``vocab_size``, each request its token count, the launches of every
    pass equal to :func:`tree_launches` (at full width and the decode
    shape, one int4_matmul a step and group besides decode_attn_int8
    once a layer and step; at REDUCED width the mixed path's), and the
    teacher-forced kernel logits of two requests within
    TEACHER_FORCED_BOUND of max |logit| of ``reference_path()``'s, a
    served token never further below the teacher-forced argmax than
    that; for a model without ``RAGGED_PREFILL`` (the recurrent
    families, whose prefill and decode carry a state), those logits also
    within the bound of the model's eager ``forward`` over prompt +
    forced tokens at the same positions.  On the card the batch-8 decode
    step is graph-timed, and with ``trace`` traced by torch.profiler.
    Returns (figures, problems, kernel launches)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch.daemon import (TEACHER_FORCED_BOUND,
                                           teacher_forced_logits)
    cfg = qm.cfg
    on_card = torch.device(device).type == "cuda"
    field = "launches" if on_card else "plain_calls"
    if prompts is None:
        prompts = pool_requests(cfg, requests)
    problems, res, served, launches = [], {}, {}, Counter()
    for graphs, passes in ((False, ("eager",)),
                           (True, ("graph warm", "graph"))):
        engine = qm.serve(max_batch=max_batch, max_len=max_len, seed=0,
                          graphs=graphs)
        for mode in passes:
            s0 = (engine.stats.steps, engine.stats.prefill_batches)
            kernels.reset_counts()
            t0 = time.perf_counter()
            handles = [engine.submit(p, max_new_tokens=max_new)
                       for p in prompts]
            engine.run()
            _sync_peak(torch, device, reset=False)
            res[f"{mode}_pass_s"] = time.perf_counter() - t0
            counts = kernels.counts()
            outs = served[mode] = [h.handle.result() for h in handles]
            steps = engine.stats.steps - s0[0]
            groups = engine.stats.prefill_batches - s0[1]
            res[f"{mode}_steps"], res[f"{mode}_groups"] = steps, groups
            want = tree_launches(qm, steps, groups)
            got = {k: c[field] for k, c in counts.items() if c[field]}
            if got != dict(want):
                problems.append(f"{mode}: {field} {got} over {steps} steps "
                                f"and {groups} prefill groups, expected "
                                f"{dict(want)}")
            if on_card and any(c["plain_calls"] for c in counts.values()):
                problems.append(f"{mode}: plain calls {counts}")
            launches.update({k: c["launches"] for k, c in counts.items()})
            if any(len(t) != max_new for t in outs):
                problems.append(f"{mode}: token counts "
                                f"{[len(t) for t in outs]}")
        if graphs:
            if engine.step_graphs is not None:
                res["graph_capture_s"] = engine.step_graphs.capture_s
            cache = {k: v.clone() for k, v in engine.cache.items()}
        del engine
    for mode in ("graph warm", "graph"):
        if served[mode] != served["eager"]:
            problems.append(f"{mode} pass: graph-served tokens differ from "
                            "the eager ones")
    top_id = max(t for toks in served["eager"] for t in toks)
    res["served_tokens_max"] = top_id
    if top_id >= cfg.vocab_size:
        problems.append(f"served token {top_id} >= vocab {cfg.vocab_size}")
    generated = sum(len(t) for t in served["graph"])
    res["tokens_per_s"] = {m: generated / res[f"{m}_pass_s"]
                           for m in ("eager", "graph")}

    # teacher-forced logits, kernels vs plain versions: two requests
    pick = [0, 1][:len(prompts)]
    steps = max_new - 1
    forced = np.array([served["eager"][i][:steps] for i in pick]).T
    with torch.no_grad():
        got = teacher_forced_logits(cfg, qm.params, [prompts[i] for i in pick],
                                    forced, max_len)
        with ops.reference_path():
            ref = teacher_forced_logits(cfg, qm.params,
                                        [prompts[i] for i in pick], forced,
                                        max_len)
    diff, top = float((got - ref).abs().max()), float(ref.abs().max())
    bound = TEACHER_FORCED_BOUND * top
    margins = token_margins(got.cpu().numpy(), np.array(
        [served["eager"][i][:steps + 1] for i in pick]).T)
    res.update(teacher_forced_max_abs_diff=diff, logits_max_abs=top,
               teacher_forced_bound=bound,
               largest_served_gap=margins["largest_gap"],
               served_off_argmax=len(margins["mismatches"]))
    if not diff <= bound:
        problems.append(f"teacher-forced logits differ from the plain "
                        f"versions' by {diff} (bound {bound})")
    if not margins["largest_gap"] <= bound:
        problems.append(f"a served token sits {margins['largest_gap']} below "
                        f"the teacher-forced argmax (bound {bound})")
    if not getattr(qm.model, "RAGGED_PREFILL", False):
        fdiff = ftop = 0.0
        for j, i in enumerate(pick):
            full = np.concatenate([prompts[i], forced[:, j]])[None]
            fw = qm.forward(full)[0, len(prompts[i]) - 1:, :cfg.vocab_size]
            fdiff = max(fdiff, float((got[:, j] - fw.float()).abs().max()))
            ftop = max(ftop, float(fw.float().abs().max()))
            del fw
        fbound = TEACHER_FORCED_BOUND * ftop
        res.update(forward_max_abs_diff=fdiff, forward_logits_max_abs=ftop,
                   forward_bound=fbound)
        if not fdiff <= fbound:
            problems.append(f"teacher-forced logits differ from the eager "
                            f"forward's by {fdiff} (bound {fbound})")

    # the batch-8 decode step at the served cache's lengths, in a graph,
    # and traced eagerly: device busy ms and the kernels that take it
    if on_card:
        tok = torch.zeros((max_batch, 1), dtype=torch.int64, device=device)
        with torch.no_grad():
            res["decode_step_graph_ms"] = graph_ms(
                lambda: qm.model.decode_step(cfg, qm.params, cache, tok),
                iters=2, reps=3)
            if trace:
                res["decode_step_trace"] = device_profile(
                    lambda: qm.model.decode_step(cfg, qm.params, cache,
                                                 tok), iters=2, top=6)
        res["decode_lengths"] = cache["lengths"].tolist()
    res["peak_bytes_serving"] = _sync_peak(torch, device, reset=True)
    return res, problems, launches


def lm_pool_case(torch, cfg, kind: str, device="cuda",
                 requests: int = POOL_REQUESTS, max_new: int = POOL_NEW,
                 max_len: int = TOKEN_MAX_LEN):
    """:func:`pool_quantize` then :func:`pool_serve` of one config:
    (figures, problems)."""
    qm, res = pool_quantize(torch, cfg, kind, device)
    served, problems, _ = pool_serve(torch, qm, device, requests,
                                     max_new, max_len)
    return dict(res, **served), problems


def lm_pool_prefix_case(torch, qm, steps: int = POOL_PREFIX_STEPS,
                        device="cuda"):
    """internvl2 with its stub frontend: one ragged ``prefill`` of 4
    prompts of 16-48 tokens behind ``n_patches`` prefix embeddings
    (standard normal, from seed 11), then ``steps`` teacher-forced
    ``decode_step`` calls, once with the kernels and once under
    ``reference_path()``; the logits must agree within
    TEACHER_FORCED_BOUND of max |logit|.  Returns (figures, problems,
    kernel launches)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch.daemon import TEACHER_FORCED_BOUND
    from repro_torch.models import dense_lm
    cfg = qm.cfg
    P = cfg.n_patches
    rng = np.random.default_rng(11)
    lens = rng.integers(16, 49, 4)
    toks = rng.integers(0, cfg.vocab_size, (4, int(lens.max())))
    prefix = rng.normal(0, 1, (4, P, cfg.d_model)).astype(np.float32)
    forced = rng.integers(0, cfg.vocab_size, (steps, 4))
    max_len = P + int(lens.max()) + steps

    def run():
        cache = dense_lm.init_cache(cfg, 4, max_len, device=device)
        lg, cache = dense_lm.prefill(
            cfg, qm.params, cache, torch.from_numpy(toks).to(device),
            prefix_embeds=torch.from_numpy(prefix).to(device),
            lengths=torch.from_numpy((P + lens).astype(np.int32)).to(device))
        out = [lg[:, 0, :cfg.vocab_size].float()]
        for t in forced:
            lg, cache = dense_lm.decode_step(
                cfg, qm.params, cache, torch.from_numpy(t[:, None]).to(device))
            out.append(lg[:, 0, :cfg.vocab_size].float())
        return torch.stack(out)

    kernels.reset_counts()
    with torch.no_grad():
        got = run()
        counts = kernels.counts()
        with ops.reference_path():
            ref = run()
    diff, top = float((got - ref).abs().max()), float(ref.abs().max())
    bound = TEACHER_FORCED_BOUND * top
    problems = []
    if not diff <= bound:
        problems.append(f"prefix path: logits differ from the plain "
                        f"versions' by {diff} (bound {bound})")
    field = "launches" if torch.device(device).type == "cuda" \
        else "plain_calls"
    want = tree_launches(qm, steps, 1)
    got_counts = {k: c[field] for k, c in counts.items() if c[field]}
    if got_counts != dict(want):
        problems.append(f"prefix path: {field} {got_counts}, expected "
                        f"{dict(want)}")
    res = dict(prefix=P, prompt_lengths=lens.tolist(), steps=steps,
               max_abs_diff=diff, logits_max_abs=top, bound=bound,
               same_argmax=float((got.argmax(-1) == ref.argmax(-1))
                                 .float().mean()))
    return res, problems, Counter({k: c["launches"]
                                   for k, c in counts.items()})


def run_lm_pool(torch, out_dir, card) -> Counter:
    """Phase 10: (a) each config of ``LM_POOL`` at its published width
    quantized at the decode shape and served (:func:`pool_quantize`,
    :func:`pool_serve`); (c) internvl2's prefix path on its (a) model;
    (b) minitron-4b at 64 tokens a step, the mixed LM with the relu2
    group.  Every case's figures printed beside the card; any problem
    fails the run.  Returns the kernel launches."""
    from repro_torch.configs.registry import ARCHS
    t0 = time.perf_counter()
    gc.collect()  # what earlier phases left: their peaks are not ours
    torch.cuda.empty_cache()
    total = Counter()
    out = {"allocated_at_start": torch.cuda.memory_allocated()}
    cases = [(name, "decode") for name in LM_POOL] + [("minitron-4b",
                                                        "mixed")]
    for name, kind in cases:
        cfg = ARCHS[name].replace(kv_cache_dtype="int8")
        qm, res = pool_quantize(torch, cfg, kind)
        problems = [f"{r.path} is not 4-bit at the decode shape"
                    for r in qm.report if kind == "decode"
                    and (r.decision != "lowbit" or r.bits != 4.0)]
        served, more, launches = pool_serve(
            torch, qm, trace=(name, kind) in TRACED_POOL)
        problems += more
        res.update(served)
        total.update(launches)
        if name == "internvl2-2b" and kind == "decode":
            res["prefix"], more, launches = lm_pool_prefix_case(torch, qm)
            problems += more
            total.update(launches)
        key = f"{name} {kind}"
        out[key] = res
        print(f"phase 10 {key}:", json.dumps(res), flush=True)
        if problems:
            fail(f"phase 10 {key}: " + "; ".join(problems)[:2000])
        del qm
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    out["card"] = card
    print(f"phase 10: {out['phase_s']:.1f} s; {card}", flush=True)
    (out_dir / "chip_smoke_lm_pool.json").write_text(
        json.dumps(out, indent=1))
    return total


# ---- phase 11: the MoE LMs ------------------------------------------------
# (name, layers of the published depth served, tokens a step of the
# recipe: None is the decode shape).  Published widths; the depth is cut
# because the f32 trees do not fit the card at full depth (llama4-scout
# 8.81 GB a layer + 8.28 GB of embed and head; dbrx 12.9 GB a layer), and
# llama4-scout's to 2 layers to keep the run inside its time with phase
# 16's MoE and recurrent sub-phases.
MOE_CASES = (("llama4-scout-17b-a16e", 2, None), ("dbrx-132b", 1, 256))


def moe_m2q_calls(cfg, batch: int, prefill_len: int, label: str):
    """m2q_matmul's calls (path, M, K, N) in one decode step and one
    prefill group of a mixed MoE LM (dbrx at 256 tokens a step): per
    layer the four attention slices on every token, each expert's w1, w3
    and w2 on its ``capacity`` rows (E launches a leaf), then the lm_head
    on the last position of each prompt."""
    from repro_torch.models import dense_lm
    from repro_torch.nn import moe
    mcfg = dense_lm.moe_config(cfg)
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.moe_experts

    def layers(tokens):
        C = moe.capacity(tokens, mcfg)
        per = [("attn/wq", tokens, D, cfg.q_dim),
               ("attn/wk", tokens, D, cfg.kv_dim),
               ("attn/wv", tokens, D, cfg.kv_dim),
               ("attn/wo", tokens, cfg.q_dim, D)]
        per += [(f"moe/experts/{w}", C, k, n) for _ in range(E)
                for w, k, n in (("w1", D, F), ("w3", D, F), ("w2", F, D))]
        return [(f"layers/{p}@{i}", M, K, N)
                for i in range(cfg.n_layers) for p, M, K, N in per]
    head = ("lm_head", batch, D, cfg.padded_vocab)
    return {f"{label} decode step": layers(batch) + [head],
            f"{label} prefill group": layers(batch * prefill_len) + [head]}


def shard_m2q_calls(cfg, batch: int, prefill_len: int, label: str):
    """m2q_matmul's calls on one rank of phase 16 (c) (model=2) that
    differ in shape from :func:`moe_m2q_calls`' (an expert's calls keep
    their shapes): the attention slices of the rank's heads (wq / wk /
    wv columns, wo rows) and its lm_head shard."""
    m = SHARD_RANKS
    local = cfg.replace(n_heads=cfg.n_heads // m,
                        n_kv_heads=cfg.n_kv_heads // m)
    return {path: [(p, M, K, N // m if p == "lm_head" else N)
                   for p, M, K, N in calls if "experts/" not in p]
            for path, calls in moe_m2q_calls(local, batch, prefill_len,
                                             label).items()}


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a parameter tree (QTensor fields
    included; ``meta`` tensors count their shapes)."""
    import dataclasses
    import torch
    from repro_torch.core.tree import leaves_with_path
    total = 0
    for _, leaf in leaves_with_path(tree):
        ts = [leaf] if isinstance(leaf, torch.Tensor) else [
            getattr(leaf, f.name) for f in dataclasses.fields(leaf)]
        total += sum(t.numel() * t.element_size() for t in ts
                     if isinstance(t, torch.Tensor))
    return total


def leaf_problems(qm, mixed: bool) -> list:
    """An LM tree's leaves as the recipe must make them (the MoE LMs,
    the recurrent ones): at the decode shape, or weights-only, every
    leaf a 4-bit QUniform (MoE experts (L, E, K, N) with axis 3); mixed,
    every leaf but the embedding mixed, MoE experts QExpertM2Q of 4-D
    payload with (L, 1, 1, 1) activation scales."""
    from repro_torch.core.qtensor import QExpertM2Q, QUniform
    cfg = qm.cfg
    L, E = cfg.n_layers, cfg.moe_experts
    problems = []
    for r in qm.report:
        leaf = _get(qm.params, r.path)
        expert = "experts/" in r.path
        if not mixed or r.path == "embed":
            ok = (r.decision == "lowbit" and isinstance(leaf, QUniform)
                  and leaf.bits == 4
                  and (not expert or (leaf.axis == 3
                                      and leaf.payload.shape[:2] == (L, E))))
            want = "4-bit" + (" (L, E, K, N/2), axis 3" if expert else "")
        elif expert:
            ok = (r.decision == "mixed" and isinstance(leaf, QExpertM2Q)
                  and leaf.payload.ndim == 4
                  and tuple(leaf.payload.shape[:2]) == (L, E)
                  and leaf.act_scale is not None
                  and tuple(leaf.act_scale.shape) == (L, 1, 1, 1))
            want = "a QExpertM2Q (L, E, K, N), (L, 1, 1, 1) act scale"
        else:
            ok = r.decision.startswith("mixed")
            want = "mixed"
        if not ok:
            problems.append(f"{r.path} ({type(leaf).__name__}, "
                            f"{r.decision}) is not {want}")
    return problems


def moe_case(torch, cfg, tokens_per_step=None, device="cuda",
             requests: int = POOL_REQUESTS, max_new: int = POOL_NEW,
             max_len: int = TOKEN_MAX_LEN, artifacts: Path = ARTIFACTS):
    """One MoE LM: :func:`pool_quantize` (``init`` on ``device``, seed 0;
    m2q-w8a8 at the decode shape, or at ``tokens_per_step``; the float
    tree released leaf by leaf), the artifact saved under ``artifacts``
    and loaded on ``device`` (every leaf bit-identical,
    :func:`round_trip`), the quantized model freed, and the loaded one
    served by :func:`pool_serve` (eager and graphed tokens equal, none >=
    vocab, launches as :func:`tree_launches` counts them, teacher-forced
    logits within the bound of ``reference_path()``'s).  Returns
    (figures, problems, kernel launches, the loaded model)."""
    kind = "decode" if tokens_per_step is None else tokens_per_step
    qm, res = pool_quantize(torch, cfg, kind, device)
    res["leaves"] = {r.path: f"{type(_get(qm.params, r.path)).__name__} "
                     f"{r.decision} {tuple(r.shape)}" for r in qm.report}
    res["quantized_bytes"] = tree_bytes(qm.params)
    loaded, res["artifact"] = round_trip(torch, qm, cfg.name, device,
                                         artifacts)
    del qm
    served, problems, launches = pool_serve(torch, loaded, device,
                                            requests, max_new, max_len,
                                            trace=False)
    res.update(served)
    return res, problems, launches, loaded


def run_moe(torch, out_dir, card) -> Counter:
    """Phase 11: each of ``MOE_CASES`` at its published width, its depth
    cut, int8 KV: :func:`moe_case` on the card, its leaves held to
    :func:`leaf_problems` (at full width the decode shape is all 4-bit,
    a recipe's ``tokens_per_step`` the mixed tree), one model at a time
    (freed before the next), beside its full-depth 4-bit tree bytes from
    ``abstract_quantize`` at the decode shape (meta tensors).  Any
    problem fails the run.  Returns the kernel launches."""
    from repro_torch import recipe
    from repro_torch.configs.registry import ARCHS
    t0 = time.perf_counter()
    gc.collect()  # what earlier phases left: their peaks are not ours
    torch.cuda.empty_cache()
    total = Counter()
    out = {"allocated_at_start": torch.cuda.memory_allocated()}
    for name, layers, toks in MOE_CASES:
        cfg = ARCHS[name].replace(n_layers=layers, kv_cache_dtype="int8")
        res, problems, launches, qm = moe_case(torch, cfg, toks)
        problems += leaf_problems(qm, mixed=toks is not None)
        del qm
        res["layers"] = f"{layers} of {ARCHS[name].n_layers}"
        res["full_depth_4bit_bytes"] = tree_bytes(
            recipe.abstract_quantize(name))
        total.update(launches)
        out[name] = res
        print(f"phase 11 {name}:", json.dumps(res), flush=True)
        if problems:
            fail(f"phase 11 {name}: " + "; ".join(problems)[:2000])
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    out["card"] = card
    print(f"phase 11: {out['phase_s']:.1f} s; {card}", flush=True)
    (out_dir / "chip_smoke_moe.json").write_text(json.dumps(out, indent=1))
    return total


# ---- phase 12: the recurrent families --------------------------------------
# (name, layers served (None: the published depth), pool_quantize's kind).
# rwkv6-3b at full depth (3.1 B parameters, 12.3 GB f32) at the decode
# shape (all 4-bit) and at 64 tokens a step (the mixed LM);
# recurrentgemma-9b at its published width, 8 of 38 layers (rec, rec,
# attn twice, then the two tail recurrent layers of 38's pattern; 15.5 GB
# f32), under w4-weights-only: a calibrating recipe fails in the
# reference (its forward reshapes the stacked rec leaves).
RECURRENT_CASES = (("rwkv6-3b", None, "decode"), ("rwkv6-3b", None, "mixed"),
                   ("recurrentgemma-9b", 8, "w4-weights-only"))
# three prompt lengths: the exact-length buckets take a pass for each
RECURRENT_LENGTHS = (8, 32, 64)
# the request that crosses recurrentgemma's 2048-token window: its ring
# (W = min(window, max_len) = 2048 rows) wraps during decode
WINDOW_PROMPT = 2040
WINDOW_MAX_LEN = 2304
RWKV_MIXED = ("tm/wr", "tm/wk", "tm/wv", "tm/wg", "tm/wo", "cm/cw_r",
              "cm/cw_v")


def recurrent_requests(cfg, n: int = POOL_REQUESTS,
                       lengths=RECURRENT_LENGTHS):
    """``n`` seeded prompts whose lengths cycle through ``lengths``."""
    import numpy as np
    rng = np.random.default_rng(12)
    return [rng.integers(0, cfg.vocab_size, lengths[i % len(lengths)],
                         dtype=np.int32) for i in range(n)]


def rwkv_m2q_calls(cfg, batch: int, group: tuple, label: str):
    """m2q_matmul's calls (path, M, K, N) in one decode step and one
    prefill group (``group``: its prompts and their length) of the mixed
    rwkv (64 tokens a step): the seven stacked ``QExpertM2Q`` matmuls of
    every layer (``RWKV_MIXED``; cw_k is perm-folded: ``x @ dequant``),
    then the lm_head on the last position of each prompt."""
    D, F = cfg.d_model, cfg.d_ff
    shapes = {p: (F if p == "cm/cw_v" else D, D) for p in RWKV_MIXED}

    def layers(M):
        return [(f"layers/{p}@{i}", M, *shapes[p])
                for i in range(cfg.n_layers) for p in RWKV_MIXED]
    n, length = group
    return {f"{label} decode step": layers(batch) + [
                ("lm_head", batch, D, cfg.padded_vocab)],
            f"{label} prefill group": layers(n * length) + [
                ("lm_head", n, D, cfg.padded_vocab)]}


def recurrent_case(torch, cfg, kind, device="cuda",
                   requests: int = POOL_REQUESTS, max_new: int = POOL_NEW,
                   max_len: int = TOKEN_MAX_LEN, window_prompt=None,
                   window_max_len=None, check_leaves: bool = False):
    """One recurrent LM: :func:`pool_quantize` (``init`` on ``device``,
    seed 0, the float tree released leaf by leaf; with ``check_leaves``
    the tree held to :func:`leaf_problems`, at full width: the decode
    shape and w4-weights-only all 4-bit, 64 tokens a step mixed), then
    :func:`pool_serve` of ``requests`` prompts of
    ``RECURRENT_LENGTHS`` (one exact-length prefill group a length, the
    forward check on); with ``window_prompt``, one more request of that
    many prompt tokens at ``window_max_len`` through an engine of one
    slot (recurrentgemma: the ring wraps), its eager prefill timed
    alone.  Returns (figures, problems, kernel launches)."""
    import numpy as np
    qm, res = pool_quantize(torch, cfg, kind, device)
    res["leaves"] = {r.path: f"{type(_get(qm.params, r.path)).__name__} "
                     f"{r.decision} {tuple(r.shape)}" for r in qm.report}
    res["quantized_bytes"] = tree_bytes(qm.params)
    problems = leaf_problems(qm, mixed=kind == "mixed") if check_leaves \
        else []
    served, more, launches = pool_serve(
        torch, qm, device, requests, max_new, max_len,
        prompts=recurrent_requests(cfg, requests), trace=False)
    problems += more
    res.update(served)
    res["prefill_groups"] = served["eager_groups"]
    if window_prompt:
        wl = window_max_len or window_prompt + max_new
        prompt = recurrent_requests(cfg, 1, (window_prompt,))
        cache = qm.model.init_cache(cfg, 1, wl, dtype=torch.float32,
                                    device=device)
        _sync_peak(torch, device, reset=False)
        t0 = time.perf_counter()
        with torch.no_grad():
            qm.model.prefill(cfg, qm.params, cache, torch.as_tensor(
                np.asarray(prompt[0], np.int64)[None], device=device))
        _sync_peak(torch, device, reset=False)
        prefill_s = time.perf_counter() - t0
        del cache
        w, more, wlaunch = pool_serve(torch, qm, device, 1, max_new, wl,
                                      prompts=prompt, max_batch=1,
                                      trace=False)
        w.update(prompt_tokens=window_prompt, max_len=wl,
                 ring_rows=min(cfg.window, wl), eager_prefill_s=prefill_s)
        res["window"] = w
        problems += [f"window request: {p}" for p in more]
        launches.update(wlaunch)
    del qm
    return res, problems, launches


def run_recurrent(torch, out_dir, card) -> Counter:
    """Phase 12: each of ``RECURRENT_CASES`` at its published width through
    :func:`recurrent_case` on the card, its leaves checked, one model at
    a time, recurrentgemma
    with the window request and beside its full-depth 4-bit tree bytes
    from ``abstract_quantize``.  Any problem fails the run.  Returns the
    kernel launches."""
    from repro_torch import recipe
    from repro_torch.configs.registry import ARCHS
    t0 = time.perf_counter()
    gc.collect()  # what earlier phases left: their peaks are not ours
    torch.cuda.empty_cache()
    total = Counter()
    out = {"allocated_at_start": torch.cuda.memory_allocated()}
    for name, layers, kind in RECURRENT_CASES:
        cfg = ARCHS[name]
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        res, problems, launches = recurrent_case(
            torch, cfg, kind, check_leaves=True,
            window_prompt=WINDOW_PROMPT if cfg.window else None,
            window_max_len=WINDOW_MAX_LEN)
        res["layers"] = f"{cfg.n_layers} of {ARCHS[name].n_layers}"
        if layers is not None:
            res["full_depth_4bit_bytes"] = tree_bytes(
                recipe.abstract_quantize(name, recipe=kind))
        total.update(launches)
        key = f"{name} {kind}"
        out[key] = res
        print(f"phase 12 {key}:", json.dumps(res), flush=True)
        if problems:
            fail(f"phase 12 {key}: " + "; ".join(problems)[:2000])
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    out["card"] = card
    print(f"phase 12: {out['phase_s']:.1f} s; {card}", flush=True)
    (out_dir / "chip_smoke_recurrent.json").write_text(
        json.dumps(out, indent=1))
    return total


# ---- phase 13: the encoder-decoder (whisper) --------------------------------
# whisper-large-v3 at its published width and depth (32 encoder and 32
# decoder layers, d 1280, 20 heads of 64, vocab 51866 -> 51968, 1500
# frames; 1.58 B parameters, 6.31 GB f32) under w4-weights-only (a
# calibrating recipe fails in the reference: its encode scans the wrapped
# encoder leaves).  The token Engine prefills without frames, so it
# fails a whisper request in both packages; the model's own prefill /
# decode_step serve it here.
WHISPER = "whisper-large-v3"
WHISPER_BATCH = 8
WHISPER_PROMPT = 16
WHISPER_STEPS = 32
WHISPER_MAX_LEN = 64


def whisper_inputs(torch, cfg, batch: int, prompt_len: int, device):
    """(frames (batch, n_audio_ctx, d_model) standard normal, prompts
    (batch, prompt_len) int64), from numpy's generator seeded with 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((batch, cfg.n_audio_ctx, cfg.d_model),
                                 dtype=np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    return (torch.from_numpy(frames).to(device),
            torch.from_numpy(prompts).to(device))


def whisper_greedy(torch, cfg, params, frames, prompts, steps: int,
                   max_len: int, graphs: bool, cache_dtype=None):
    """``prefill(..., frames=)`` of the prompts, then ``steps`` greedy
    ``decode_step`` calls (argmax over the first ``vocab_size`` logits,
    as the token Engine takes them), eagerly or -- ``graphs`` on the card
    -- each step a replay of one CUDA graph that writes the cache in
    place, advances ``lengths`` and feeds its argmax back, with no host
    read between steps.  Returns (tokens (B, 1 + steps), logits (B, 1 +
    steps, vocab_size) f32, {prefill_s, decode_s, pass_s[, capture_s]});
    the cache holds ``cache_dtype`` rows (None: bf16, JAX's default)."""
    from repro_torch.models import whisper
    on_card = frames.device.type == "cuda"
    V = cfg.vocab_size
    res = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cache = whisper.init_cache(cfg, prompts.shape[0], max_len,
                               dtype=cache_dtype or torch.bfloat16,
                               device=frames.device)
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, cache = whisper.prefill(cfg, params, cache, prompts,
                                    frames=frames)
        lgv = lg[:, -1, :V].float()
        tok = lgv.argmax(-1)[:, None]
        sync()
        res["prefill_s"] = time.perf_counter() - t0
        logits, toks = [lgv], [tok]
        t1 = time.perf_counter()
        if graphs and on_card:
            static_tok = tok.clone()
            lengths = cache["lengths"].clone()

            def step():
                out, new = whisper.decode_step(cfg, params, cache,
                                               static_tok)
                cache["lengths"].copy_(new["lengths"])
                v = out[:, -1, :V].float()
                static_tok.copy_(v.argmax(-1)[:, None])
                return v

            graph, static_lg = capture(step)
            # the warm-ups advanced the state: back to the prefill's
            cache["lengths"].copy_(lengths)
            static_tok.copy_(tok)
            sync()
            res["capture_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            for _ in range(steps):
                graph.replay()
                logits.append(static_lg.clone())
                toks.append(static_tok.clone())
        else:
            for _ in range(steps):
                out, cache = whisper.decode_step(cfg, params, cache, tok)
                lgv = out[:, -1, :V].float()
                tok = lgv.argmax(-1)[:, None]
                logits.append(lgv)
                toks.append(tok)
        sync()
    res["decode_s"] = time.perf_counter() - t1
    res["pass_s"] = res["prefill_s"] + res["decode_s"]
    return torch.cat(toks, 1), torch.stack(logits, 1), res


def whisper_split_ms(torch, qm, frames, max_len: int) -> dict:
    """The graphed device ms of what one batch-8 decode step repeats in
    every decoder layer, times the layer count: the dequantize chain (each
    stacked decoder leaf's layer slice, plus the tied head's whole
    embedding once), self attention over ``max_len`` cache rows and cross
    attention over the ``n_audio_ctx`` memory rows."""
    from repro_torch import nn
    from repro_torch.core.qtensor import slice_layer
    cfg, L = qm.cfg, qm.cfg.n_layers
    B = frames.shape[0]
    deq = sum(graph_ms(lambda: slice_layer(_get(qm.params, r.path),
                                           0).dequant(torch.bfloat16),
                       iters=5, reps=3)
              for r in qm.report if r.path.startswith("dec_layers/"))
    emb = graph_ms(lambda: qm.params["embed"].dequant(torch.bfloat16),
                   iters=5, reps=3)
    gen = torch.Generator(device=frames.device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=frames.device,
                           dtype=torch.bfloat16)
    q = rand(B, 1, cfg.n_heads, cfg.head_dim)
    k, v = (rand(B, max_len, cfg.n_kv_heads, cfg.head_dim) for _ in "kv")
    xk, xv = (rand(B, cfg.n_audio_ctx, cfg.n_kv_heads, cfg.head_dim)
              for _ in "kv")
    lengths = torch.full((B,), WHISPER_PROMPT + WHISPER_STEPS,
                         dtype=torch.int32, device=frames.device)
    full = torch.full((B,), cfg.n_audio_ctx, dtype=torch.int32,
                      device=frames.device)
    return {"dequantize_ms": L * deq + emb, "embed_dequantize_ms": emb,
            "self_attention_ms": L * graph_ms(
                lambda: nn.decode_attention(q, k, v, lengths), iters=5,
                reps=3),
            "cross_attention_ms": L * graph_ms(
                lambda: nn.decode_attention(q, xk, xv, full), iters=5,
                reps=3)}


def whisper_case(torch, cfg, device="cuda", batch: int = WHISPER_BATCH,
                 prompt_len: int = WHISPER_PROMPT,
                 steps: int = WHISPER_STEPS,
                 max_len: int = WHISPER_MAX_LEN, artifacts: Path = ARTIFACTS):
    """whisper on ``device``: :func:`pool_quantize` under
    w4-weights-only (``init`` seed 0, the float tree released leaf by
    leaf; every leaf held to 4-bit), the artifact saved and loaded
    (:func:`round_trip`: bit-identical), then :func:`whisper_greedy` of
    ``batch`` prompts of ``prompt_len`` tokens over seeded frames, once
    eagerly and once from a CUDA graph of the decode step (on the CPU
    eagerly again): graph tokens equal eager tokens, no id >= vocab, the
    decode logits within TEACHER_FORCED_BOUND of max |logit| of the eager
    teacher-forced ``forward(tokens, frames=)``, and the kernel launches
    what :func:`tree_launches` counts for the tree (none: no whisper leaf
    reaches a kernel) with 0 plain calls.  On the card also times
    ``encode`` and the decode step (eager and graphed), traces one step
    and splits it (:func:`whisper_split_ms`).  Returns (figures,
    problems)."""
    from repro_torch import kernels
    from repro_torch.launch.daemon import TEACHER_FORCED_BOUND
    from repro_torch.models import whisper
    on_card = torch.device(device).type == "cuda"
    qm, res = pool_quantize(torch, cfg, "w4-weights-only", device)
    problems = leaf_problems(qm, mixed=False)
    res["quantized_bytes"] = tree_bytes(qm.params)
    loaded, res["artifact"] = round_trip(torch, qm, cfg.name, device,
                                         artifacts)
    del qm
    qm = loaded
    frames, prompts = whisper_inputs(torch, cfg, batch, prompt_len, device)
    runs = {}
    for mode, graphs in (("eager", False), ("graph", True)):
        kernels.reset_counts()
        toks, logits, figs = whisper_greedy(torch, cfg, qm.params, frames,
                                            prompts, steps, max_len, graphs)
        counts = {k: c for k, c in kernels.counts().items()
                  if c["launches"] or c["plain_calls"]}
        want = tree_launches(qm, steps, 1)
        if {k: c["launches"] for k, c in counts.items()} != dict(want) \
                or any(c["plain_calls"] for c in counts.values()):
            problems.append(f"{mode}: kernel counts {counts}, expected "
                            f"launches {dict(want)} and no plain call")
        runs[mode] = toks, logits
        figs["tokens_per_s"] = toks.numel() / figs["pass_s"]
        res[mode] = figs
    res["peak_bytes_serving"] = _sync_peak(torch, device, reset=True)
    toks, logits = runs["eager"]
    if not torch.equal(runs["graph"][0], toks):
        problems.append("graph tokens differ from the eager ones")
    res["served_tokens_max"] = int(toks.max())
    if res["served_tokens_max"] >= cfg.vocab_size:
        problems.append(f"token {res['served_tokens_max']} >= vocab "
                        f"{cfg.vocab_size}")
    with torch.no_grad():
        full = torch.cat([prompts, toks[:, :steps]], 1)
        fw = whisper.forward(cfg, qm.params, full, frames=frames)
        fw = fw[:, prompt_len - 1:, :cfg.vocab_size].float()
    diff, top = float((logits - fw).abs().max()), float(fw.abs().max())
    bound = TEACHER_FORCED_BOUND * top
    res.update(forward_max_abs_diff=diff, forward_logits_max_abs=top,
               forward_bound=bound,
               graph_max_abs_diff=float((runs["graph"][1] - logits)
                                        .abs().max()),
               same_argmax=float((fw.argmax(-1) == toks).float().mean()))
    del fw, runs
    if not diff <= bound:
        problems.append(f"decode logits differ from the teacher-forced "
                        f"forward's by {diff} (bound {bound})")
    if on_card:
        params = qm.params
        with torch.no_grad():
            res["encode_ms"] = cuda_ms(
                lambda: whisper.encode(cfg, params, frames), iters=3,
                warmup=1)
            cache = whisper.init_cache(cfg, batch, max_len, device=device)
            _, cache = whisper.prefill(cfg, params, cache, prompts,
                                       frames=frames)
            cache["lengths"] += steps
            tok = toks[:, -1:].clone()

            def step():
                return whisper.decode_step(cfg, params, cache, tok)
            res["decode_step_eager_ms"] = cuda_ms(step, iters=5, warmup=1)
            res["decode_step_graph_ms"] = graph_ms(step, iters=2, reps=3)
            res["decode_step_trace"] = device_profile(step, iters=2, top=6)
            res["decode_step_split_ms"] = whisper_split_ms(
                torch, qm, frames, max_len)
            del cache
        res["cross_cache_bytes"] = 2 * cfg.n_layers * batch \
            * cfg.n_audio_ctx * cfg.kv_dim * 2
    return res, problems


def run_whisper(torch, out_dir, card) -> Counter:
    """Phase 13: :func:`whisper_case` of whisper-large-v3 at its published
    width and depth on the card, beside the full 4-bit tree's bytes from
    ``abstract_quantize``; any problem fails the run.  Returns the kernel
    launches (none)."""
    from repro_torch import kernels, recipe
    from repro_torch.configs.registry import ARCHS
    t0 = time.perf_counter()
    gc.collect()  # what earlier phases left: their peaks are not ours
    torch.cuda.empty_cache()
    out = {"allocated_at_start": torch.cuda.memory_allocated()}
    cfg = ARCHS[WHISPER]
    kernels.reset_counts()
    res, problems = whisper_case(torch, cfg)
    launches = Counter({k: c["launches"]
                        for k, c in kernels.counts().items()})
    res["layers"] = f"{cfg.n_enc_layers} + {cfg.n_layers}"
    res["abstract_4bit_bytes"] = tree_bytes(recipe.abstract_quantize(
        WHISPER, recipe="w4-weights-only"))
    if res["abstract_4bit_bytes"] != res["quantized_bytes"]:
        problems.append(f"the 4-bit tree holds {res['quantized_bytes']} "
                        f"bytes, its shape-only twin "
                        f"{res['abstract_4bit_bytes']}")
    out[WHISPER] = res
    print(f"phase 13 {WHISPER}:", json.dumps(res), flush=True)
    if problems:
        fail(f"phase 13 {WHISPER}: " + "; ".join(problems)[:2000])
    out["phase_s"] = time.perf_counter() - t0
    out["card"] = card
    print(f"phase 13: {out['phase_s']:.1f} s; {card}", flush=True)
    (out_dir / "chip_smoke_whisper.json").write_text(
        json.dumps(out, indent=1))
    return launches


# ---- phase 14: training -----------------------------------------------------
# qwen1.5-0.5b at its published width and depth (24 layers, d 1024, 16
# heads of 64, d_ff 2816, vocab 151936; 619.6 M f32 parameters, bf16
# compute) trained on SyntheticLM by the port's CLI, then quantized
# under phase 6's two token recipes and served
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_STEPS = 50
TRAIN_BATCH = 8
TRAIN_SEQ = 256
TRAIN_LR = 1e-3
TRAIN_WARMUP = TRAIN_STEPS // 10
# the resume check: a straight run of STRAIGHT_STEPS steps beside the
# training run, which stops after step RESUME_STOP, publishes it, and
# resumes from that checkpoint to TRAIN_STEPS (the same schedule)
STRAIGHT_STEPS = 10
RESUME_STOP = 4
# held-out SyntheticLM batches: the steps after the training range
HELD_OUT = 4
TRAIN_TIMEOUT = 600.0
# the elastic check at REDUCED width, as tests/test_elastic.py runs it
ELASTIC = dict(steps=12, batch=2, seq=16, ckpt_every=3, log_every=1,
               crash_at_step=7, max_restarts=2)


def _src_env() -> dict:
    """This process's environment with ``src`` first on PYTHONPATH: what
    a ``python -m repro_torch...`` child needs."""
    import os
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=str(SRC) + (os.pathsep + path
                                                   if path else ""))


def start_train_cli(workdir, name: str, metrics, ckpt_dir=None,
                    stop_at=None):
    """Start ``python -m repro_torch.launch.train`` at the full width on
    the card (the schedule of TRAIN_STEPS steps, every step logged to
    ``metrics``), stopping cleanly after ``stop_at`` where given; its
    output goes to ``workdir/<name>.out``.  Returns the running job for
    :func:`finish_train_cli`."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--device", "cuda", "--steps", str(TRAIN_STEPS),
           "--warmup", str(TRAIN_WARMUP), "--batch", str(TRAIN_BATCH),
           "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--log-every",
           "1", "--metrics", str(metrics)]
    if ckpt_dir is not None:  # only the final (or stop-step) save
        cmd += ["--ckpt-dir", str(ckpt_dir), "--ckpt-every",
                str(10 * TRAIN_STEPS)]
    if stop_at is not None:
        cmd += ["--stop-at-step", str(stop_at)]
    log = workdir / f"{name}.out"
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=ROOT, env=_src_env())
    return {"name": name, "proc": proc, "log": log, "t0": time.perf_counter()}


def finish_train_cli(job) -> tuple:
    """Wait (at most TRAIN_TIMEOUT seconds; then kill) for a job of
    :func:`start_train_cli`.  Returns (exit code, its output, seconds
    from start to exit)."""
    proc = job["proc"]
    try:
        rc = proc.wait(TRAIN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
        rc = "killed at its time limit"
    return rc, job["log"].read_text(), time.perf_counter() - job["t0"]


def checked_train_cli(job, result) -> tuple:
    """(output, seconds) of a finished job; fails the run unless it
    exited 0."""
    rc, text, seconds = result
    if rc != 0:
        fail(f"phase 14: the {job['name']} run exited {rc}: {text[-2000:]}")
    return text, seconds


def metrics_by_step(path) -> dict:
    """step -> the metrics records of that step, in the file's order."""
    by_step = {}
    for line in Path(path).read_text().splitlines():
        rec = json.loads(line)
        by_step.setdefault(rec["step"], []).append(rec)
    return by_step


def training_problems(by_step: dict, steps: int) -> list:
    """Phase 14 (a)'s gates on a metrics file: every step logged once,
    every loss and grad_norm finite, the mean loss of the last 10 steps
    below the first 10's, no straggler."""
    import math
    problems = []
    if sorted(by_step) != list(range(steps)) \
            or any(len(r) != 1 for r in by_step.values()):
        problems.append(f"logged steps {sorted(by_step)[:5]}... with "
                        f"{[s for s, r in by_step.items() if len(r) != 1]} "
                        "logged more than once; expected each of "
                        f"0..{steps - 1} once")
        return problems
    recs = [by_step[s][0] for s in range(steps)]
    bad = [r["step"] for r in recs
           if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]))]
    if bad:
        problems.append(f"non-finite loss or grad_norm at steps {bad}")
    first = sum(r["loss"] for r in recs[:10]) / 10
    last = sum(r["loss"] for r in recs[-10:]) / 10
    if not last < first:
        problems.append(f"the mean loss of the last 10 steps {last} is not "
                        f"below the first 10's {first}")
    slow = [r["step"] for r in recs if r["straggler"]]
    if slow:
        problems.append(f"straggler steps {slow}")
    return problems


def held_out_batches(torch, cfg, n: int, start: int, batch: int, seq: int):
    """``n`` SyntheticLM batches (seed 0) at steps ``start`` .. on the card:
    past the training range, so no step trained on them."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    import numpy as np
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0))
    return [{k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in data.batch(start + i).items()} for i in range(n)]


def held_out_ce(torch, cfg, logits_of, batches) -> float:
    """The mean next-token cross-entropy of ``logits_of(tokens)`` over
    ``batches`` (``train.step.softmax_xent``, the training loss)."""
    from repro_torch.train.step import softmax_xent
    total = 0.0
    with torch.no_grad():
        for b in batches:
            logits = logits_of(b["tokens"])
            total += float(softmax_xent(logits[:, :-1], b["labels"][:, 1:],
                                        cfg.vocab_size))
            del logits
    return total / len(batches)


def elastic_case(torch, workdir) -> tuple:
    """``launch.elastic.run_supervised`` on the card at REDUCED width with
    a hard crash after step 7, held as tests/test_elastic.py holds it:
    one restart, the last step published, every step logged, the
    replayed step twice and each step's losses identical.  Returns
    (figures, problems)."""
    import os
    from repro_torch.ckpt.checkpoint import latest_step
    from repro_torch.launch.elastic import run_supervised
    ckpt_dir, metrics = workdir / "elastic_ckpt", workdir / "elastic.jsonl"
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = _src_env()["PYTHONPATH"]
    t0 = time.perf_counter()
    try:
        restarts = run_supervised(TRAIN_ARCH, ELASTIC["steps"],
                                  str(ckpt_dir), str(metrics),
                                  batch=ELASTIC["batch"], seq=ELASTIC["seq"],
                                  ckpt_every=ELASTIC["ckpt_every"],
                                  log_every=ELASTIC["log_every"],
                                  crash_at_step=ELASTIC["crash_at_step"],
                                  max_restarts=ELASTIC["max_restarts"],
                                  device="cuda")
    finally:
        if saved is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved
    res = {"seconds": time.perf_counter() - t0, "restarts": restarts,
           "latest_step": latest_step(ckpt_dir)}
    by_step = metrics_by_step(metrics)
    crash, steps = ELASTIC["crash_at_step"], ELASTIC["steps"]
    res["logged_twice"] = sorted(s for s, r in by_step.items() if len(r) > 1)
    problems = []
    if restarts != 1 or res["latest_step"] != steps - 1:
        problems.append(f"restarts {restarts}, latest step "
                        f"{res['latest_step']}")
    if sorted(by_step) != list(range(steps)) or res["logged_twice"] != [crash]:
        problems.append(f"steps logged {sorted(by_step)}, twice "
                        f"{res['logged_twice']}; expected {crash} twice")
    unequal = [s for s, r in by_step.items()
               if len({x["loss"] for x in r}) != 1]
    if unequal:
        problems.append(f"replayed steps {unequal} logged different losses")
    return res, problems


def run_training(torch, out_dir, card) -> Counter:
    """Phase 14: (a) qwen1.5-0.5b trained at full width and depth on the
    card by the train CLI (TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens, stopped after RESUME_STOP and resumed from its published
    checkpoint); (b) a straight run of STRAIGHT_STEPS steps whose losses
    and grad norms must equal the training run's, and the elastic
    launcher on the card at REDUCED width (:func:`elastic_case`); (c)
    the final checkpoint's parameters restored, their held-out loss,
    quantized under phase 6's ``token`` and ``token-m2q`` recipes
    (calibrated on held-out SyntheticLM batches), each held-out loss,
    and 8 greedy requests on held-out SyntheticLM prompts served through
    :func:`pool_serve`.  Returns the kernel launches of (c)."""
    import shutil
    import statistics
    from repro_torch import recipe
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import dense_lm
    from repro_torch.optim.adamw import AdamW
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ARCHS[TRAIN_ARCH]
    work = ARTIFACTS / "train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {"card": card, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "lr": TRAIN_LR, "warmup": TRAIN_WARMUP}
    problems = []
    try:
        # (a) + (b): the straight run, the training run's first part and
        # the elastic case side by side (their start-ups overlap), then
        # the training run's second part alone (its step times are read)
        straight, trained, ckpt_dir = (work / "straight.jsonl",
                                       work / "train.jsonl", work / "ckpt")
        jobs = [start_train_cli(work, "straight", straight,
                                stop_at=STRAIGHT_STEPS - 1),
                start_train_cli(work, "train_part1", trained,
                                ckpt_dir=ckpt_dir, stop_at=RESUME_STOP)]
        try:
            res, probs = elastic_case(torch, work)
        finally:  # every job ends before anything fails
            results = [finish_train_cli(j) for j in jobs]
        (_, out["straight_s"]), (text1, out["train_part1_s"]) = \
            [checked_train_cli(j, r) for j, r in zip(jobs, results)]
        out["elastic"] = res
        problems += [f"(b) elastic: {p}" for p in probs]
        print("phase 14 (b) elastic:", json.dumps(res), flush=True)
        job = start_train_cli(work, "train_part2", trained,
                              ckpt_dir=ckpt_dir)
        text2, out["train_part2_s"] = checked_train_cli(
            job, finish_train_cli(job))
        for what, txt, want in (
                ("part 1", text1, f"[train] clean early exit at step "
                                  f"{RESUME_STOP}"),
                ("part 2", text2, f"[train] resumed from step "
                                  f"{RESUME_STOP}")):
            if want not in txt:
                problems.append(f"(a) {what} printed no {want!r}")
        summary = [ln for ln in text2.splitlines()
                   if ln.startswith("[train] arch=")]
        out["cli_summary"] = summary[-1] if summary else None
        if summary and "peak_alloc_bytes=" in summary[-1]:
            out["peak_alloc_bytes"] = int(
                summary[-1].split("peak_alloc_bytes=")[1].split()[0])
        by_step = metrics_by_step(trained)
        problems += [f"(a) {p}" for p in training_problems(by_step,
                                                           TRAIN_STEPS)]
        recs = [by_step[s][0] for s in sorted(by_step)]
        times = [r["step_time_s"] for r in recs[RESUME_STOP + 2:]]
        out.update(
            first_loss=recs[0]["loss"], last_loss=recs[-1]["loss"],
            first10_mean_loss=sum(r["loss"] for r in recs[:10]) / 10,
            last10_mean_loss=sum(r["loss"] for r in recs[-10:]) / 10,
            median_step_time_s=statistics.median(times),
            tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / statistics.median(times),
            max_grad_norm=max(r["grad_norm"] for r in recs))
        # (b) exact resume: the straight run's steps against the trained
        sb = metrics_by_step(straight)
        diffs = [max(abs(sb[s][0]["loss"] - by_step[s][0]["loss"]),
                     abs(sb[s][0]["grad_norm"] - by_step[s][0]["grad_norm"]))
                 for s in range(STRAIGHT_STEPS) if s in sb and s in by_step]
        out["resume_max_abs_diff"] = max(diffs) if diffs else None
        out["resume_steps_compared"] = len(diffs)
        if len(diffs) != STRAIGHT_STEPS or max(diffs) != 0.0:
            problems.append(f"(b) the straight run's losses and grad norms "
                            f"differ from the resumed run's: {diffs}")
        print("phase 14 (a):", json.dumps(
            {k: v for k, v in out.items() if k != "elastic"}), flush=True)

        # (c) the trained model: held-out losses, quantized and served
        last = ckpt.latest_step(ckpt_dir)
        t1 = time.perf_counter()
        meta = dense_lm.init(cfg, device="meta")
        (params, _), extra = ckpt.restore(ckpt_dir, last,
                                          (meta, AdamW().init(meta)),
                                          device="cuda")
        out["restore_s"] = time.perf_counter() - t1
        out["restored_step"] = extra["step"]
        if extra["step"] != TRAIN_STEPS - 1:
            problems.append(f"(c) the last checkpoint is step "
                            f"{extra['step']}")
        shutil.rmtree(work, ignore_errors=True)  # 7.4 GB a published step
        held = held_out_batches(torch, cfg, HELD_OUT, TRAIN_STEPS,
                                TRAIN_BATCH, TRAIN_SEQ)
        ce = {"float": held_out_ce(
            torch, cfg, lambda t: dense_lm.forward(cfg, params, t), held)}
        calib = [b["tokens"][:2, :32]
                 for b in held_out_batches(torch, cfg, 4, TRAIN_STEPS
                                           + HELD_OUT, TRAIN_BATCH, 32)]
        prompt_rows = held_out_batches(torch, cfg, 1, TRAIN_STEPS
                                       + HELD_OUT + 4, TRAIN_BATCH,
                                       TRAIN_SEQ)[0]["tokens"].cpu().numpy()
        lengths = [len(p) for p in pool_requests(cfg)]
        prompts = [row[:n] for row, n in zip(prompt_rows, lengths)]
        launches = Counter()
        qcfg = cfg.replace(kv_cache_dtype="int8")
        for name in ("token", "token-m2q"):
            t1 = time.perf_counter()
            qm = recipe.quantize(qcfg, params, token_recipe(name),
                                 calib_batches=calib)
            torch.cuda.synchronize()
            res = {"quantize_s": time.perf_counter() - t1}
            ce[name] = held_out_ce(torch, cfg, qm.forward, held)
            served, probs, ln = pool_serve(torch, qm, prompts=prompts,
                                           trace=False)
            launches.update(ln)
            res.update(served)
            out[name] = res
            problems += [f"(c) {name}: {p}" for p in probs]
            print(f"phase 14 (c) {name}:", json.dumps(res), flush=True)
            del qm
        out["held_out_ce"] = ce
        print("phase 14 (c) held-out cross-entropy:", json.dumps(ce),
              flush=True)
        del params
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    (out_dir / "chip_smoke_train.json").write_text(json.dumps(out, indent=1))
    if problems:
        fail("phase 14: " + "; ".join(problems)[:3000])
    print(f"phase 14: {out['phase_s']:.1f} s; {card}", flush=True)
    return launches


# ---- phase 15: kernel dispatch and autotuning ------------------------------
# main() points the port's autotune cache at a fresh file under the run's
# out dir before phase 1, so phases 1-14 start from an empty cache (their
# eager forwards tune lazily; their engines' steps never do).  Phase 15
# walks the sweep's CI set (autotune_sweep.CI_CONFIGS x CI_RECIPES at
# published widths), re-tunes every shape it finds into that file with
# each candidate checked against its plain version, runs the sweep's
# --smoke gate on it in a child process, serves from it, and drives the
# dispatch axes.
AUTOTUNE_CACHE = "chip_smoke_autotune_cache.json"
AUTOTUNE_SMOKE_TIMEOUT = 600.0


def _graph_tokens(qm, prompts, max_new: int, max_len: int) -> list:
    """One greedy pass of ``prompts`` through a graphed token Engine
    (eager on the CPU): each request's tokens."""
    engine = qm.serve(max_batch=TOKEN_BATCH, max_len=max_len, seed=0)
    handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run()
    return [h.handle.result() for h in handles]


def _lazy_tuning(torch, device, problems) -> dict:
    """One eager ``m2q_matmul_op`` at a shape no phase launches (M = 24):
    on the card every candidate is timed and the winner persisted; on the
    CPU nothing is.  Then the same op at M = 40 captured in a CUDA graph
    (card only; its warm-up call inside ``no_tuning``): no probe, nothing
    persisted."""
    from repro_torch.kernels import autotune, m2q_matmul, ops
    g = torch.Generator(device="cpu").manual_seed(24)
    K, N = 256, 96
    w = (torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8),
         torch.rand(N, generator=g) * 1e-2, torch.zeros(N), torch.zeros(N))
    sa = torch.tensor(0.02)
    x24, x40 = (torch.randn(M, K, generator=g).to(torch.bfloat16)
                for M in (24, 40))
    sa, x24, x40, *w = (t.to(device) for t in (sa, x24, x40, *w))
    on_card = torch.device(device).type == "cuda"

    def cached(M):
        return autotune.cached_plan("m2q_matmul", (M, K, N, torch.bfloat16),
                                    device) is not None

    autotune.reset_probe_count()
    ops.m2q_matmul_op(x24, sa, *w)
    res = {"eager_probes": autotune.tuning_probe_count(),
           "eager_persisted": cached(24)}
    want = len(m2q_matmul.candidate_plans(24, K, N)) if on_card else 0
    if res["eager_probes"] != want or res["eager_persisted"] != on_card:
        problems.append(f"(b) lazy tuning at an eager call: {res}")
    if on_card:
        with autotune.no_tuning():
            ops.m2q_matmul_op(x40, sa, *w)
        torch.cuda.synchronize()
        autotune.reset_probe_count()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ops.m2q_matmul_op(x40, sa, *w)
        res.update(capture_probes=autotune.tuning_probe_count(),
                   capture_persisted=cached(40))
        del graph
        if res["capture_probes"] or res["capture_persisted"]:
            problems.append(f"(b) tuning inside a capture: {res}")
    return res


def forward_sums(cfg, rows) -> dict:
    """Per VisionEngine bucket (batch 1, 2, 4, 8): each tuned kernel's
    ``launch_plan`` ms and tuned ms (phase 15's rows) summed over one B1
    forward's launches (:func:`main_path_calls`; int8_matmul runs the
    uniform8 forward's dense calls), and the launches whose plan moved."""
    by = {(r["kernel"], tuple(r["dims"])): r for r in rows}
    out = {}
    for b in (1, 2, 4, 8):
        m2q, dw, attn = main_path_calls(cfg, b)
        dense = [c[1:] for c in m2q]
        calls = {"m2q_matmul": dense, "int8_matmul": dense,
                 "dwconv_w4": [c[1:] for c in dw], "relu_attn": attn}
        for kernel, dims in calls.items():
            hit = [by.get((kernel, tuple(d) + ("bfloat16",))) for d in dims]
            if not all(hit):
                continue
            out.setdefault(f"batch {b}", {})[kernel] = {
                "launches": len(hit),
                "launch_plan_ms": sum(r["launch_plan_ms"] for r in hit),
                "tuned_ms": sum(r["tuned_ms"] for r in hit),
                "moved": sum(r["tuned"] != r["launch_plan"] for r in hit)}
    return out


def autotune_case(torch, device="cuda", reduced: bool = False):
    """Phase 15 on ``device`` (the CI set at published widths, or REDUCED
    for the CPU tests): (a) discover the shapes of B1 R224 under m2q-w8a8
    and uniform8 at VisionEngine's buckets and of qwen1.5-0.5b under its
    token recipes at the engine's decode batch and one prefill group;
    (b) tune every one into the run's cache (each candidate checked
    against the plain version; on the CPU launch_plan's plans are
    committed); (c) ``autotune_sweep --smoke`` on that cache in a child
    process; (d) serve the B1 recipes at batch 8 from it -- zero probes,
    logits bit-equal to an engine on an empty cache (launch_plan's plans)
    and graph equal to eager -- and qwen token-m2q through
    :func:`pool_serve`, its graphed tokens equal to an empty cache's;
    (e) the dispatch axes: all off launches no kernel, its logits within
    ``OFF_BOUND`` of the f32-attention kernel engine's and each quantized
    matmul bit-equal on the all-off forward's own inputs; a tripped conv
    axis shows in ``Supervisor.health()`` and routes the convs to the
    plain path until ``reset_trip_latch()``.  Returns (figures, problems,
    kernel launches, per-shape rows)."""
    import os
    import numpy as np
    from repro_torch import kernels
    from repro_torch.analysis import traces
    from repro_torch.core import qtensor
    from repro_torch.kernels import autotune, ops
    from repro_torch.launch import autotune_sweep as sw
    from repro_torch.nn import layers
    from repro_torch.serving.daemon import ServingDaemon
    from repro_torch.serving.supervisor import Supervisor

    on_card = torch.device(device).type == "cuda"
    field = "launches" if on_card else "plain_calls"
    cache = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    empty = cache + ".empty.json"
    res, problems, launches, rows = {}, [], Counter(), []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(key, t0):
        sync()
        res[key] = time.perf_counter() - t0

    # (a) the CI set: every deployment quantized once, then walked
    t0 = time.perf_counter()
    with autotune.no_tuning():
        deps = {label: qm for arch in sw.CI_CONFIGS
                for label, qm in traces.registry_deployments(
                    arch, recipes=sw.CI_RECIPES, device=device,
                    reduced=reduced)}
    reqs, per_trace = traces.walk(
        spec for label, qm in deps.items()
        for spec in traces.model_trace_specs(qm, label))
    timed("discover_s", t0)
    res["shapes"] = len(reqs)
    res["tunable_shapes"] = sum(r.tunable for r in reqs)
    res["per_trace"] = per_trace

    # (b) every tunable shape tuned (force_tune: one already cached is
    # tuned again), each candidate checked against the plain version
    autotune.reset_probe_count()
    t0 = time.perf_counter()
    sw.warm(reqs, cache, device, force_tune=True, rows=rows,
            progress=lambda *a: None)
    timed("warm_s", t0)
    res["probes"] = autotune.tuning_probe_count()
    res["candidates_checked"] = sum(r["candidates"] for r in rows)
    # a miss at an eager launch tunes (on the card) and persists; inside a
    # capture it takes launch_plan's plan, times nothing, persists nothing
    res["lazy"] = _lazy_tuning(torch, device, problems)

    # (c) the CI gate in a child process, on the same file
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.autotune_sweep",
           "--smoke", "--cache", cache, "--device", str(device)]
    proc = subprocess.run(cmd + (["--reduced"] if reduced else []),
                          cwd=ROOT, env=_src_env(), capture_output=True,
                          text=True, timeout=AUTOTUNE_SMOKE_TIMEOUT)
    timed("smoke_s", t0)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    res["smoke"] = {"rc": proc.returncode, "last_line": tail[0]}
    if proc.returncode != 0 or "0 tuning probes" not in tail[0]:
        problems.append(f"(c) --smoke rc {proc.returncode}: "
                        f"{proc.stdout[-800:]} {proc.stderr[-800:]}")

    # (d) served from the warmed cache against launch_plan's plans
    t0 = time.perf_counter()
    arch = sw.CI_CONFIGS[0]
    images = np.random.default_rng(15).normal(0, 1, (
        BATCH, deps[f"{arch}/m2q-w8a8"].cfg.img_res,
        deps[f"{arch}/m2q-w8a8"].cfg.img_res, 3)).astype(np.float32)
    autotune.reset_probe_count()
    served = {}
    for name in sw.CI_RECIPES:
        qm = deps[f"{arch}/{name}"]
        for label, path, graphs in (("graph", cache, True),
                                    ("eager", cache, False),
                                    ("launch_plan graph", empty, True)):
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = path
            try:
                eng = qm.serve(max_batch=BATCH, graphs=graphs)
                kernels.reset_counts()
                served[name, label] = eng.classify(images)
                counts = kernels.counts()
            finally:
                os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
            launches.update({k: c["launches"] for k, c in counts.items()})
            got = {k: c[field] for k, c in counts.items() if c[field]}
            if label == "graph":
                want = got
            elif got != want:
                problems.append(f"(d) {name} {label}: {field} {got}, the "
                                f"warmed graph engine's {want}")
            if on_card and (any(c["plain_calls"] for c in counts.values())
                            or not got):
                problems.append(f"(d) {name} {label}: counts {counts}")
            gap = np.abs(served[name, label] - served[name, "graph"])
            if gap.max() != 0:
                problems.append(f"(d) {name}: {label} logits differ from "
                                f"the warmed graph engine's by {gap.max()}")
        if not np.all(np.isfinite(served[name, "graph"])):
            problems.append(f"(d) {name}: non-finite logits")
    res["per_forward"] = forward_sums(deps[f"{arch}/m2q-w8a8"].cfg, rows)
    res["serve_probes"] = autotune.tuning_probe_count()
    if res["serve_probes"]:
        problems.append(f"(d) {res['serve_probes']} probes while serving "
                        "from the warmed cache")
    lm = deps[f"{sw.CI_CONFIGS[1]}/m2q-w8a8@{traces.LM_PREFILL_TOKENS}"]
    figs, probs, ln = pool_serve(torch, lm, device, trace=False)
    launches.update(ln)
    problems += [f"(d) token-m2q: {p}" for p in probs]
    prompts = pool_requests(lm.cfg)
    tokens = {}
    for label, path in (("warmed", cache), ("launch_plan", empty)):
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = path
        try:
            tokens[label] = _graph_tokens(lm, prompts, POOL_NEW,
                                          TOKEN_MAX_LEN)
        finally:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache
    if tokens["warmed"] != tokens["launch_plan"]:
        problems.append("(d) token-m2q: tokens from the warmed cache "
                        "differ from launch_plan's")
    res["token_m2q"] = {k: figs[k] for k in (
        "teacher_forced_max_abs_diff", "teacher_forced_bound",
        "tokens_per_s") if k in figs}
    timed("serve_s", t0)

    # (e) the dispatch axes on the m2q-w8a8 B1
    t0 = time.perf_counter()
    qm = deps[f"{arch}/m2q-w8a8"]
    off = ops.DispatchConfig(dense=False, conv=False, attn=False)
    logits = {}
    for label, cfg in (("off", off), ("f32 attention",
                                      ops.DispatchConfig(attn=False))):
        eng = qm.serve(max_batch=BATCH, dispatch=cfg)
        kernels.reset_counts()
        logits[label] = eng.classify(images)
        counts = kernels.counts()
        res[f"{label} counts"] = {k: c[field] for k, c in counts.items()
                                  if c[field]}
        if label == "off" and (any(c["launches"] for c in counts.values())
                               or counts["dwconv_w4"]["plain_calls"]):
            problems.append(f"(e) dispatch off: counts {counts}")
    diff = float(np.abs(logits["off"] - logits["f32 attention"]).max())
    top = float(np.abs(logits["f32 attention"]).max())
    res["off_vs_f32_attention"] = {"max_abs_diff": diff, "max_abs": top,
                                   "bound": OFF_BOUND * top}
    if not diff <= OFF_BOUND * top:
        problems.append(f"(e) dispatch-off logits differ from the "
                        f"f32-attention engine's by {diff} (max {top})")
    # each quantized matmul of the all-off forward, fed the activation
    # that forward gave it: the kernel path returns the plain path's bits;
    # and that eager forward is the all-off engine's, bit for bit
    seen, plain = [], layers.qmatmul
    layers.qmatmul = lambda x, w: seen.append((x, w)) or plain(x, w)
    try:
        with ops.dispatch(off):
            eager_off = qm.forward(images).float().cpu().numpy()
    finally:
        layers.qmatmul = plain
    if not np.array_equal(eager_off, logits["off"]):
        problems.append("(e) the all-off engine's logits differ from the "
                        "all-off eager forward's by "
                        f"{np.abs(eager_off - logits['off']).max()}")
    checked = 0
    with torch.inference_mode():
        for x, w in seen:
            if ops.kernel_supported(w):
                checked += 1
                if not torch.equal(ops.qtensor_matmul(x, w),
                                   qtensor.qmatmul(x, w)):
                    problems.append(f"(e) a {type(w).__name__} matmul "
                                    f"{tuple(x.shape)} differs between "
                                    "the kernel and the plain path")
    res["matmuls_bit_equal"] = checked
    if not checked:
        problems.append("(e) no quantized matmul was checked")
    # the conv axis tripped: health reports it; convs take the plain path
    eng = qm.serve(max_batch=BATCH)
    sup = Supervisor(lambda: ServingDaemon(eng))
    ops.trip_axis("conv")
    try:
        res["health_tripped"] = sup.health()["trip_latches"]
        kernels.reset_counts()
        tripped = eng.classify(images)
        counts = {k: c[field] for k, c in kernels.counts().items()
                  if c[field]}
    finally:
        ops.reset_trip_latch()
    res["tripped counts"] = counts
    res["health_reset"] = sup.health()["trip_latches"]
    if res["health_tripped"] != {"axes": {"dense": 0, "conv": 1,
                                          "attn": 0}} \
            or res["health_reset"] != {"axes": {"dense": 0, "conv": 0,
                                                "attn": 0}}:
        problems.append(f"(e) health: {res['health_tripped']} tripped, "
                        f"{res['health_reset']} reset")
    # the head's last matmul is nn.dense (the dense axis): one launch a
    # forward (on the CPU the plain QTensor path of a calibrated QM2Q leaf
    # is m2q_matmul's plain version, so every matmul counts there)
    if "dwconv_w4" in counts or (on_card
                                 and counts.get("m2q_matmul") != 1):
        problems.append(f"(e) conv tripped: {field} {counts}")
    if not np.all(np.isfinite(tripped)):
        problems.append("(e) conv tripped: non-finite logits")
    timed("dispatch_s", t0)
    del deps, qm, lm, eng
    if on_card:
        torch.cuda.empty_cache()
    return res, problems, launches, rows


# the dispatch-off forward against the f32-attention kernel forward (both
# on seed-0 random weights).  Every quantized matmul agrees bit for bit on
# its input (checked), so what differs is the depthwise conv: off, it is
# JAX's XLA path's twin, a torch conv over the 4-bit weights dequantized
# to bf16 (8 significant bits, each weight rounded by up to 2^-9 of
# itself), against the kernel's f32 weights; each of the 20 convs moves
# an output by about a bf16 ulp, and an int8 activation quantizer
# downstream turns a value moved across a rounding boundary into a
# one-step code change, which the following layers carry to the logits.
# Measured on an NVIDIA H100 80GB HBM3 at 700.00 W: 0.0664 of a max
# |logit| of 1.68 (3.95%).  The bound keeps 2.5x headroom over that; it
# catches what is no rounding (a wrong weight or path moves the logits
# by their own size), while the launch counts catch wrong routing.
OFF_BOUND = 1e-1


def run_autotune(torch, out_dir, card) -> Counter:
    """Phase 15 at published widths on the card; fails on any problem.
    Prints one line per tuned shape and the per-forward sums."""
    t0 = time.perf_counter()
    res, problems, launches, rows = autotune_case(torch)
    res["phase_s"] = time.perf_counter() - t0
    for row in rows:
        print("phase 15 shape:", json.dumps(row), flush=True)
    (out_dir / "chip_smoke_autotune_rows.json").write_text(
        json.dumps(rows, indent=0))
    (out_dir / "chip_smoke_autotune.json").write_text(
        json.dumps(res, indent=1))
    print("phase 15:", json.dumps(res), flush=True)
    if problems:
        fail("phase 15: " + "; ".join(problems)[:3000])
    print(f"phase 15: {res['phase_s']:.1f} s; {card}", flush=True)
    return launches


# phase 16: sharded serving, two ranks on the one card
SHARD_RANKS = 2
SHARD_WAIT = 600
# (c): phase 11's dbrx artifact (1 of 40 layers, m2q-w8a8 at 256 tokens a
# step: QExpertM2Q experts), expert-parallel on model=2; the MoE layer
# probe holds one prefill group's rows (8 prompts x 64)
SHARD_MOE = "dbrx-132b"
SHARD_MOE_ROWS = TOKEN_BATCH * 64
# (d): recurrentgemma-9b at its published width, 3 of 38 layers (rec,
# rec, attn: one attention block), w4-weights-only, drawn on the card
SHARD_RG = "recurrentgemma-9b"
SHARD_RG_LAYERS = 3
SHARD_RG_ART = "recurrentgemma-9b-sharded"


def shard_cases():
    """Phase 16 (c) and (d): (key, config, artifact directory name)."""
    from repro_torch.configs.registry import ARCHS
    moe = ARCHS[SHARD_MOE]
    return (("moe", moe.replace(n_layers=1, kv_cache_dtype="int8"),
             SHARD_MOE),
            ("recurrent", ARCHS[SHARD_RG].replace(n_layers=SHARD_RG_LAYERS),
             SHARD_RG_ART))


def shard_prompts(cfg):
    """Phase 16 (c) / (d)'s prompts: the LM pool's 8 (8-64 tokens), or the
    recurrent phase's (8 / 32 / 64 tokens: three exact-length groups)."""
    if cfg.family == "recurrentgemma":
        return recurrent_requests(cfg)
    return pool_requests(cfg)


def moe_probe(torch, cfg, device="cuda"):
    """The (SHARD_MOE_ROWS, d_model) input phase 16 (c) holds one MoE layer
    to: seeded normal rows in the model's dtype."""
    import numpy as np
    x = np.random.default_rng(16).normal(size=(SHARD_MOE_ROWS, cfg.d_model))
    return torch.as_tensor(x, dtype=getattr(torch, cfg.dtype),
                           device=device)


def moe_layer_out(torch, cfg, params):
    """Layer 0's MoE of ``params`` (a host tree, or a rank's compute tree)
    over :func:`moe_probe`, as f32 numpy."""
    from repro_torch import nn
    from repro_torch.core.tree import device_of
    from repro_torch.models import dense_lm
    moe = dense_lm.layer_params(params["layers"], 0)["moe"]
    with torch.no_grad():
        y = nn.moe_ffn(moe_probe(torch, cfg, device_of(params)), moe,
                       dense_lm.moe_config(cfg))
    return y.float().cpu().numpy()


def shard_images(cfg):
    """Phase 4's 12 images (seed 1)."""
    import numpy as np
    rng = np.random.default_rng(1)
    return rng.normal(0, 1, (N_IMAGES, cfg.img_res, cfg.img_res, 3)
                      ).astype(np.float32)


def sharded_child() -> None:
    """One rank of phase 16, run as ``python -c "import chip_smoke;
    chip_smoke.sharded_child()" RANK PORT OUT_DIR``: joins the other rank
    through ``launch.daemon``'s coordinator path (gloo: two ranks on one
    card), then (a) restores phase 4's ``m2q-w8a8`` artifact with its
    shards on a (data=2, model=1) mesh and serves the 12 images at
    max_batch 8 twice, eagerly, polled as phase 4 polls; (b) builds the
    token engine from phase 6's ``token`` artifact on a (data=1, model=2)
    mesh (``daemon.build_engine(..., mesh=)``: restored with shardings),
    checks every leaf's placement, and serves phase 6's 16 requests
    once through a ``ServingDaemon`` on each rank, as ``launch.daemon
    --mesh`` serves (rank 0's decides every step; the other steps in its
    broadcasts until rank 0's releases it at shutdown); (c) / (d)
    restores dbrx's and recurrentgemma's artifacts (:func:`shard_cases`)
    with their shards on the same mesh, runs dbrx's MoE layer 0 on
    :func:`moe_probe`, and serves each one's prompts through
    ``Engine.run``.  Writes its logits, tokens, launch counts and
    seconds."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import daemon
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.recipe import QuantizedModel
    from repro_torch.serving.daemon import ServingDaemon
    rank, port, out = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
    t0 = time.perf_counter()
    args = daemon.parse_args([
        "--arch", "qwen1.5-0.5b", "--device", "cuda",
        "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", str(SHARD_RANKS), "--process-id", str(rank),
        "--mesh", "1x2", "--artifact", str(ARTIFACTS / "token"),
        "--max-batch", str(TOKEN_BATCH), "--max-len", str(TOKEN_MAX_LEN)])
    tok_mesh = daemon.join_mesh(args)
    res = {"rank": rank, "backend": str(torch.distributed.get_backend()),
           "join_s": time.perf_counter() - t0}

    # (a) vision, data-parallel
    vis_mesh = make_mesh((SHARD_RANKS, 1), ("data", "model"), "cuda")
    t1 = time.perf_counter()
    vqm = QuantizedModel.load(ARTIFACTS / "m2q-w8a8", shardings=lambda t:
                              shd.shardings_from_specs(
                                  shd.param_specs(t, vis_mesh), vis_mesh))
    res["vision_load_s"] = time.perf_counter() - t1
    veng = vqm.serve(max_batch=BATCH, max_delay_ms=50.0, graphs=False,
                     mesh=vis_mesh)
    images = shard_images(vqm.cfg)
    for rep in ("warm", "timed"):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handles = [veng.submit(img) for img in images]
        poll_until_done(veng, handles, f"phase 16 (a) rank {rank}")
        torch.cuda.synchronize()
        res[f"vision_{rep}_s"] = time.perf_counter() - t1
        res[f"vision_{rep}_counts"] = kernels.counts()
        logits = np.stack([h.result() for h in handles])
        np.save(out / f"sharded_vision_{rank}_{rep}.npy", logits)
    res["vision_buckets"] = sorted(veng.stats.buckets_used)
    res["vision_batches"] = veng.stats.batches
    del veng, vqm

    # (b) token, tensor-parallel, through the daemon's artifact path
    t1 = time.perf_counter()
    eng = daemon.build_engine(args, mesh=tok_mesh)
    res["token_load_s"] = time.perf_counter() - t1
    problems, n_leaves, n_sharded = daemon.placement_problems(
        eng.params, shd.param_specs(eng.params, tok_mesh), tok_mesh)
    res["placement"] = {"problems": problems, "leaves": n_leaves,
                        "sharded": n_sharded}
    cache = eng.sharded_cache()
    res["cache"] = {k: {"global": list(v.shape),
                        "local": list(v.to_local().shape),
                        "placements": str(v.placements)}
                    for k, v in cache.items()}
    res["local_heads"] = eng._exec_cfg.n_heads
    reqs = token_requests(eng.cfg)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with ServingDaemon(eng) as served:  # one pass: eager
        handles = [served.submit(p, slo="batch", max_new_tokens=n,
                                 temperature=t) for p, n, t in reqs]
        res["token"] = [h.handle.result(timeout=SHARD_WAIT)
                        for h in handles]
    res["released"] = eng.lockstep.stopped
    torch.cuda.synchronize()
    res["token_s"] = time.perf_counter() - t1
    res["token_counts"] = kernels.counts()
    res["token_steps"] = [eng.stats.steps, eng.stats.prefill_batches]
    del eng

    # (c) dbrx expert-parallel, (d) recurrentgemma, both on model=2
    for key, cfg, art in shard_cases():
        t1 = time.perf_counter()
        qm = QuantizedModel.load(ARTIFACTS / art, shardings=lambda t:
                                 shd.shardings_from_specs(
                                     shd.param_specs(t, tok_mesh), tok_mesh))
        eng = qm.serve(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN, seed=0,
                       graphs=False, mesh=tok_mesh)
        res[f"{key}_load_s"] = time.perf_counter() - t1
        lc = eng._exec_cfg
        res[f"{key}_local"] = {"n_heads": lc.n_heads,
                               "n_kv_heads": lc.n_kv_heads,
                               "cache": {k: list(v.shape)
                                         for k, v in eng.cache.items()}}
        if key == "moe":  # one layer on the probe, before the counts
            np.save(out / f"sharded_moe_layer_{rank}.npy",
                    moe_layer_out(torch, qm.cfg, eng._exec))
            layer = eng._exec["layers"]["moe"]
            res["moe_local"]["experts"] = int(
                layer.experts["w1"].shape[-3])
        kernels.reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handles = [eng.submit(p, max_new_tokens=POOL_NEW)
                   for p in shard_prompts(qm.cfg)]
        eng.run()
        torch.cuda.synchronize()
        res[f"{key}_s"] = time.perf_counter() - t1
        res[f"{key}_counts"] = kernels.counts()
        res[f"{key}_tokens"] = [h.handle.result() for h in handles]
        res[f"{key}_steps"] = [eng.stats.steps, eng.stats.prefill_batches]
        del eng, qm
        gc.collect()
        torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    (out / f"sharded_rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def greedy_problems(torch, cfg, params, prompts, got, want, what: str):
    """Served greedy tokens ``got`` against the unsharded engine's
    ``want`` (request by request): each differing request's tokens must
    sit within TEACHER_FORCED_BOUND of max |logit| of the top of the
    unsharded model's teacher-forced logits over them.  Returns
    (figures, problems)."""
    import numpy as np
    from repro_torch.launch.daemon import (TEACHER_FORCED_BOUND,
                                           teacher_forced_logits)
    off = [i for i in range(len(got)) if got[i] != want[i]]
    res = {"greedy_equal": len(got) - len(off), "greedy_differing": off,
           "greedy_margins": []}
    problems = []
    for i in off:  # one request at a time: the recurrent families'
        n = len(got[i])  # prefill takes one length a call
        if n != len(want[i]):
            problems.append(f"{what} request {i}: {n} tokens")
            continue
        lg = teacher_forced_logits(
            cfg, params, [prompts[i]],
            np.asarray(got[i][:-1], np.int64)[:, None],
            TOKEN_MAX_LEN).cpu().numpy()
        bound = TEACHER_FORCED_BOUND * float(np.abs(lg).max())
        margins = token_margins(lg, np.asarray(got[i], np.int64)[:, None])
        res["greedy_margins"].append({"request": i, "bound": bound,
                                      **margins})
        if margins["largest_gap"] > bound:
            problems.append(f"{what} request {i}: a served token sits "
                            f"{margins['largest_gap']} below the "
                            f"teacher-forced top, over {bound}")
    return res, problems


def _vision_launches(forwards) -> dict:
    """A rank's launches over ``forwards`` forwards of its rows: the m2q
    path's 42 / 20 / 14 / 14 each."""
    return {"m2q_matmul": 42 * forwards, "dwconv_w4": 20 * forwards,
            "relu_attn": 14 * forwards, "relu_attn_scales": 14 * forwards}


def run_sharded(torch, out_dir, card) -> Counter:
    """Phase 16, sharded serving: two ranks on ``cuda:0`` (gloo; NCCL
    refuses two ranks on one card) in child processes
    (:func:`sharded_child`), against this process's unsharded eager
    engines on the same artifacts and inputs.  (a) B1 R224 m2q-w8a8
    data-parallel (data=2): every rank's logits equal the unsharded
    engine's on the same batches (8, then 4) at zero tolerance -- each
    rank runs 4 / 2 rows and relu_attn's scales are max-reduced over
    data -- with 42 / 20 / 14 / 14 launches a forward on each rank.  (b)
    qwen1.5-0.5b int8-KV ``token`` tensor-parallel (model=2: 8 of 16
    heads, FFN 1408 of 2816 columns, lm_head 75968 of 151936 on each
    rank), each rank's engine driven by a ``ServingDaemon``: every leaf
    placed as its spec says; both daemons shut down with the ranks
    released; both ranks serve the same tokens; each greedy token is the unsharded engine's, or sits within
    TEACHER_FORCED_BOUND of the top of the unsharded kernel model's
    teacher-forced logits (row-parallel sums reorder f32 additions); a
    sampled request equals the unsharded one's, or follows it up to a
    first differing draw (a near-tie moved; reported); launches as
    phase 6 counts them, on each rank.  (c) dbrx-132b expert-parallel
    and (d) recurrentgemma-9b (3 layers, drawn here and saved) on
    model=2, against this process's unsharded eager engines: dbrx's MoE
    layer on the probe equal at zero tolerance on each rank, both ranks
    the same tokens, greedy tokens within the teacher-forced bound
    (:func:`greedy_problems`), the local heads and experts, and each
    rank's launches what :func:`tree_launches` counts for its tree (E /
    2 experts).  Returns both ranks' launches."""
    import os
    import socket
    import numpy as np
    from repro_torch import kernels, recipe
    from repro_torch.launch.daemon import (TEACHER_FORCED_BOUND,
                                           teacher_forced_logits)
    t0 = time.perf_counter()
    res = {"ranks": SHARD_RANKS, "card": card}
    # the unsharded references, eager, on the same artifacts
    vqm = recipe.QuantizedModel.load(ARTIFACTS / "m2q-w8a8", device="cuda")
    images = shard_images(vqm.cfg)
    veng = vqm.serve(max_batch=BATCH, max_delay_ms=50.0, graphs=False)
    ref = {}
    for rep in ("warm", "timed"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handles = [veng.submit(img) for img in images]
        poll_until_done(veng, handles, "phase 16 reference")
        torch.cuda.synchronize()
        res[f"unsharded_vision_{rep}_s"] = time.perf_counter() - t1
        ref[rep] = np.stack([h.result() for h in handles])
    del veng, vqm
    tqm = recipe.QuantizedModel.load(ARTIFACTS / "token", device="cuda")
    cfg = tqm.cfg
    reqs = token_requests(cfg)
    teng = tqm.serve(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN, seed=0,
                     graphs=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    handles = [teng.submit(p, max_new_tokens=n, temperature=t)
               for p, n, t in reqs]
    teng.run()
    torch.cuda.synchronize()
    res["unsharded_token_s"] = time.perf_counter() - t1
    want = [h.handle.result() for h in handles]
    del teng
    # (c) / (d): phase 11's dbrx artifact, and recurrentgemma drawn on the
    # card (init from seed 0, w4-weights-only) and saved for the ranks;
    # each served eagerly, unsharded, and dbrx's MoE layer 0 on the probe
    refs = {}
    for key, ccfg, art in shard_cases():
        t1 = time.perf_counter()
        if key == "recurrent":
            sqm, res["recurrent_drawn"] = pool_quantize(torch, ccfg,
                                                        "w4-weights-only")
            sqm.save(ARTIFACTS / art)
        else:
            sqm = recipe.QuantizedModel.load(ARTIFACTS / art, device="cuda")
        res[f"unsharded_{key}_build_s"] = time.perf_counter() - t1
        layer = (moe_layer_out(torch, sqm.cfg, sqm.params) if key == "moe"
                 else None)
        prompts = shard_prompts(sqm.cfg)
        seng = sqm.serve(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN,
                         seed=0, graphs=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        handles = [seng.submit(p, max_new_tokens=POOL_NEW) for p in prompts]
        seng.run()
        torch.cuda.synchronize()
        res[f"unsharded_{key}_s"] = time.perf_counter() - t1
        refs[key] = (sqm, prompts, [h.handle.result() for h in handles],
                     layer)
        del seng
    torch.cuda.empty_cache()
    res["reference_s"] = time.perf_counter() - t0

    # the two ranks
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    work = ARTIFACTS / "sharded"
    work.mkdir(parents=True, exist_ok=True)
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(SRC), str(ROOT)])}
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.sharded_child()", str(r), str(port), str(work)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(SHARD_RANKS)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=SHARD_WAIT))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"phase 16: a rank did not finish in {SHARD_WAIT} s")
    res["children_s"] = time.perf_counter() - t1
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        print(f"phase 16 rank {r} output: {o.strip()[-1500:]}", flush=True)
        if p.returncode != 0:
            fail(f"phase 16: rank {r} ended rc {p.returncode}: {e[-3000:]}")
    ranks = [json.loads((work / f"sharded_rank{r}.json").read_text())
             for r in range(SHARD_RANKS)]
    problems = []
    launches = Counter()
    # (a) vision
    for r, rk in enumerate(ranks):
        for rep in ("warm", "timed"):
            got = np.load(work / f"sharded_vision_{r}_{rep}.npy")
            if not np.array_equal(got, ref["warm"]):
                problems.append(
                    f"(a) rank {r} {rep}: logits differ from the unsharded "
                    f"engine's by {float(np.abs(got - ref['warm']).max())}")
            counts = rk[f"vision_{rep}_counts"]
            expect = _vision_launches(2)  # its rows of 8, then of 4
            for kname, c in counts.items():
                if c["launches"] != expect.get(kname, 0) \
                        or c["plain_calls"]:
                    problems.append(f"(a) rank {r} {rep}: {kname} {c}, "
                                    f"expected {expect.get(kname, 0)}")
            launches.update({k: c["launches"] for k, c in counts.items()})
        if rk["vision_buckets"] != [4, 8]:
            problems.append(f"(a) rank {r}: buckets {rk['vision_buckets']}")
    # (b) token
    if ranks[0]["token"] != ranks[1]["token"]:
        problems.append("(b) the two ranks served different tokens")
    tb = {"placement": ranks[0]["placement"], "cache": ranks[0]["cache"],
          "local_heads": ranks[0]["local_heads"]}
    for r, rk in enumerate(ranks):
        if rk["placement"]["problems"] or not rk["placement"]["sharded"]:
            problems.append(f"(b) rank {r} placement: {rk['placement']}")
        if not rk["released"]:
            problems.append(f"(b) rank {r}: its daemon ended with the "
                            "ranks not released")
        steps, groups = rk["token_steps"]
        expect = token_launches(cfg, "token", steps, groups)
        for kname, c in rk["token_counts"].items():
            if c["launches"] != expect.get(kname, 0) or c["plain_calls"]:
                problems.append(f"(b) rank {r}: {kname} {c}, expected "
                                f"{expect.get(kname, 0)}")
        launches.update({k: c["launches"]
                         for k, c in rk["token_counts"].items()})
    got = ranks[0]["token"]
    greedy_off = [i for i, (p, n, t) in enumerate(reqs)
                  if t == 0.0 and got[i] != want[i]]
    sampled = [i for i, (p, n, t) in enumerate(reqs) if t > 0.0]
    tb["greedy_equal"] = sum(1 for i, (p, n, t) in enumerate(reqs)
                             if t == 0.0 and got[i] == want[i])
    tb["greedy_differing"] = greedy_off
    rows = []
    if greedy_off:
        steps = max(len(got[i]) for i in greedy_off) - 1
        forced = np.zeros((steps, len(greedy_off)), np.int64)
        for j, i in enumerate(greedy_off):
            forced[:len(got[i]) - 1, j] = got[i][:-1]
        lg = teacher_forced_logits(cfg, tqm.params,
                                   [reqs[i][0] for i in greedy_off], forced,
                                   TOKEN_MAX_LEN).cpu().numpy()
        bound = TEACHER_FORCED_BOUND * float(np.abs(lg).max())
        for j, i in enumerate(greedy_off):
            n = len(got[i])
            served = np.asarray(got[i], np.int64)[:, None]
            margins = token_margins(lg[:n, j:j + 1], served)
            rows.append({"request": i, "bound": bound, **margins})
            if margins["largest_gap"] > bound:
                problems.append(f"(b) request {i}: a served token sits "
                                f"{margins['largest_gap']} below the "
                                f"teacher-forced top, over {bound}")
    tb["greedy_margins"] = rows
    tb["sampled"] = []
    for i in sampled:
        a, b = got[i], want[i]
        first = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        tb["sampled"].append({"request": i, "equal": a == b,
                              "first_difference": first})
        if len(a) != len(b) or not all(0 <= x < cfg.vocab_size for x in a):
            problems.append(f"(b) sampled request {i}: {len(a)} tokens")
    generated = sum(len(t) for t in got)
    # (c) / (d)
    for key, _, _ in shard_cases():
        sqm, prompts, swant, layer = refs[key]
        scfg = sqm.cfg
        what = f"({'c' if key == 'moe' else 'd'}) {scfg.name}"
        sub = {"local": ranks[0][f"{key}_local"]}
        heads = (scfg.n_heads // SHARD_RANKS,
                 scfg.n_kv_heads // SHARD_RANKS
                 if scfg.n_kv_heads % SHARD_RANKS == 0 else scfg.n_kv_heads)
        lcfg = scfg
        if key == "moe":
            lcfg = scfg.replace(moe_experts=scfg.moe_experts // SHARD_RANKS)
            sub["layer_max_abs_diff"] = []
            for r in range(SHARD_RANKS):
                lay = np.load(work / f"sharded_moe_layer_{r}.npy")
                sub["layer_max_abs_diff"].append(
                    float(np.abs(lay - layer).max()))
                if not np.array_equal(lay, layer):
                    problems.append(f"{what} rank {r}: the MoE layer differs "
                                    "from the unsharded one by "
                                    f"{sub['layer_max_abs_diff'][-1]}")
        sgot = ranks[0][f"{key}_tokens"]
        for r, rk in enumerate(ranks):
            if rk[f"{key}_tokens"] != sgot:
                problems.append(f"{what}: rank {r} served other tokens than "
                                "rank 0")
            loc = rk[f"{key}_local"]
            if (loc["n_heads"], loc["n_kv_heads"]) != heads or (
                    key == "moe" and loc["experts"] != lcfg.moe_experts):
                problems.append(f"{what} rank {r}: local {loc}")
            steps, groups = rk[f"{key}_steps"]
            expect = tree_launches(SimpleNamespace(
                cfg=lcfg, report=sqm.report, params=sqm.params), steps,
                groups)
            for kname, c in rk[f"{key}_counts"].items():
                if c["launches"] != expect.get(kname, 0) or c["plain_calls"]:
                    problems.append(f"{what} rank {r}: {kname} {c}, "
                                    f"expected {expect.get(kname, 0)}")
            launches.update({k: c["launches"]
                             for k, c in rk[f"{key}_counts"].items()})
        more, bad = greedy_problems(torch, scfg, sqm.params, prompts, sgot,
                                    swant, what)
        problems += bad
        sgen = sum(len(t) for t in sgot)
        sub.update(more, tokens=sgen,
                   tokens_per_s_sharded=sgen / ranks[0][f"{key}_s"],
                   tokens_per_s_unsharded=sum(len(t) for t in swant)
                   / res[f"unsharded_{key}_s"],
                   seconds=[rk[f"{key}_s"] for rk in ranks],
                   load_s=[rk[f"{key}_load_s"] for rk in ranks],
                   steps=ranks[0][f"{key}_steps"],
                   counts_per_rank=[rk[f"{key}_counts"] for rk in ranks])
        res[key] = sub
    r0 = ranks[0]
    res.update(
        backend=r0["backend"], join_s=[rk["join_s"] for rk in ranks],
        vision={"images_per_s_sharded": N_IMAGES / r0["vision_timed_s"],
                "images_per_s_unsharded": N_IMAGES
                / res["unsharded_vision_timed_s"],
                "seconds": [rk["vision_timed_s"] for rk in ranks],
                "load_s": [rk["vision_load_s"] for rk in ranks],
                "counts_per_rank": [rk["vision_timed_counts"]
                                    for rk in ranks]},
        token=dict(tb, tokens=generated,
                   tokens_per_s_sharded=generated / r0["token_s"],
                   tokens_per_s_unsharded=sum(len(t) for t in want)
                   / res["unsharded_token_s"],
                   seconds=[rk["token_s"] for rk in ranks],
                   load_s=[rk["token_load_s"] for rk in ranks],
                   steps=r0["token_steps"],
                   counts_per_rank=[rk["token_counts"] for rk in ranks]),
        child_wall_s=[rk["wall_s"] for rk in ranks],
        phase_s=time.perf_counter() - t0)
    (out_dir / "chip_smoke_sharded.json").write_text(json.dumps(res, indent=1))
    print("phase 16:", json.dumps(res), flush=True)
    if problems:
        fail("phase 16: " + "; ".join(problems)[:3000])
    print(f"phase 16: {SHARD_RANKS} ranks, backend {res['backend']}, "
          f"{res['phase_s']:.1f} s; vision {res['vision']['images_per_s_sharded']:.1f}"
          f" images/s sharded eager vs {res['vision']['images_per_s_unsharded']:.1f}"
          f" unsharded; token {res['token']['tokens_per_s_sharded']:.1f} "
          f"tokens/s sharded eager vs {res['token']['tokens_per_s_unsharded']:.1f}"
          f" unsharded; {card}", flush=True)
    for key in ("moe", "recurrent"):
        sub = res[key]
        rank0 = {k: c["launches"] for k, c in sub["counts_per_rank"][0].items()
                 if c["launches"]}
        print(f"phase 16 {key}: {sub['tokens_per_s_sharded']:.1f} tokens/s "
              f"sharded eager vs {sub['tokens_per_s_unsharded']:.1f} "
              f"unsharded, {sub['greedy_equal']} of {POOL_REQUESTS} greedy "
              f"requests equal, rank 0 launches {json.dumps(rank0)}; "
              f"{card}", flush=True)
    del tqm, refs
    torch.cuda.empty_cache()
    return launches


# ---- phase 17: the paper's accuracy tables, Table III's other models -------
# (c): the EfficientViTs of Table III beside B1 R224, at full width
TABLE3_MODELS = ("efficientvit-b1-r256", "efficientvit-b1-r288",
                 "efficientvit-b2-r224")
TABLE3_CALIB = 2   # SyntheticVision batches of BATCH images at each res


def _sha256(path) -> str:
    import hashlib
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def run_tables(torch, out_dir, card, calls_by_model) -> Counter:
    """(a) Tables I-IV on the card over the committed proxy, held against
    the JAX package's rows (``results/proxy_tables_jax.json``) by
    ``launch.tables.reference_check``: every replaced leaf's sha256
    equal to JAX's but for PoT elements at a rounding tie of log2
    (counted), every mixed leaf's Eq. 6 split equal (or flipped filters
    within float noise of one penalty, reported), at most
    PROXY_MISMATCHES predictions differing a row; top-1 printed beside
    JAX's.  (b) ``data.proxy.train_proxy`` on the card (300 steps of 32
    images from a seeded init) into ``chiprun_out``: the loss must fall,
    the committed proxy stay unchanged and the written file reload as
    the trained tree; its float top-1 and Table I printed, the schemes'
    ordering reported.  (c) :func:`run_path` over each of
    ``TABLE3_MODELS`` at full width under m2q-w8a8, calibrated on
    TABLE3_CALIB SyntheticVision batches at the config's resolution:
    m2q_matmul, dwconv_w4, relu_attn and relu_attn_scales launched as
    the forward's calls count them, no plain call, graph-served logits
    equal to eager ones and eager ones to the plain-version forward's,
    at zero tolerance."""
    import numpy as np
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data import proxy
    from repro_torch.data.pipeline import SyntheticVision
    from repro_torch.launch import tables

    t_phase = time.perf_counter()
    res = {}
    # (a)
    expected = json.loads(tables.EXPECTED.read_text())
    committed = _sha256(proxy.CACHE)
    if committed != expected["proxy_sha256"]:
        fail("phase 17 (a): the committed proxy is not the one "
             f"{tables.EXPECTED.name} was written from")
    params = proxy.load_proxy("cuda")
    t0 = time.perf_counter()
    rows = tables.run(params)
    torch.cuda.synchronize()
    res["a_rows_s"] = time.perf_counter() - t0
    if not np.array_equal(proxy.predict(params, attn="f32")[1],
                          np.array(expected["labels"])):
        fail("phase 17 (a): the images' labels differ from the JSON's")
    reports, failures = tables.reference_check(rows, expected, params,
                                               PROXY_MISMATCHES)
    for rep in reports:
        print("phase 17 (a)", json.dumps(rep), flush=True)
    if failures:
        fail("phase 17 (a): " + "; ".join(failures)[:3000])
    res["a"] = [{k: rep[k] for k in ("name", "top1", "jax_top1", "drop",
                                     "predictions_differing", "ties")}
                for rep in reports]
    res["a_ties"] = sum(rep["ties"] for rep in reports)
    res["a_flipped"] = {rep["name"]: rep["flipped"] for rep in reports
                        if rep["flipped"]}
    del rows, params

    # (b)
    trained_path = out_dir / "chip_smoke_proxy_trained.npz"
    trained_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    trained, losses = proxy.train_proxy(trained_path, device="cuda", seed=0)
    torch.cuda.synchronize()
    res["b_train_s"] = time.perf_counter() - t0
    first, last = np.mean(losses[:30]), np.mean(losses[-30:])
    problems = []
    if not np.all(np.isfinite(losses)) or not last < first:
        problems.append(f"the loss did not fall: first 30 steps {first}, "
                        f"last 30 {last}")
    if _sha256(proxy.CACHE) != committed:
        problems.append("train_proxy changed the committed proxy")
    reloaded = proxy.load_proxy("cuda", path=trained_path)
    from repro_torch.core.tree import leaves_with_path
    if not all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_path(trained), leaves_with_path(reloaded))):
        problems.append("the written proxy does not reload as trained")
    if problems:
        fail("phase 17 (b): " + "; ".join(problems))
    rows_b = tables.run(reloaded, tables=("table1",))
    res["b"] = dict(steps=len(losses), loss_first=losses[0],
                    loss_last=losses[-1], loss_first_30=float(first),
                    loss_last_30=float(last),
                    table1=[{"name": r.name, "top1": r.top1, "drop": r.drop}
                            for r in rows_b],
                    ordering=[r.name for r in sorted(
                        rows_b[1:], key=lambda r: -r.top1)])
    print("phase 17 (b)", json.dumps(res["b"]), flush=True)
    trained_path.unlink(missing_ok=True)
    del trained, reloaded, rows_b

    # (c)
    launches = Counter()
    res["c"] = {}
    for name in TABLE3_MODELS:
        cfg = ARCHS[name]
        ds = SyntheticVision(10, cfg.img_res)
        calib = [ds.batch(30_000 + i, BATCH)[0] for i in range(TABLE3_CALIB)]
        t0 = time.perf_counter()
        counts = run_path(torch, cfg, "m2q-w8a8", calls_by_model[name],
                          out_dir, full=False, calib_batches=calib)
        res["c"][name] = {"s": time.perf_counter() - t0,
                          "launches": {k: c["launches"]
                                       for k, c in counts.items()
                                       if c["launches"]}}
        launches.update({k: c["launches"] for k, c in counts.items()})
    res["phase_s"] = time.perf_counter() - t_phase
    (out_dir / "chip_smoke_tables.json").write_text(json.dumps(res, indent=1))
    print(f"phase 17: {res['phase_s']:.1f} s, {res['a_ties']} PoT ties; "
          f"{card}", flush=True)
    return launches


# ---- phase 18: qlint over the port's op graphs -----------------------------

QLINT_BASELINE = ROOT / "results" / "qlint_baseline_torch.json"


def qlint_problems(traces, base, ran: str = "kernel"):
    """Phase 18's gate over recorded traces: ``(ledger, problems, rows)``
    -- the traces' qlint ledger, what keeps it from equalling ``base``
    (a NEW or GREW line, a GONE line) and every kernel node that did not
    run ``ran`` (on the card: its kernel), and per trace its verdict
    counts and kernel nodes."""
    from repro_torch.analysis import baseline as bl
    from repro_torch.analysis import run_rules
    violations, problems, rows = [], [], {}
    for tr in traces:
        vs, supp = run_rules(tr)
        violations += vs
        nodes = tr.graph.kernel_nodes()
        errors = sum(v.severity == "error" for v in vs)
        rows[tr.name] = {"errors": errors, "warns": len(vs) - errors,
                         "suppressed": len(supp),
                         "kernel_nodes": dict(Counter(n.op for n in nodes)),
                         "ops": len(tr.graph.nodes)}
        other = Counter(f"{n.op} ran {n.ran}" for n in nodes
                        if n.ran != ran)
        problems += [f"{tr.name}: {k} node(s) {what}"
                     for what, k in sorted(other.items())]
    ledger = bl.to_ledger(violations)
    problems += bl.diff(ledger, base) + bl.improvements(ledger, base)
    return ledger, problems, rows


def run_qlint(torch, out_dir, card) -> Counter:
    """Phase 18: ``launch.qlint``'s sweep on the card -- DEFAULT_SWEEP
    at REDUCED width and the sharded qwen decode on two gloo ranks of
    the card (its child processes started first, beside the sweep) --
    gated by :func:`qlint_problems` against the CPU's committed ledger.
    Returns the sweep's launches and both ranks'."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import kernels
    from repro_torch.analysis import baseline as bl
    from repro_torch.analysis.traces import (DEFAULT_SWEEP, registry_traces,
                                             sharded_decode_trace)
    t0 = time.perf_counter()
    base = bl.load(QLINT_BASELINE)
    res = {"card": card, "config_s": {}}
    with ThreadPoolExecutor(1) as pool:
        sharded = pool.submit(sharded_decode_trace, "qwen1.5-0.5b",
                              n_data=1, n_model=2, device="cuda")
        kernels.reset_counts()
        traces = []
        for arch in DEFAULT_SWEEP:
            t = time.perf_counter()
            traces += registry_traces(arch, device="cuda")
            res["config_s"][arch] = time.perf_counter() - t
        counts = kernels.counts()
        res["sweep_s"] = time.perf_counter() - t0
        traces.append(sharded.result())
    res["sharded_s"] = time.perf_counter() - t0
    ledger, problems, rows = qlint_problems(traces, base)
    launches = Counter({k: c["launches"] for k, c in counts.items()})
    for rank in traces[-1].meta["rank_launches"]:
        launches.update(rank)
    res.update(rows=rows, ledger=ledger, launches=dict(launches),
               plain_calls={k: c["plain_calls"] for k, c in counts.items()
                            if c["plain_calls"]},
               phase_s=time.perf_counter() - t0)
    (out_dir / "chip_smoke_qlint.json").write_text(json.dumps(res, indent=1))
    for name, row in rows.items():
        print(f"phase 18 trace {name}: {json.dumps(row)}", flush=True)
    print(f"phase 18: {len(traces)} traces, "
          f"{sum(len(p) for t in ledger.values() for p in t.values())} "
          f"ledger entries; sweep {res['sweep_s']:.1f} s, sharded trace "
          f"done at {res['sharded_s']:.1f} s, phase {res['phase_s']:.1f} s; "
          f"launches {json.dumps(dict(launches))}; plain calls outside "
          f"kernel nodes {json.dumps(res['plain_calls'])}; {card}",
          flush=True)
    if problems:
        fail("phase 18: the card's qlint ledger or kernel nodes: "
             + "; ".join(problems)[:3000])
    return launches


class PhaseClock:
    """Each phase's wall seconds, and the autotuner's probes and tuning
    seconds within it (the lazy tuning of its eager calls), printed and
    rewritten to ``chip_smoke_phases.json`` after every phase, so a run
    that fails still leaves its timeline."""

    def __init__(self, out_dir):
        from repro_torch.kernels import autotune
        self.autotune = autotune
        self.path = out_dir / "chip_smoke_phases.json"
        self.rows = {}
        self.t0 = self.t = time.perf_counter()
        autotune.reset_probe_count()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.rows[name] = {"s": now - self.t, "run_s": now - self.t0,
                           "probes": self.autotune.tuning_probe_count(),
                           "tuning_s": self.autotune.tuning_seconds()}
        self.autotune.reset_probe_count()
        self.t = now
        self.path.write_text(json.dumps(self.rows, indent=1))
        print(f"phase timing {name}: {json.dumps(self.rows[name])}",
              flush=True)


def main() -> None:
    import torch  # the card check needs torch before anything else

    # ---- 1. card --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_card.txt").write_text(card + "\n")
    # the port's autotune cache: a fresh file for this run (phase 15)
    import os
    tuned = out_dir / AUTOTUNE_CACHE
    for stale in (tuned, Path(f"{tuned}.empty.json")):
        stale.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tuned)
    clock = PhaseClock(out_dir)

    # ---- 2. build -------------------------------------------------------
    from repro_torch.kernels import autotune, build
    t0 = time.perf_counter()
    print(build.build_all(), flush=True)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    clock.lap("2 build")

    # ---- 3. kernel checks at the recipe paths' shapes ---------------------
    import numpy as np
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS["efficientvit-b1-r224"]
    calls = main_path_calls(cfg, BATCH)
    m2q_calls, dw_calls, attn_calls = calls
    r = -(-cfg.img_res // 2)
    stem_call = ("stem/w", BATCH * r * r, 27, cfg.widths[0])
    print(f"per forward: {len(m2q_calls)} dense, {len(dw_calls)} dwconv, "
          f"{len(attn_calls)} attention calls; stem {stem_call}", flush=True)
    # phase 17 (c): Table III's other EfficientViTs, each its own path
    table3 = {name: main_path_calls(ARCHS[name], BATCH)
              for name in TABLE3_MODELS}
    vision = {"m2q-w8a8": calls, **{f"{name} m2q-w8a8": c
                                    for name, c in table3.items()}}
    qwen = ARCHS["qwen1.5-0.5b"]
    lm_head_call = ("lm_head", TOKEN_BATCH, qwen.d_model, qwen.padded_vocab)
    pool = [(name, ARCHS[name]) for name in LM_POOL]
    # the MoE LMs at phase 11's depth
    moe_lms = [(name, ARCHS[name].replace(n_layers=layers))
               for name, layers, _ in MOE_CASES]
    # the recurrent LMs' lm_heads (phase 12): rwkv6-3b 2560 x 65536,
    # recurrentgemma-9b 4096 x 256000
    recurrent = [(name, ARCHS[name]) for name in ("rwkv6-3b",
                                                  "recurrentgemma-9b")]
    pool_heads = {f"{name} lm_head": [("lm_head", TOKEN_BATCH, c.d_model,
                                       c.padded_vocab)]
                  for name, c in pool + moe_lms[:1] + recurrent}
    rng = np.random.default_rng(0)
    tallies = [check_m2q(torch, rng, {
                   **{path: c[0] for path, c in vision.items()},
                   **token_m2q_calls(qwen, TOKEN_BATCH, PREFILL_LEN),
                   **token_m2q_calls(ARCHS["minitron-4b"], TOKEN_BATCH,
                                     POOL_PREFILL_LEN, "minitron-4b mixed"),
                   **moe_m2q_calls(moe_lms[1][1], TOKEN_BATCH,
                                   POOL_PREFILL_LEN, "dbrx-132b"),
                   # phase 16 (c): a model rank's heads and lm_head
                   **shard_m2q_calls(moe_lms[1][1], TOKEN_BATCH,
                                     POOL_PREFILL_LEN,
                                     "dbrx-132b model-shard"),
                   **rwkv_m2q_calls(recurrent[0][1], TOKEN_BATCH,
                                    (2, RECURRENT_LENGTHS[-1]),
                                    "rwkv6-3b mixed")}),
               check_dwconv(torch, rng, {p: c[1] for p, c in vision.items()}),
               check_attn(torch, rng, {p: c[2] for p, c in vision.items()}),
               check_scales(torch, rng,
                            {p: c[2] for p, c in vision.items()}),
               check_int8(torch, rng, {"uniform8": m2q_calls,
                                       "int8-stem": [stem_call]}),
               check_weights_only(torch, rng, "int4_matmul",
                                  {"w4-weights-only": m2q_calls,
                                   "qwen-decode-step": [lm_head_call],
                                   # phase 16: a model rank's lm_head
                                   "qwen model-shard decode step": [(
                                       "lm_head", TOKEN_BATCH, qwen.d_model,
                                       qwen.padded_vocab // SHARD_RANKS)],
                                   # phase 16 (d)
                                   "recurrentgemma-9b model-shard decode "
                                   "step": [(
                                       "lm_head", TOKEN_BATCH,
                                       recurrent[1][1].d_model,
                                       recurrent[1][1].padded_vocab
                                       // SHARD_RANKS)],
                                   **pool_heads}),
               check_weights_only(torch, rng, "apot_matmul",
                                  {"weights-only-apot": m2q_calls}),
               check_decode_attn(torch, rng, qwen.n_layers,
                                 pool + moe_lms + [
                                     (f"{name} model-shard", c.replace(
                                         n_heads=c.n_heads // SHARD_RANKS,
                                         n_kv_heads=c.n_kv_heads
                                         // SHARD_RANKS))
                                     for name, c in (("qwen1.5-0.5b", qwen),
                                                     moe_lms[1])])]
    detail = {t.name: t.rows for t in tallies}
    (out_dir / "chip_smoke_kernels.json").write_text(
        json.dumps(detail, indent=1))
    for t in tallies:
        for row in t.rows:
            print(t.name, json.dumps(row), flush=True)
        print(f"{t.name} per forward: {json.dumps(t.total)}", flush=True)
        for path, total in t.by_path.items():
            print(f"{t.name} per {path} forward: {json.dumps(total)}",
                  flush=True)
    print("kernels:", ", ".join(t.name for t in tallies), flush=True)
    clock.lap("3 kernel checks")

    launches = Counter()
    try:  # fail() exits through here too: no artifact stays behind
        # phases 4-14 resolve plans from the (empty) cache or launch_plan
        # and never tune: their kernels run launch_plan's plans, the ones
        # phase 3 times (PERF.md, PR 31: what tuning them lazily cost)
        with autotune.no_tuning():
            # ---- 4./5. the recipe paths, each read from zeroed counters --
            for name in PATHS:
                counts = run_path(torch, cfg, name, calls, out_dir,
                                  full=name in ("m2q-w8a8", "uniform8"))
                launches.update({k: c["launches"]
                                 for k, c in counts.items()})
            clock.lap("4-5 recipe paths")

            # ---- 6. the token paths, each read from zeroed counters -------
            for name in ("token", "token-m2q"):
                counts = run_token_path(torch, out_dir, name)
                launches.update({k: c["launches"]
                                 for k, c in counts.items()})
            clock.lap("6 token paths")

            # ---- 7. the trained proxy's artifact, from zeroed counters ----
            counts = run_proxy(torch, out_dir)
            launches.update({k: c["launches"] for k, c in counts.items()})
            clock.lap("7 proxy")

            # ---- 8.-14., each part from zeroed counters -------------------
            for name, run in (("8 runtime", run_runtime),
                              ("9 supervised", run_supervised),
                              ("10 lm pool", run_lm_pool),
                              ("11 moe", run_moe),
                              ("12 recurrent", run_recurrent),
                              ("13 whisper", run_whisper),
                              ("14 training", run_training)):
                launches.update(run(torch, out_dir, card))
                clock.lap(name)

        # ---- 15. kernel dispatch and autotuning -----------------------------
        launches.update(run_autotune(torch, out_dir, card))
        clock.lap("15 autotune")

        # ---- 16. sharded serving, two ranks on the card ---------------------
        with autotune.no_tuning():
            launches.update(run_sharded(torch, out_dir, card))
        clock.lap("16 sharded")

        # ---- 17. accuracy tables, Table III's models, from zeroed counters --
        with autotune.no_tuning():
            launches.update(run_tables(torch, out_dir, card, table3))
        clock.lap("17 tables")

        # ---- 18. qlint over the port's op graphs, from zeroed counters ------
        launches.update(run_qlint(torch, out_dir, card))
        clock.lap("18 qlint")
    finally:
        import shutil
        shutil.rmtree(ARTIFACTS, ignore_errors=True)
    print(f"chip_smoke total: {time.perf_counter() - clock.t0:.1f} s from "
          f"the build's start; {card}", flush=True)

    # ---- results --------------------------------------------------------
    replaces = {"m2q_matmul": "src/repro/kernels/m2q_matmul.py:80",
                "dwconv_w4": "src/repro/kernels/dwconv_w4.py:107",
                "relu_attn": "src/repro/kernels/relu_attn.py:74",
                # the three reductions XLA fuses ahead of that pallas_call
                "relu_attn_scales": "src/repro/kernels/ops.py:649",
                "int8_matmul": "src/repro/kernels/int8_matmul.py:53",
                "int4_matmul": "src/repro/kernels/int4_matmul.py:47",
                "apot_matmul": "src/repro/kernels/apot_matmul.py:56",
                "decode_attn_int8":
                    "src/repro/kernels/decode_attn_int8.py:60"}
    entries = [t.entry(replaces[t.name], launches[t.name],
                       library=t.name not in ("relu_attn",
                                              "relu_attn_scales",
                                              "decode_attn_int8"))
               for t in tallies]
    print(card, flush=True)  # again, beside the results it qualifies
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
