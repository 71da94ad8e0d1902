#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repo root, on a machine with one H100

Phases (each prints its own line; any failure ends the run with a non-zero
exit and no result line):

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — nvcc builds the four kernels from ``src/repro_torch/csrc``
     and prints the registers and spills (``-Xptxas -v``) of the
     tensor-core kernels (the int paths of ``lut_mpgemm`` and
     ``fused_lut_mpgemm``, their float-table paths, and ``dequant_mpgemm``)
     and their IMMA / HMMA count in the SASS (cuobjdump, where the toolkit
     has it; a kernel with none fails the run), and those of
     ``table_precompute``'s kernels (the K = 4 vector path per groups a
     thread, the scalar path);
  3. kernels — each kernel against its plain torch version on the card, at
     the main path's shapes (M ∈ {4, 128}; (N, K) of tinyllama-1.1b's
     projections and head), every table_quant mode: per_row bit-exact; the
     bf16 tensor-core paths (the two LUT mpGEMMs' None / per_group tables,
     and dequant_mpgemm: values split into three bf16 terms that sum to
     them exactly, f32 sums; the plain versions' matmuls in IEEE f32, TF32
     off) within 1e-4 of the largest output and within rtol = atol = 1e-4
     of every output, and two calls bit-equal. Then the dequant op path:
     ``ops.dequant_mpgemm``, the kernel's only entry point (as in the
     reference, no serve step launches it), at the same ten shapes with its
     launches counted. Operands are padded as ``kernels.ops`` pads them:
     channels and K-groups to each kernel's own tile, rows only for the
     staged per_row path. The records of the tensor-core paths carry their
     plan: tile, K-step, split-K count S, blocks, shared memory and kernels
     per call (the bf16 paths' also their passes, the ring's stages as the
     library plans them, the max relative error and the elementwise and
     two-call checks). Device times with CUDA events
     (``time_ms``: L2 flushed before every launch, the host's queueing
     hidden behind a spin on the card): kernel, plain version, a bf16
     ``torch.matmul`` yardstick, and the bound (``bound``), for the
     mpGEMMs at both M, the two LUT mpGEMMs in all three table modes.
     ``table_precompute`` (``precompute_checks``) at M ∈ {4, 128}, K ∈
     {2048, 5632}: None, per_group, and per_row with the row scale given
     or computed in the same launch, values and scale bit-equal to the
     plain version, timed beside the closed-form row scale's torch kernels
     (``ops._closed_form_row_scale``), an f32 ``torch.matmul`` against the
     ±1 basis and the bound; its row-scale entry (``row_scale``) bit-equal
     to the closed form at M ∈ {1, 4, 16, 128}, timed beside it; and a
     4-byte torch kernel under the same timer (``launch_floor_ms``). Bounds:
       bytes = each input read once + each output written once (packed
               weights and their scales, activations or table, output);
       ops   = 2·M·N·K int8 for the two LUT mpGEMMs' per_row paths (the
               multiply-adds of the product; the one-hot T·CW contraction
               over G·E entries is the kernels' way of doing it, not work
               the function needs); for the bf16 paths the tensor-core
               operations they issue, 3 passes x 2·M·N·K bf16; plus
               M·G·E·(K-1) f32 adds of the table entries where the kernel
               builds them (the per-shape records in chip_smoke.json keep
               the count of the paths' IEEE f32 first versions, 2·M·N·K f32
               and the table adds, as ``bound_f32_ms``; the kernels line
               does not carry it);
       bound_ms = max(bytes / 3.35 TB/s, ops / peak of their type)
                  (``repro_torch.roofline.cost.bound``, ``hw``);
  4. serve   — full-width tinyllama-1.1b, W2 symmetric K=4, random weights
     from a fixed seed made on the card, served through the port's engine
     (lut_pallas, table_quant auto -> per_row, fusion auto, 4 requests with
     130-200 token prompts, 16 new tokens, prefill chunk 128, decode chunk
     8, greedy). Every kernel's launch count must be > 0 and host syncs per
     token <= 1/decode_chunk. After the timed serve, one decode step and
     one 128-token prefill chunk are profiled (torch.profiler): wall,
     device busy, idle share, CUDA kernels, device time by kernel, and the
     decode step's ``fused_lut_mpgemm`` time and kernels; launches are
     counted per wrapper, ``row_scale`` (the fused per_row path's row
     scale) beside the four kernels. One more decode chunk runs under
     torch's sync check and must launch exactly one fused kernel and one
     row scale per projection a step;
  5. parity  — a teacher-forced 128-token forward through the kernels
     (lut_pallas) and through the plain torch LUT path (lut_xla), both with
     per_row tables: the logits must be equal bit for bit, because every
     per_row projection is exact integer arithmetic with the same epilogue
     (phases 4 and 5 are one function, ``serve_and_parity``, which phase 8
     calls too; both print as ``serve:``);
  6. paged   — phase 4's model through the block-paged KV pool (block 16,
     96 blocks, 4 slots, max_seq 256): six requests sharing a 144-token
     system prompt, then two identical 160-token prompts (copy-on-write),
     16 greedy tokens each. Paged without prefix sharing must equal the
     dense engine's streams exactly; with sharing too, except a divergence
     at a near tie (top-2 logit margin <= 0.15), where that stream stops
     being compared. Reused prompt tokens must equal the sharing rule's
     count (879), with prefix hits, no evictions, only the prefix cache's
     own block refs left after the run, every LUT kernel launched, and a
     paged decode chunk free of host syncs.

  7. float   — phase 4's model and engine with float tables
     (``table_quant=None``; the per_group mode in the forward only): the
     serve of phase 4 (4 requests, 16 greedy tokens each), which must
     launch the f32 paths, the fused kernel in decode and the staged pair
     in prefill, with <= 1/decode_chunk host syncs per token; one decode
     step and one 128-token prefill chunk profiled as in phase 4 (CUDA
     kernels per step and per chunk among them), each with the launch
     counts set to 0 just before and read just after; and a
     teacher-forced 128-token forward through the kernels (lut_pallas) and
     the plain LUT path (lut_xla), with tests/test_torch_model.py's bounds:
     None within rtol = atol = 1e-3 of each logit; per_group with the
     greedy token equal at >= 90% of the positions, and its rtol = atol =
     5e-2 on each logit reported as met or missed beside a control (the
     plain path against itself, its T·CW summed over K in two halves),
     which misses it too at full width: INT8 codes flip at a last-bit
     difference near a rounding boundary, and 22 layers carry the flips.
  8. bitnet  — the paper's own model, full-width paper-bitnet-3b (26
     layers, d_model 3200, MHA 32/32 of head_dim 100, d_ff 8640, vocab
     32000), ternary weights (BitNet b1.58 absmean), per_row tables,
     lut_pallas, fusion auto, random weights from seed 0 made on the card
     layer by layer: (a) phase 3's checks and times at its shapes ((N, K)
     = (3200, 3200), (8640, 3200), (3200, 8640), (32000, 3200); ternary
     weights; K 8640 ends on a padded K-step) in every table mode and of
     ``dequant_mpgemm``: per_row bit-exact, the bf16 paths within
     1e-5 · Σ_k |a_k · w_k| + 1e-6 of each output (the sum over the plain
     version's operands: what reordering f32 sums can move at any output
     magnitude; the largest ratio to it is printed beside a control's, the
     plain product with each operand rounded once to bf16), and of
     ``table_precompute`` and ``row_scale`` at its K (3200, 8640); (b) the fused/staged choice (``ops.resolve_dispatch``)
     of each projection at M = 4 and 128, and of the shared tables; (c),
     (d) phases 4 and 5 on its model (``serve_and_parity``).
  9. decoding — the decoding modes on phase 4's model and prompts
     (``decoding_phase``; 16 new tokens a request): (a) one lut_pallas
     engine (dense, 4 slots) serves a beam:2 request and two greedy ones,
     with the launch counts set to 0 just before and read just after
     (every kernel of the per_row path must run), then one general decode
     chunk under torch's sync check must launch exactly one fused kernel
     and one row scale per projection a step; every output and every
     hypothesis (tokens and scores) must equal the same pool served under
     lut_xla, and a beam:1 request phase 4's greedy stream for its prompt;
     (b) the beam request through the block-paged pool (block 16) with
     prefix caching, twice: its hypotheses equal (a)'s, and after each
     retirement only the prefix cache's blocks are in use, as many as
     before the second admission; (c) self-speculation under lut_xla, spec
     k 4: a one-plane draft's greedy streams equal phase 4's, and the
     two-plane draft (every plane: the target) accepts >= 3 drafts a round
     with 0 extra weight bytes; the largest |diff| between the verify
     forward's position-0 logits and an s = 1 forward's is printed; (d)
     under lut_pallas a spec request raises the kernels' NotImplementedError
     (they refuse plane-sliced views, as the reference's do). Decode tok/s
     and host syncs per token (<= 1/decode_chunk) of each leg.
 10. telemetry — the engine's telemetry and the measured autotuner on
     phase 4's model, engine and requests (``telemetry_phase``): (a) phase
     4's serve with a ``Tracer`` (its torch.profiler annotation on) and a
     dispatch recorder, in turns with untraced serves (off, on, on, off):
     tokens and decode syncs equal phase 4's, the trace valid
     (``validate_chrome_trace``) with one ``decode_chunk`` span a sync and
     balanced request spans, every dispatch heuristic; the decode step's
     wall (the chunk histogram) with the tracer off and on; (b)
     ``pretune()`` of every projection shape at M = 4 and 128 (at most 4
     candidates, device time over 5 repeats), the winner's and the
     heuristic's time a shape, then the serve with ``fusion="tuned"`` from
     the saved cache: every dispatch tuned, tokens equal phase 4's; a
     decode step and a prefill chunk profiled auto / tuned / tuned / auto;
     (c) every per_row candidate bit-equal to the heuristic plan on the
     same operands, every float-table candidate within rtol = atol = 1e-4
     and 1e-4 of the largest output of the plain path.

 11. moe     — the MoE family, full-width olmoe-1b-7b (16 layers, d_model
     2048, MHA 16/16, 64 experts of d_ff 1024, top-8, vocab 50304), W2
     symmetric K=4 experts and head, float attention, per_row tables,
     lut_pallas, random weights from seed 0 made on the card layer by
     layer (``moe_phase``): (a) the expert axis of both LUT kernels
     (``lut_mpgemm_batched``, ``fused_lut_mpgemm_batched``: E experts'
     mpGEMMs in one launch) at E = 64, C ∈ {8, 24} rows an expert (a
     decode step's capacity and a 128-token prefill chunk's), (N, K) of
     gate/up and down, every table mode: per_row bit-exact against the
     plain version, the bf16 paths within phase 8 (a)'s bound, every mode
     bit-equal to 64 launches of the 2-D kernel on the same plan, one
     launch a call; timed as phase 3 times its kernels beside the 64 2-D
     launches, the plain version, a bf16 ``torch.bmm`` and the bound;
     (b) phase 4's engine and request shapes served with fusion auto (the
     default; every expert projection fused) and with fusion staged (the
     batched staged kernel), launch counts set to 0 before the pair and
     read after: every kernel of the path launched, equal tokens, <=
     1/decode_chunk host syncs a token; one auto decode chunk under
     torch's sync check launching exactly one batched fused kernel and
     one row scale per expert projection a step and one of each for the
     head; the fusion of each expert projection at C = 8 and 24; a
     decode step and a 128-token prefill chunk profiled as in phase 4;
     (c) a teacher-forced 128-token forward, lut_pallas vs lut_xla logits
     bit-equal; (d) phase 6's prompts through the paged pool without
     sharing equal to the dense engine's streams, then with prefix
     sharing once, its agreement with dense and the prompt tokens reused
     recorded (a suffix prefill routes fewer tokens, so its capacity and
     drops differ).
 12. ssm     — the SSM and hybrid families at full width (``ssm_phase``),
     random weights from seed 0 made on the card layer by layer, per_row
     tables, lut_pallas, fusion auto, depth cut (``SERVE_DEPTH``):
     falcon-mamba-7b (16 of its 64 Mamba1 layers, d_model 4096, d_inner
     8192, dt_rank 256, state 16, vocab 65024, every projection and the
     head W2) and zamba2-7b (13 of its 81 Mamba2 layers: 2 groups of 6 and
     a tail of 1, each group followed by one shared attention + MLP block,
     MHA 32/32, d_ff 14336, vocab 32000; the Mamba2 in/out projections
     float, the shared block and the head W2). (a)
     phase 3's checks and times (``check_kernels``, every table mode and
     ``dequant_mpgemm``, M ∈ {4, 128}) at their packed projections' (N,
     K): (16384, 4096), (288, 8192), (8192, 256), (4096, 8192), (65024,
     4096); (3584, 3584), (14336, 3584), (3584, 14336), (32000, 3584):
     per_row bit-exact, the bf16 paths within phase 8 (a)'s bound; and
     ``precompute_checks`` at their K; (b) falcon-mamba-7b through phase
     4's engine and request shapes (``family_serve``): the launch counts set
     to 0 just before the serve and read just after, every kernel of the
     per_row path launched, <= 1/decode_chunk host syncs a token, one
     decode chunk under torch's sync check launching exactly one fused
     lookup and one row scale per packed projection a step; lut_pallas =
     lut_xla teacher-forced logits bit for bit (``ssm_parity``); (c) the
     same prompts with prefill chunk 32 against 128 (a right-padded tail in
     both): equal greedy streams, or a divergence at a near tie (phase 6's
     top-2 margin rule); (d) zamba2-7b served as in (b), its parity, the
     block-paged pool (block 16: the shared attention's KV pooled, the
     Mamba state slot-resident) giving the dense streams exactly,
     ``prefix_cache=True`` turned off with the engine's warning, a
     ``spec`` request refused (ValueError: SSM state cannot rewind a
     draft); (e) one decode step and one 128-token prefill chunk of each
     profiled as in phase 4.
 13. xattn   — the VLM and audio families at full width (``xattn_phase``),
     random weights from seed 0 made on the card layer by layer, per_row
     tables, lut_pallas, fusion auto: llama-3.2-vision-11b (10 of its 40
     layers, ``SERVE_DEPTH``: 2 groups of 4 self layers and a gated cross
     layer, d_model 4096, GQA
     32/8, d_ff 14336, vocab 128256, 1601 image tokens; the gates, 0 after
     init, set to 0.5) and whisper-tiny (4 encoder and 4 decoder layers,
     d_model 384, 6 heads, d_ff 1536, vocab 51865, 1500 frames), every
     projection and the head W2. The stub frontends' inputs (image
     embeddings, audio frames) are normal draws × 0.1 made on the card.
     (e) first, on phase 12's models, which are freed after it: a beam:2
     request beside two greedy ones (``beam_legs``: 8 new tokens each)
     through falcon-mamba-7b and zamba2-7b under lut_pallas and lut_xla,
     and for zamba2 through the paged pool: equal streams and hypotheses.
     (a) phase 3's checks and times (``check_kernels``, every table mode
     and ``dequant_mpgemm``, M ∈ {4, 128}) at both models' packed (N, K):
     (4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (128256,
     4096); (384, 384), (1536, 384), (384, 1536), (51865, 384); per_row
     alone, staged and fused, at the served large M: 1601 at (1024, 4096)
     (the image K/V) and 1500 at whisper's three layer shapes (its
     encoder), with the path the fusion rule picks there; and
     ``precompute_checks`` at K 384 and 1536 (M ∈ {4, 128} and 1500) and
     at K 4096, M 1601. (b) the VLM through phase 4's engine and request
     shapes (``family_serve``: every kernel of the per_row path launched,
     one fused lookup and one row scale per packed projection a decode
     step under torch's sync check); teacher-forced 128-token forwards
     (``xattn_parity``) with the image embeddings and with tokens only
     over a zero image K/V (the engine's case: its requests carry tokens
     only, as the reference's do), lut_pallas = lut_xla bit for bit,
     finite; the image K/V alone: its 16 lookups (two a cross layer)
     counted by kernel on the path the rule picks, the plans from the
     dispatch recorder, its wall and device time; the paged pool (block
     16) giving the dense streams, ``prefix_cache=True`` turned off with
     the engine's warning, ``spec`` refused with ValueError
     (``paged_and_refusals``); a beam:2 request beside two greedy ones
     equal under lut_pallas, lut_xla and paged (``beam_legs``); (c) the
     same for whisper-tiny (its encoder and cross K/V alone: 32 lookups);
     (d) one decode step and one 128-token prefill chunk of each profiled
     as in phase 4.
 14. train   — the training path, after the earlier phases' models are
     freed (``train_phase``): (a) full-width tinyllama-1.1b, float params
     from seed 0 made on the card, trained 30 steps through
     ``training.train_loop.make_train_step`` with the QAT forward (W2
     symmetric fake-quant of every projection and the head), AdamW with
     ``lr_schedule(3e-4, warmup=20, total=30)``, batch 8, seq 256,
     ``SyntheticLM(seed=0)``, f32 activations (TF32 off): every loss and
     grad norm finite, the mean of the last 5 losses below the first 5's;
     tokens a second and ms a step over steps 2-30 by wall time (the
     checkpoint included), the median step, peak device memory; (b) its
     whole state checkpointed by ``RestartManager`` at step 20 (async,
     under the gitignored build directory, removed after), restored into a
     fresh state made from another seed, steps 21-30 rerun from the same
     data steps: losses, grad norms and final params bit-equal to the straight
     run (both under ``torch.use_deterministic_algorithms(True)``, with
     ``CUBLAS_WORKSPACE_CONFIG`` set at the top of this script); one more
     step profiled (busy, idle, GEMM time, device time by kernel); (c) the
     trained params packed (``quantize_params``) and served as phases 4 and
     5 serve (``serve_and_parity``: every kernel of the per_row path
     launched, lut_pallas = lut_xla logits bit for bit), and, as a record,
     the max |logit difference| between the QAT forward and the packed
     lut_xla forward.
 15. kvint8  — the int8 KV cache (``kv_cache_dtype="int8"``: int8 codes
     and one f32 absmax scale a position and head, quantized and
     dequantized by plain torch ops, as the reference's are plain ``jnp``)
     at full width, after phase 14, each model made anew from seed 0 and
     freed after its part (``kvint8_phase``): (a) tinyllama-1.1b (11 of
     its 22 layers, ``KV_TINY_LAYERS``): phase
     4's requests on an f32 and an int8 cache (``int8_serve``: the int8
     serve's launch counts set to 0 just before and read just after, every
     kernel of the per_row path launched, <= 1/decode_chunk host syncs a
     token, an int8 decode chunk under torch's sync check launching exactly
     one fused lookup and one row scale per projection a step), the
     streams' agreement recorded; ``cache_hbm_bytes`` of both caches equal
     to ``cache_formula``, dense (4 × 256) and paged (96 blocks of 16); a
     decode step and a 128-token prefill chunk profiled on each cache in
     turns, the kernels the int8 cache adds listed by name; a
     teacher-forced forward (120 tokens prefilled, 8 per-slot decode
     steps) on int8 caches through lut_pallas and lut_xla, logits bit-equal,
     and the decode positions against an f32 cache, corrcoef > 0.999 (the
     reference's bound, in its test's setting: float tables, the prefill
     attending over its unquantized K/V; per_row and the engine's prefill
     recorded beside a bf16 cache's); phase 6's prompts on int8 caches, the
     paged pool with prefix sharing against the dense engine, phase 6's
     reuse count and near-tie rule; a beam:2 request beside two greedy ones
     through the kernels = lut_xla (``beam_legs``). (b) olmoe-1b-7b on int8 caches: phase 4's
     requests (the batched fused kernel, one launch per expert projection
     a step), paged = dense, the cache bytes against the formula; beam:1 =
     greedy; beam:2 through the batched kernels = lut_xla (hypotheses
     equal, scores within 1e-4); spec:draft1b (spec k 4, lut_xla) with
     zero extra weight bytes, its verify steps, accepted drafts and
     agreement with greedy recorded, not required (capacity couples a
     burst's tokens); a lut_xla decode step timed. Its depth is cut to 4 of
     its 16 layers (``KV_MOE_LAYERS``): its lut_xla legs run 64 experts'
     plain lookups one at a time, in a time linear in the layers. (c)
     whisper-tiny and zamba2-7b (``SERVE_DEPTH``): one int8 serve each
     (``int8_serve``), the cache bytes against the formula (whisper's cross K/V int8 zeros,
     zamba2's Mamba2 state f32); for zamba2 a teacher-forced forward (120
     tokens prefilled, 8 decode steps, the kernels) on f32, bf16 and int8
     caches with per_row and float tables (``cache_dtype_forward``): the
     bf16 and int8 caches' decode logits against the f32 cache's
     (corrcoef, max |diff|, argmax) and the prefill's last position (the
     logits of a stream's first token) with the f32 cache's top-2 margin
     there, recorded.
 16. train families — QAT training on the SSM, hybrid, VLM and audio
     families (``train_families_phase``), after phase 15, each model made
     on the card from seed 0 at full width and freed after its leg, its
     depth cut as ``FAMILY_LEGS`` says: (a) falcon-mamba-7b, 4 of its 64
     layers, batch 4, AdamW; (b) zamba2-7b, 13 of its 81 layers (2 groups
     of 6, so two invocations of the shared block, and a tail of 1), batch
     4, Adafactor; (c) llama-3.2-vision-11b, one group of its 8 (4 self
     layers and a cross layer; both gates set to 0.5), batch 2, AdamW,
     image embeddings [2, 1601, 4096]; (d) whisper-tiny whole (4 + 4
     layers), batch 8 in 2 microbatches, AdamW, audio frames [8, 1500,
     384]. Each leg (``family_train``): 10 QAT steps (W2 symmetric
     fake-quant of every projection and the head) through
     ``make_train_step``, ``lr_schedule(3e-4, warmup=3, total=10)``, seq
     256, ``SyntheticLM(seed=0)``, the frontends' inputs normal draws × 0.1
     made on the card from seed 1000 + step, f32 activations (TF32 off):
     every loss and grad norm finite, the mean of the last 3 losses below
     the first 3's, and the QAT loss of step 0's batch (``family_loss``,
     no grad) after the 10 steps at least 0.05 below its loss before
     them, which the batches' order cannot move; recorded: the median step (steps 2-10, host clock, the
     loss read), tokens a second over them, peak device memory. (a) first
     trains the same model with the 8-bit AdamW (``adamw8bit``) as a
     record, not gated: the reference's INT8 m and v diverge there. Then
     the trained params are packed (``quantize_params``, W2 per_row) and
     run teacher-forced (``family_forward``: 128 tokens prefilled, 8
     decode steps, with the stub frontend's input for (c) and (d)) through
     lut_pallas and lut_xla: logits equal bit for bit, every kernel of the
     per_row path launched (counts set to 0 before, read after); (a) also
     serves 2 requests x 8 new tokens through the engine
     (``family_engine``: every kernel launched, <= 1/decode_chunk host
     syncs a token, a decode chunk under torch's sync check launching one
     fused lookup and one row scale per packed projection a step).
 17. window  — sliding-window attention on the rolling KV cache
     (``window_phase``), after phase 16: zamba2-7b at full width, 13 of its
     81 layers (two invocations of the shared block, as phase 16 (b) cuts
     it), batch 1, lut_pallas, random weights from seed 0 made on the card,
     ``window`` = ``shape("long_500k").window`` (8192), f32 caches: (a)
     with float tables (``table_quant=None``: per_row code flips, which
     zamba2 amplifies, would hide the attention's own difference), an
     8192-token prompt prefilled in 128-token chunks into a rolling cache
     (``api.init_cache(..., window=8192)``: 8192 slots, position p in slot
     p mod 8192) and into a full-length cache read under the window mask,
     then 64 greedy s = 1 steps past the wrap on each (``window_stream``):
     the two streams equal token for token, or diverging at a near tie
     (phase 6's rule: top-2 logit margin <= 0.15 ends the comparison
     there, and the run prints where); the largest logit gap over the
     compared steps printed; the launch counts set to 0 just before the
     rolling stream and read just after; (b) per_row, one decode step at
     position 8256 (past the wrap) from clones of the rolling cache
     through the kernels and through lut_xla: logits bit-equal, its
     launches counted; every kernel of the per_row path launched over (a)
     and (b); (c) the rolling cache's bytes equal to ``attn_cache``'s
     formula here, and at long_500k's full depth in bf16 (meta device:
     1.53 GB against 97.7 GB without the window); the per_row decode
     step's wall and busy time (``busy_profile``).
 18. cw      — the offline-CW weight store (``cw_phase``): full-width
     tinyllama-1.1b under lut_xla with per_row tables, its packed tree
     expanded once (``to_cw_params``, timed): a teacher-forced 128-token
     forward bit-equal on both trees, phase 4's 4-request greedy serve
     giving the same streams on both (on the card the engine keeps the
     tree it is given), the tree bytes of each store, one decode step's
     wall and busy time on each (``decode_step_profile``); an engine under
     lut_pallas refuses the CW tree (ValueError). lut_xla launches no
     kernel, as in the reference.
 19. tp      — the model-axis mesh (``tp_phase``): ranks spawned on the
     card (they share it over gloo; each on its own card over NCCL),
     the per-shard kernels, full-width tinyllama-1.1b (4 of its 22
     layers, ``MESH_LAYERS``) at 1x2 and 1x4 and olmoe-1b-7b (4 of 16
     layers) at 1x2, logits and streams held bit for bit to the
     one-device control (``sharding.one_device_control``). Phases 19-21
     spawn each world size's ranks once and run on them in turn
     (``rank_pool``).
 20. dp      — the data axis (``dp_phase``): (e) the per-shard kernels at
     a data rank's decode rows (M = 2); (a) each rank's own build at 1x2
     (``launch/serve.py``'s ``build_params``): its peak device memory
     beside its shard, the per-rank bound (the shard and the largest float
     subtree made whole) and the one-device build's peak, its blocks
     bit-equal to the whole build's; (b) tinyllama-1.1b (full width, 4
     layers) at 2x1 and 2x2: phase 4's requests per_row and with float
     tables (at 2x1 also sampled, phase 6's paged pool with prefix caching
     reusing its 879 prompt tokens, beam:2), teacher-forced logits, equal
     bit for bit to the control (the data ranks' row blocks in turn); (c)
     olmoe-1b-7b (4 layers) at 2x2: streams equal to the control's, each
     MoE layer's keep mask on the data ranks' rows equal to one device's
     on the whole batch; (d) per rank and serve: launches, host syncs a
     token, collectives by axis, a decode step's wall and busy time,
     decode tok/s beside one device's.
 21. train mesh — training under a (data, model) mesh
     (``train_mesh_phase``): full-width tinyllama-1.1b (2 layers) QAT, 4
     steps of 8 x 128 tokens, on one device and on ranks spawned on the
     card at 2x1 and 2x2 with and without FSDP (ZeRO-3 over the data
     axis), int8 gradient compression and Adafactor at 2x1, a 2x2
     checkpoint restored on the mesh and on one device, and the mesh's
     trained weights packed and run through lut_pallas = lut_xla; FSDP on
     equals FSDP off bit for bit, the mesh within 1e-3 of one device.

Phase 4 also prints its profiled decode step as a roofline
(``roofline_record``: ``repro_torch.roofline.cost.step_cost`` at the
engine's slots and cached positions, f32 K/V, per_row): the least bytes,
t_memory, and the ideal time's fraction of the step's wall and of its
busy time (``Roofline.fraction_of``).

The line before the last is the card's name and power limit; the line
before that the kernels' JSON record (the two batched wrappers listed
beside the four kernels, with phase 11's launches and times; each kernel's
launches and times at falcon-mamba-7b's, zamba2-7b's,
llama-3.2-vision-11b's and whisper-tiny's shapes under their names, the
launches of phase 14's serve of the trained weights, phase 15's
int8-cache serves' by model, phase 16's forwards and engine serve of
the trained weights by model, and phase 17's windowed zamba2 stream and
step), after a line with the whole script's seconds (every phase also
prints its own); the last line ``{"ok": true, "device": {...}}``. Per-shape details go to
``chip_smoke.json`` in the kernels' build directory
(``src/repro_torch/build/``).

    python3 chip_smoke.py --bitnet            # phases 1, 2 and 8 only

runs phase 8 alone (its record as one line of JSON),

    python3 chip_smoke.py --decoding          # phases 1, 2 and 9 only

phase 9 alone (its record as one line of JSON),

    python3 chip_smoke.py --telemetry         # phases 1, 2 and 10 only

phase 10 alone (its record as one line of JSON),

    python3 chip_smoke.py --moe               # phases 1, 2 and 11 only

phase 11 alone (its record as one line of JSON),

    python3 chip_smoke.py --ssm               # phases 1, 2 and 12 only

phase 12 alone (its record as one line of JSON),

    python3 chip_smoke.py --xattn             # phases 1, 2 and 13 only

phase 13 alone (falcon-mamba-7b and zamba2-7b made for its (e); its
record as one line of JSON),

    python3 chip_smoke.py --train             # phases 1, 2 and 14 only

phase 14 alone (its record as one line of JSON),

    python3 chip_smoke.py --kvint8            # phases 1, 2 and 15 only

phase 15 alone (its record as one line of JSON),

    python3 chip_smoke.py --train-families [LR]   # phases 1, 2 and 16

phase 16 alone, at base lr LR (default 3e-4; its record as one line of
JSON),

    python3 chip_smoke.py --window            # phases 1, 2 and 17 only
    python3 chip_smoke.py --cw                # phases 1, 2 and 18 only
    python3 chip_smoke.py --tp                # phases 1, 2 and 19 only
    python3 chip_smoke.py --dp                # phases 1, 2 and 20 only
    python3 chip_smoke.py --train-mesh        # phases 1, 2 and 21 only

phase 17, 18, 19, 20 or 21 alone (its record as one line of JSON),

    python3 chip_smoke.py --bound-seeds       # phases 1, 2 and 8 (a)'s
                                              # bf16 checks for 3 seeds

the largest ratio to phase 8 (a)'s bound of each bf16 path and of its
one-term control over three seeds (``bound_seeds``), and

    python3 chip_smoke.py --prefill-profile   # phases 1, 2 and the prefill
                                              # chunk's profile only

profiles one prefill chunk of phase 4's model alone, and

    python3 chip_smoke.py --float-profile     # phases 1, 2 and phase 7's
                                              # profiles and forward only

phase 7's decode step and prefill chunk profiles and teacher-forced
forward alone, and

    python3 chip_smoke.py --decode-profile    # phases 1, 2, then per_row
                                              # profiles and precompute times

phase 4's model with per_row tables: one decode step and one 128-token
prefill chunk profiled (CUDA kernels, device busy, wall, launches), and
the per_row precompute timed at M ∈ {4, 128}, K ∈ {2048, 5632}: the op
(``ops.table_precompute``), the kernel with a given row scale, the
closed-form row scale's torch kernels, and, where the checkout has them,
the one-launch precompute and ``row_scale``; then a 4-byte torch
kernel's time under the same timer, and hashes of the mpGEMM ops' outputs
on seeded inputs (``output_hashes``: equal hashes on two checkouts, equal
bits). All three use no entry point
newer than the port's first slices (the newer ones are looked up first),
so one call can run them on an older checkout beside this one.
"""

import contextlib
import itertools
import json
import os
import re
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# phase 14 trains under torch.use_deterministic_algorithms(True), which
# needs cuBLAS's workspace fixed before the first cuBLAS handle (":4096:8"
# is also the default size on Hopper, so the other phases run as before)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

MODES = (None, "per_row", "per_group")
SHAPES = ((2048, 2048), (256, 2048), (5632, 2048), (2048, 5632), (32000, 2048))
ROWS = (4, 128)            # decode batch, prefill chunk
KG, BITS = 4, 2
MAIN_M = {"fused_lut_mpgemm": 4, "lut_mpgemm": 128, "table_precompute": 128}
# the per_row serve path's launches: the three LUT kernels and the fused
# path's row scale
PER_ROW_PATH = tuple(MAIN_M) + ("row_scale",)
PRECOMPUTE_K = (2048, 5632)   # tinyllama-1.1b's K: d_model, d_ff
ROW_SCALE_M = (1, 4, 16, 128)
# table_precompute's kernels (csrc/table_precompute.cu): the K = 4 vector
# path per groups a thread, and the scalar path
PRECOMPUTE_KERNELS = ("precompute_k4_kernel", "precompute_scalar_kernel")
# a near tie: top-2 logit margin, as in tests/test_torch_serving.py
MARGIN = 0.15
# phase 8: the paper's own model at full width
BITNET = "paper-bitnet-3b"
# phase 8 (a)'s bound on the bf16 paths: |kernel - plain| <= BOUND_REL ·
# Σ_k |a_k · w_k| + 1e-6 at each output
BOUND_REL = 1e-5


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_report(text, bases=None):
    """{kernel: [registers line, spill line]} of the kernels named in
    ``bases`` (the tensor-core kernels, ``MMA_KERNELS``, by default) from
    nvcc's ``-Xptxas -v`` log."""
    bases = bases or MMA_KERNELS
    out, fn = {}, None
    for ln in text.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", ln)
        if found:
            fn = short_kernel_name(found.group(1), bases)
        elif fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(": ", 1)[-1].strip())
    return {k: v for k, v in out.items() if k.startswith(bases)}


# the tensor-core kernels: the int paths' (csrc/lut_mpgemm.cu: lut_mma_kernel
# per tile, splitk_epilogue_kernel; csrc/fused_lut_mpgemm.cu:
# fused_mma_kernel per tile), the float-table paths' (lut_bf16_kernel,
# fused_bf16_kernel, per tile and table mode) and csrc/dequant_mpgemm.cu:
# dequant_mma_kernel
MMA_KERNELS = ("lut_mma_kernel", "splitk_epilogue_kernel", "fused_mma_kernel",
               "lut_bf16_kernel", "fused_bf16_kernel", "dequant_mma_kernel")
# (library, kernel, SASS opcode): each kernel must hold tensor-core
# instructions of that kind
MMA_CHECKS = (("lut_mpgemm", "lut_mma_kernel", "IMMA"),
              ("lut_mpgemm", "lut_bf16_kernel", "HMMA"),
              ("fused_lut_mpgemm", "fused_mma_kernel", "IMMA"),
              ("fused_lut_mpgemm", "fused_bf16_kernel", "HMMA"),
              ("dequant_mpgemm", "dequant_mma_kernel", "HMMA"))
# the bf16 kernels' table mode template argument (csrc/lut_common.cuh: Mode)
TABLE_MODE = {"0": "None", "2": "per_group"}


def short_kernel_name(mangled, bases=None):
    """A kernel's base name (of ``bases``, ``MMA_KERNELS`` by default), its
    tile's (BM, BN, WM, WN) or other integer template arguments and, for a
    float-table kernel, its table mode."""
    for base in bases or MMA_KERNELS:
        if base in mangled:
            ints = re.findall(r"Li(\d+)E", mangled)
            name = base + (f"<{'x'.join(ints[:4])}>" if ints else "")
            if len(ints) > 4 and ints[4] in TABLE_MODE:
                name += f"/{TABLE_MODE[ints[4]]}"
            return name
    return mangled[:48]


def mma_counts(lib, nvcc, op):
    """Tensor-core instructions (SASS opcode ``op``: IMMA or HMMA) per
    kernel in the library's SASS (cuobjdump from nvcc's toolkit), or None
    where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(os.path.realpath(nvcc)), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        found = re.search(r"Function : (\w+)", ln)
        if found:
            fn = short_kernel_name(found.group(1))
            counts[fn] = 0
        elif fn and op in ln:
            counts[fn] += 1
    return counts


def time_ms(fn, reps, flush):
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush (CUDA events around the launch only). A spin of ~2 ms on the
    card ahead of each start event keeps the card busy while the host
    queues the call, so the events time the device work, not the host's
    Python around the launch."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)  # clock cycles: ~2 ms at 1.98 GHz
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and
    Σ operations / peak rate of their type, at the H100's published
    rates (``repro_torch.roofline``: 3.35 TB/s; int8 1979, bf16 989, f32
    67 TOP/s dense)."""
    from repro_torch.roofline.cost import bound as roofline_bound
    return roofline_bound(nbytes, ops)


def random_weight(gen, n, k):
    from repro_torch.core.quantize import QuantizedWeight
    packed = torch.randint(0, 256, (n, k * BITS // 8), generator=gen,
                           device="cuda", dtype=torch.uint8)
    scale = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-3
    return QuantizedWeight(packed, scale, None, (1.0, 2.0), bits=BITS,
                           k_group=KG, k_total=k, n=n)


def ternary_weight(gen, n, k):
    """BitNet b1.58's absmean ternary weight of random normal values: two
    sign planes, plane scales [1, 1]."""
    from repro_torch.core.quantize import quantize
    return quantize(torch.randn(n, k, generator=gen, device="cuda"), BITS,
                    k_group=KG, scheme="ternary")


def lut_sums(tv, ts, packed, wscale, *, k_group, planes, plane_scales,
             control=False):
    """Per output of a LUT mpGEMM's plain version, from its table entries a
    (codes times scales for per_group) and CW matrix w, times the weight
    scale: Σ_k |a_k · w_k|, or with ``control`` the product with each entry
    rounded once to bf16 (what a one-term bf16 kernel would give; the
    bound must reject it)."""
    from repro_torch.core.quantize import QuantizedWeight
    from repro_torch.kernels import ref
    e = 1 << (k_group - 1)
    m, gp = tv.shape[0], tv.shape[1] // e
    t = tv.to(torch.float32)
    if ts is not None:
        t = (t.view(m, gp, e) * ts.reshape(m, -1, 1)).view(m, gp * e)
    qw = QuantizedWeight(packed, wscale, None, plane_scales, bits=planes,
                         k_group=k_group, k_total=gp * k_group,
                         n=packed.shape[0])
    cw = ref.build_cw(qw, torch.float32)
    if control:
        return (t.to(torch.bfloat16).to(torch.float32) @ cw) * wscale
    return (t.abs() @ cw.abs()) * wscale.abs()


def dequant_sums(a, packed, wscale, *, k_group, planes, plane_scales,
                 control=False):
    """``lut_sums`` for ``dequant_mpgemm``'s plain version: the activations
    against q', times the weight scale."""
    from repro_torch.core.quantize import QuantizedWeight, plane_codes
    gp = packed.shape[1] * 8 // (planes * k_group)
    qw = QuantizedWeight(packed, wscale, None, plane_scales, bits=planes,
                         k_group=k_group, k_total=gp * k_group,
                         n=packed.shape[0])
    q = plane_codes(qw).T
    if control:
        return (a.to(torch.bfloat16).to(torch.float32) @ q) * wscale
    return (a.abs() @ q.abs()) * wscale.abs()


def check_kernels(flush, shapes=SHAPES, make_weight=random_weight,
                  paths=("dequant",) + MODES, scaled_bound=False, seed=0,
                  rows=ROWS, whole_k=None):
    """Phase 3 at ``shapes`` ((N, K) pairs) and ``rows`` (M) with weights
    from ``make_weight``, on ``paths``: ``dequant_mpgemm`` and the two LUT
    mpGEMMs in each table mode (phase 8: paper-bitnet-3b's shapes, ternary
    weights; phase 13 also per_row alone at the served large M). ``scaled_bound``: the bf16 tensor-core paths are held to
    ``|kernel - plain| <= BOUND_REL · Σ_k |a_k · w_k| + 1e-6`` at every
    output, the sum taken over the plain version's operands (``lut_sums``,
    ``dequant_sums``): what reordering f32 sums can move, at any output
    magnitude (phase 8), beside a control with one bf16 term per operand
    (its ratio to the bound is recorded, not checked); otherwise to
    rtol = atol = 1e-4 at every output and 1e-4 of the largest (phase 3). per_row is bit-exact either way.
    ``whole_k`` {(N, K): K_whole} (phase 19's row-parallel shapes): x is a
    K-range of a [M, K_whole] row, and the per_row table takes the whole
    row's scale, given (as a row-parallel rank quantizes it).
    Returns (per-shape records, per-kernel max_abs_err)."""
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels import dequant_mpgemm as dk
    from repro_torch.kernels import fused_lut_mpgemm as fk
    from repro_torch.kernels import lut_mpgemm as lk
    from repro_torch.kernels import ops
    from repro_torch.kernels import table_precompute as tk
    from repro_torch.core import table as T
    from repro_torch.roofline import cost

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    e = 1 << (KG - 1)
    records, err = [], {"table_precompute": 0.0, "lut_mpgemm": 0.0,
                        "fused_lut_mpgemm": 0.0, "dequant_mpgemm": 0.0}

    def compare(name, got, want, tq, what, f32_sums=False, sums=None):
        """Checks one output; returns its max error relative to the
        largest output, and with ``scaled_bound`` the largest
        |diff| / (BOUND_REL · sums() + 1e-6) (<= 1 holds) and the
        control's (``sums(control=True)``). ``f32_sums``: a bf16
        tensor-core path (bound in the docstring above)."""
        ratio = None
        if f32_sums and scaled_bound:
            tol = BOUND_REL * sums() + 1e-6
            ratio = ((got - want).abs() / tol).max().item()
            control = ((sums(control=True) - want).abs() / tol).max().item()
            if not ratio <= 1.0:
                raise AssertionError(
                    f"{name} {what}: |diff| exceeds {BOUND_REL} · Σ|a·w| + "
                    f"1e-6 at some output (max ratio {ratio:.3g})")
        elif f32_sums and not torch.allclose(got, want, rtol=1e-4,
                                             atol=1e-4):
            raise AssertionError(f"{name} {what}: not within rtol = atol = "
                                 f"1e-4 of each output")
        got, want = got.to(torch.float64), want.to(torch.float64)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {what}: non-finite output")
        diff = (got - want).abs().max().item()
        err[name] = max(err[name], diff)
        if tq == "per_row" and diff != 0.0:
            raise AssertionError(f"{name} {what}: per_row must be bit-exact, "
                                 f"max |diff| {diff}")
        rel = diff / max(want.abs().max().item(), 1e-30)
        if not scaled_bound and rel > 1e-4:
            raise AssertionError(f"{name} {what}: rel err {rel:.3g} > 1e-4")
        return {"max_rel_err": rel} if ratio is None else {
            "max_rel_err": rel, "bound_ratio": ratio,
            "control_ratio": control}

    def same_bits(name, kern, got, what):
        if not torch.equal(kern(), got):
            raise AssertionError(f"{name} {what}: two calls differ")

    for m in rows:
        for n, k in shapes:
            g = k // KG
            kw_ = (whole_k or {}).get((n, k))
            if kw_ is None:
                x, rs_whole = torch.randn(m, k, generator=gen,
                                          device="cuda"), None
            else:  # the first K-range of a whole row, its scale given
                xw = torch.randn(m, kw_, generator=gen, device="cuda")
                x = xw[:, :k].contiguous()
                rs_whole = ops._closed_form_row_scale(
                    xw, kw_ // KG, KG).contiguous()
            qw = make_weight(gen, n, k)
            w_bf16 = dequantize(qw).to(torch.bfloat16)
            x_bf16 = x.to(torch.bfloat16)
            library_mm = lambda: torch.matmul(x_bf16, w_bf16.T)
            pw = dict(k_group=KG, planes=qw.num_planes,
                      plane_scales=qw.plane_scales)
            if "dequant" in paths:
                # dequant_mpgemm (bf16 tensor cores; the plain matmul runs in
                # IEEE f32 with TF32 off, set in main) on operands padded as
                # ops pads them: x's rows as they are
                _, _, dbn, dbg = dk.tile_for(m, KG)
                xd = ops._pad_to(x, dbg * KG, 1).contiguous()
                pkd, wsd = ops._pad_packed(qw, xd.shape[1] // KG, dbn)
                kern = lambda: dk.dequant_mpgemm(xd, pkd, wsd, **pw)
                got, want = kern(), dk.dequant_mpgemm_plain(xd, pkd, wsd, **pw)
                rel = compare("dequant_mpgemm", got, want, None,
                              f"M={m} N={n} K={k}", f32_sums=True,
                              sums=lambda **c: dequant_sums(
                                  xd, pkd, wsd, **pw, **c))
                same_bits("dequant_mpgemm", kern, got, f"M={m} N={n} K={k}")
                nbytes, nops = cost.mpgemm_cost("dequant_mpgemm", m, n, k,
                                                bits=qw.bits)
                b_ms, b_by = bound(nbytes, nops)
                records.append({
                    "kernel": "dequant_mpgemm", "m": m, "n": n, "k": k,
                    "table_quant": None,
                    "kernel_ms": time_ms(kern, 10, flush),
                    "plain_ms": time_ms(
                        lambda: dk.dequant_mpgemm_plain(xd, pkd, wsd, **pw), 3,
                        flush),
                    "library_ms": time_ms(library_mm, 10, flush),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "bound_f32_ms": bound(nbytes, {"f32": 2 * m * n * k})[0],
                    **rel, "elementwise": True, "bit_equal": True,
                    **dequant_plan(m, pkd.shape[0], xd.shape[1] // KG)})
            for tq in (p for p in paths if p != "dequant"):
                what = f"M={m} N={n} K={k} table_quant={tq}"
                # the fused kernel's operands, padded as ops pads them
                xp, rs, pkp, wsp = fused_operands(x, qw, tq, rs_whole)
                # table precompute, bit-equal in every mode (timed in
                # precompute_checks)
                if not tables_equal(tk.table_precompute(x, KG, tq, rs),
                                    tk.table_precompute_plain(x, KG, tq, rs)):
                    raise AssertionError(f"table_precompute {what}: not "
                                         f"bit-equal to the plain version")
                # staged lookup on the table padded to the kernel's own
                # tile (the int path's for per_row)
                tv, ts = tk.table_precompute_plain(x, KG, tq, rs)
                staged = ops.staged_operands(T.Table(
                    tv.reshape(m, g, e),
                    None if ts is None else ts.reshape(m, -1, 1), None, KG),
                    qw)
                f32 = tq != "per_row"  # the bf16 tensor-core paths
                staged_call = lambda: lk.lut_mpgemm(*staged, **pw)
                got = staged_call()
                rels = {"lut_mpgemm": compare(
                    "lut_mpgemm", got, lk.lut_mpgemm_plain(*staged, **pw), tq,
                    what, f32, lambda **c: lut_sums(*staged, **pw, **c))}
                if f32:
                    same_bits("lut_mpgemm", staged_call, got, what)
                # fused
                fw = dict(pw, table_quant=tq)
                fused_call = lambda: fk.fused_lut_mpgemm(xp, rs, pkp, wsp, **fw)
                got = fused_call()
                rels["fused_lut_mpgemm"] = compare(
                    "fused_lut_mpgemm", got,
                    fk.fused_lut_mpgemm_plain(xp, rs, pkp, wsp, **fw), tq,
                    what, f32, lambda **c: lut_sums(
                        *tk.table_precompute_plain(xp, KG, tq, rs), pkp, wsp,
                        **pw, **c))
                if f32:
                    same_bits("fused_lut_mpgemm", fused_call, got, what)
                # times and bounds: every mode of the two LUT mpGEMMs (the
                # main path runs per_row); the fused kernel's row scale is
                # given on the per_row path (``fused_operands``)
                lut_cost = cost.mpgemm_cost("lut_mpgemm", m, n, k,
                                            table_quant=tq, bits=qw.bits)
                fused_cost = cost.mpgemm_cost(
                    "fused_lut_mpgemm", m, n, k, table_quant=tq,
                    bits=qw.bits, row_scale_given=rs is not None)
                first_ops = {"f32": 2 * m * n * k}  # the IEEE f32 first version
                recs = {
                    "lut_mpgemm": (
                        staged_call,
                        lambda: lk.lut_mpgemm_plain(*staged, **pw),
                        library_mm, *lut_cost, first_ops),
                    "fused_lut_mpgemm": (
                        fused_call,
                        lambda: fk.fused_lut_mpgemm_plain(xp, rs, pkp, wsp,
                                                          **fw),
                        library_mm, *fused_cost,
                        {"f32": first_ops["f32"] + fused_cost[1]["f32"]}),
                }
                for name, (kern, plain, lib, nbytes, nops, f32_ops) in (
                        recs.items()):
                    b_ms, b_by = bound(nbytes, nops)
                    records.append({
                        "kernel": name, "m": m, "n": n, "k": k,
                        "table_quant": tq,
                        **({} if kw_ is None else {"whole_k": kw_}),
                        "kernel_ms": time_ms(kern, 10, flush),
                        "plain_ms": time_ms(plain, 3, flush),
                        "library_ms": time_ms(lib, 10, flush),
                        "bound_ms": b_ms, "bound_by": b_by})
                    if f32:
                        records[-1].update(
                            bound_f32_ms=bound(nbytes, f32_ops)[0],
                            **rels[name], elementwise=True,
                            bit_equal=True, **f32_plan(
                                name, m, pkp.shape[0] if name ==
                                "fused_lut_mpgemm" else staged[2].shape[0],
                                xp.shape[1] // KG if name == "fused_lut_mpgemm"
                                else staged[0].shape[1] // e, tq))
                    elif name == "lut_mpgemm":
                        records[-1].update(int_plan(
                            m, staged[0].shape[0], staged[2].shape[0],
                            staged[0].shape[1] // e))
                    else:
                        records[-1].update(int_plan(
                            m, m, pkp.shape[0], xp.shape[1] // KG,
                            fused=True))
    return records, err


def tables_equal(got, want):
    """Two (values, scale) pairs of table_precompute with the same bits."""
    (gv, gs), (wv, ws) = got, want
    if not torch.equal(gv, wv) or (gs is None) != (ws is None):
        return False
    return gs is None or (gs.shape == ws.shape and torch.equal(
        gs.contiguous().view(torch.int32), ws.contiguous().view(torch.int32)))


def precompute_checks(flush, ks=PRECOMPUTE_K, rows=ROWS,
                      row_scale_m=ROW_SCALE_M):
    """Phase 3, ``table_precompute`` and its row-scale entry at ``ks``
    (tinyllama's K; phase 8: paper-bitnet-3b's). The precompute at M in
    ``rows`` (M ∈ {4, 128}; phase 13 also the served 1500 and 1601): None,
    per_group, and per_row with the row scale given or computed in the
    same launch; the row scale alone at M in ``row_scale_m`` ({1, 4, 16,
    128}). Each call is held to its plain version bit for
    bit (values and scale) and must add one launch to its own counter only.
    Times (``time_ms``): the kernel, the plain version, the library
    yardstick (for the precompute an f32 ``torch.matmul`` against the ±1
    basis, for the row scale ``torch.linalg.matrix_norm(ord=inf)`` of the
    [M, G, K] groups: max over groups of Σ|a|, without the clamp and the
    division) and for a computed row scale the closed form's torch kernels
    (``ops._closed_form_row_scale``, the parent's way to it; for the
    row-scale entry that is its plain version). Bounds: bytes = the
    activations (and a given row scale) read once + the codes or entries
    and the scales written once; f32 operations = the entries' K-1 adds, a
    division a code, and Σ|a| (K adds and maxes a group) where a scale is
    computed."""
    from repro_torch.core import table as T
    from repro_torch.kernels import ops
    from repro_torch.kernels import table_precompute as tk
    from repro_torch.roofline import cost
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    basis = T.sign_basis(KG, "cuda")
    records = []

    def counted(call, counter):
        before = (tk.launches, tk.row_scale_launches)
        out = call()
        after = (tk.launches, tk.row_scale_launches)
        want = (before[0] + (counter == "launches"),
                before[1] + (counter == "row_scale_launches"))
        if after != want:
            raise AssertionError(f"{counter}: {before} -> {after}, one launch "
                                 f"on its own counter expected")
        return out

    for m in rows:
        for k in ks:
            g = k // KG
            x = torch.randn(m, k, generator=gen, device="cuda")
            groups = x.reshape(m * g, KG)
            closed = lambda: ops._closed_form_row_scale(x, g, KG)
            rs = closed().contiguous()
            for tq, given in ((None, False), ("per_row", True),
                              ("per_row", False), ("per_group", False)):
                scale_in = rs if given else None
                kern = lambda: tk.table_precompute(x, KG, tq, scale_in)
                plain = lambda: tk.table_precompute_plain(x, KG, tq, scale_in)
                if not tables_equal(counted(kern, "launches"), plain()):
                    raise AssertionError(
                        f"table_precompute M={m} K={k} {tq} (row scale "
                        f"given: {given}): not bit-equal to the plain version")
                b_ms, b_by = bound(*cost.mpgemm_cost(
                    "table_precompute", m, None, k, table_quant=tq,
                    row_scale_given=given))
                records.append({
                    "kernel": "table_precompute", "m": m, "n": None, "k": k,
                    "table_quant": tq,
                    "row_scale": ("given" if given else "computed"
                                  if tq == "per_row" else None),
                    "kernel_ms": time_ms(kern, 10, flush),
                    "plain_ms": time_ms(plain, 3, flush),
                    "library_ms": time_ms(lambda: torch.matmul(groups, basis),
                                          10, flush),
                    "closed_form_ms": (time_ms(closed, 10, flush)
                                       if tq == "per_row" and not given
                                       else None),
                    "bound_ms": b_ms, "bound_by": b_by})
    for m in row_scale_m:
        for k in ks:
            g = k // KG
            x = torch.randn(m, k, generator=gen, device="cuda")
            kern = lambda: tk.row_scale(x, KG)
            closed = lambda: ops._closed_form_row_scale(x, g, KG)
            got = counted(kern, "row_scale_launches")
            if not tables_equal((got, got), (closed(), closed())):
                raise AssertionError(f"row_scale M={m} K={k}: not bit-equal "
                                     f"to the closed form")
            b_ms, b_by = bound(*cost.mpgemm_cost("row_scale", m, None, k))
            records.append({
                "kernel": "row_scale", "m": m, "n": None, "k": k,
                "table_quant": "per_row", "row_scale": "computed",
                "kernel_ms": time_ms(kern, 10, flush),
                "plain_ms": time_ms(closed, 10, flush),
                "library_ms": time_ms(lambda: torch.linalg.matrix_norm(
                    x.view(m, g, KG), ord=float("inf")), 10, flush),
                "bound_ms": b_ms, "bound_by": b_by})
    return records


def launch_floor_ms(flush):
    """``time_ms`` of one torch kernel on 4 bytes: what a launch, an event
    pair and the cold cache cost under that timer, whatever the work."""
    tiny = torch.zeros(1, device="cuda")
    return time_ms(lambda: tiny.add_(1.0), 10, flush)


def output_hashes():
    """The mpGEMM ops' outputs on seeded inputs at the main path's shapes,
    hashed per kernel path (sha256 of the f32 bytes): the staged and fused
    LUT paths in every table mode, and dequant_mpgemm. Two checkouts with
    equal hashes gave equal bits."""
    import hashlib
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    hashes = {}
    for m in ROWS:
        for n, k in SHAPES:
            x = torch.randn(m, k, generator=gen, device="cuda")
            qw = random_weight(gen, n, k)
            outs = {"dequant_mpgemm": ops.dequant_mpgemm(x, qw)}
            for fusion in ("staged", "fused"):
                for tq in MODES:
                    outs[f"{fusion} {tq}"] = ops.lut_mpgemm(
                        x, qw, table_quant=tq, fusion=fusion)
            for name, out in outs.items():
                h = hashes.setdefault(name, hashlib.sha256())
                h.update(out.contiguous().cpu().numpy().tobytes())
    return {name: h.hexdigest()[:16] for name, h in hashes.items()}


def precompute_line(r):
    """One ``precompute_checks`` record as text."""
    what = f"{r['kernel']} M={r['m']} K={r['k']}"
    if r["kernel"] == "table_precompute":
        what += f" {r['table_quant']}" + (
            f" (row scale {r['row_scale']})" if r["row_scale"] else "")
    extra = (", f32 matmul against the ±1 basis" if r["kernel"] ==
             "table_precompute" else ", matrix_norm(ord=inf)") + (
                 f" {r['library_ms']:.4f}")
    if r.get("closed_form_ms") is not None:
        extra += (f", the closed-form row scale's torch kernels "
                  f"{r['closed_form_ms']:.4f}")
    return (f"{what}: {r['kernel_ms']:.4f} ms (plain {r['plain_ms']:.4f}"
            f"{extra}, bound {r['bound_ms']:.5f} by {r['bound_by']}; "
            f"{r['kernel_ms'] / r['bound_ms']:.1f}x the bound)")


def fused_operands(x, qw, tq, rs=None):
    """(x, row scale, packed, wscale) of the fused kernel, padded as
    ``ops.fused_lut_mpgemm`` pads them, x's rows as they are: per_row to
    the int path's tile (its row scale ``rs`` where given, else x's own),
    None and per_group to the f32 paths'."""
    from repro_torch.kernels import fused_lut_mpgemm as fk
    from repro_torch.kernels import lut_mpgemm as lk
    from repro_torch.kernels import ops
    m, k = x.shape
    g = k // KG
    if tq == "per_row":
        _, _, bn, bg = fk.int_tile(m, KG, BITS)
        if rs is None:
            rs = ops._closed_form_row_scale(x, g, KG).contiguous()
    else:
        _, _, bn, bg = lk.f32_tile_for(m, KG, BITS)
        rs = None
    xp = ops._pad_to(x, bg * KG, 1).contiguous()
    return (xp, rs) + ops._pad_packed(qw, xp.shape[1] // KG, bn)


def int_plan(m, mp, np_, gp, fused=False):
    """An int path's launch plan for one shape (M rows, of which the kernel
    is given mp; np_ channels; gp K-groups): tile, K-step, split-K count S,
    blocks, dynamic shared memory and kernels per call. csrc/lut_mma.cuh:
    ring_plan: the stages, 3 where they fit, then the CW tile, the W2 K=4
    byte table and, in the fused kernel, the built table tile. A stage holds
    the table tile (staged) or the activation tile of x's rows (fused), and
    the packed codes. The staged kernel sums a split in a second kernel; the
    fused one in the same launch."""
    from repro_torch.kernels import fused_lut_mpgemm as fk
    from repro_torch.kernels import lut_mpgemm as lk
    _, bm, bn, bg = (fk.int_tile if fused else lk.int_tile_for)(m, KG, BITS)
    e = 1 << (KG - 1)
    rows = -(-mp // bm) * bm
    splits, ranges = lk.split_for(rows, np_, gp, bm, bn, bg)
    kt, pbs = bg * e, bg * BITS * KG // 8
    a_bytes = min(bm, m) * bg * KG * 4 if fused else bm * (kt + 16)
    stage = a_bytes + bn * pbs
    fixed = (bn + (bm if fused else 0)) * (kt + 16) + 256 * 8
    stages = 3 if 3 * stage + fixed <= 232448 else 2
    return {"tile": [bm, bn, kt], "splits": splits,
            "split_groups": [b - a for a, b in ranges],
            "blocks": (rows // bm) * (np_ // bn) * splits,
            "smem_bytes": stages * stage + fixed,
            "kernels_per_call": 1 if fused or splits == 1 else 2}


def dequant_plan(m, np_, gp):
    """dequant_mpgemm's launch plan for one shape (M rows, np_ channels, gp
    K-groups): tile, K-step, bf16 passes, split-K count S, blocks, the
    ring's stages and dynamic shared memory as the kernel's launch plans
    them (``dequant_mpgemm.ring``), and kernels per call."""
    from repro_torch.kernels import dequant_mpgemm as dk
    (_, bm, bn, bg), splits, tiles = dk.plan(m, np_, gp, KG)
    stages, smem = dk.ring(m, KG, BITS)
    return {"tile": [bm, bn, bg * KG], "passes": dk.PASSES, "splits": splits,
            "blocks": tiles * splits, "stages": stages, "smem_bytes": smem,
            "kernels_per_call": 1}


def f32_plan(kernel, m, np_, gp, tq):
    """A LUT kernel's float-table plan for one shape (M rows, as they are;
    np_ channels; gp K-groups): tile, K-step, bf16 passes, split-K count S,
    blocks, the ring's stages and dynamic shared memory as the kernel's
    launch plans them (``lut_mpgemm.f32_ring``), and kernels per call."""
    from repro_torch.kernels import lut_mpgemm as lk
    (_, bm, bn, bg), splits, tiles = lk.f32_plan(m, np_, gp, KG, BITS)
    stages, smem = lk.f32_ring(kernel, m, KG, BITS, tq)
    return {"tile": [bm, bn, bg << (KG - 1)], "passes": lk.F32_PASSES,
            "splits": splits, "blocks": tiles * splits, "stages": stages,
            "smem_bytes": smem, "kernels_per_call": 1}


def record_line(r):
    """One phase-3 record as text: times, bound and, for a tensor-core
    path, its plan."""
    line = (f"{r['kernel']} M={r['m']} N={r['n']} K={r['k']}"
            + ("" if r["kernel"] == "dequant_mpgemm" else
               f" {r['table_quant']}")
            + f": {r['kernel_ms']:.4f} ms (plain {r['plain_ms']:.4f}, bf16 "
            f"matmul {r['library_ms']:.4f}, bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']}; {r['kernel_ms'] / r['library_ms']:.2f}x the "
            f"matmul, {r['kernel_ms'] / r['bound_ms']:.1f}x the bound)")
    if "tile" not in r:
        return line
    step = f"K-step {r['tile'][2]} " + (
        "weights" if r["kernel"] == "dequant_mpgemm" else "entries")
    if "passes" in r:
        step += f", {r['passes']} bf16 passes"
    return line + (
        f" [tile {r['tile'][0]}x{r['tile'][1]}, {step}, S={r['splits']}, "
        f"{r['blocks']} blocks, {r['smem_bytes']} B smem, "
        f"{r['kernels_per_call']} kernel(s) per call"
        + ("" if "max_rel_err" not in r else
           f"; max rel err {r['max_rel_err']:.3g}, " + (
               f"each output within {BOUND_REL} · Σ|a·w| + 1e-6 (max ratio "
               f"{r['bound_ratio']:.3g}; one bf16 term: "
               f"{r['control_ratio']:.3g})" if "bound_ratio" in r else
               "each output within 1e-4") + ", two calls bit-equal")
        + "]")


def dequant_op_path():
    """Phase 3, the dequant op path: ``ops.dequant_mpgemm`` at the ten
    shapes, with the launch counts set to 0 just before and read just
    after. Each output is held against ``x @ dequantize(qw).T`` in f32
    (1e-4 relative). Returns (launches, max |diff|)."""
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases = [(torch.randn(m, k, generator=gen, device="cuda"),
              random_weight(gen, n, k)) for m in ROWS for n, k in SHAPES]
    reset_counts()
    outs = [ops.dequant_mpgemm(x, qw) for x, qw in cases]
    torch.cuda.synchronize()
    launches = read_counts()
    err = 0.0
    for (x, qw), out in zip(cases, outs):
        want = x @ dequantize(qw).T
        diff = (out - want).abs().max().item()
        err = max(err, diff)
        if (tuple(out.shape) != tuple(want.shape)
                or not torch.isfinite(out).all()
                or diff > 1e-4 * want.abs().max().item()):
            raise AssertionError(f"dequant op M={x.shape[0]} N={qw.n}: "
                                 f"max |diff| {diff}")
    if launches != {**{n: 0 for n in launches}, "dequant_mpgemm": len(cases)}:
        raise AssertionError(f"dequant op path: launches {launches}")
    return launches["dequant_mpgemm"], err


def kernel_modules():
    from repro_torch.kernels import dequant_mpgemm as dk
    from repro_torch.kernels import fused_lut_mpgemm as fk
    from repro_torch.kernels import lut_mpgemm as lk
    from repro_torch.kernels import table_precompute as tk
    return {"table_precompute": tk, "lut_mpgemm": lk,
            "fused_lut_mpgemm": fk, "dequant_mpgemm": dk}


def reset_counts():
    """Sets every wrapper's launch count to 0, the row scale's and the
    batched wrappers' too where the checkout has those entries."""
    mods = kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    if hasattr(mods["table_precompute"], "row_scale_launches"):
        mods["table_precompute"].row_scale_launches = 0
    for name in ("lut_mpgemm", "fused_lut_mpgemm"):
        if hasattr(mods[name], "batched_launches"):
            mods[name].batched_launches = 0


def read_counts():
    """{kernel: launches} of the four wrappers, of ``row_scale`` and of the
    two batched (expert-axis) wrappers (None where the checkout has no
    such entry)."""
    mods = kernel_modules()
    out = {name: mod.launches for name, mod in mods.items()}
    out["row_scale"] = getattr(mods["table_precompute"], "row_scale_launches",
                               None)
    for name in ("lut_mpgemm", "fused_lut_mpgemm"):
        out[name + "_batched"] = getattr(mods[name], "batched_launches", None)
    return out


def checked_decode_chunk(tag, eng, per_step):
    """One more decode chunk of ``eng`` under torch's sync check (a call
    that makes the host wait for the card raises), its launches counted:
    ``per_step`` (kernel -> launches a step) times the chunk's steps, and
    no other launch. Returns the launches."""
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_chunk(sampling=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    chunk = read_counts()
    want = dict({n: 0 for n in chunk},
                **{n: c * eng.decode_chunk for n, c in per_step.items()})
    if chunk != want:
        raise AssertionError(f"{tag}: a decode chunk launched {chunk}, not "
                             f"{want}")
    return chunk


# phase 4's engine: 4 slots, max_seq 256, decode chunk 8, prefill chunk 128
SERVE_KW = dict(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=128)


def serve_prompts(vocab, seed):
    """Phase 4's four prompts of 130-200 tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(130, 201)))
            for _ in range(4)]


def serve(cfg, params, seed, **engine_kw):
    """Phase 4: 4 requests through the engine (``engine_kw`` added to
    SERVE_KW, or replacing its values); returns (engine, requests)."""
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, **dict(SERVE_KW, **engine_kw))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(serve_prompts(cfg.vocab_size, seed))]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    return eng, reqs


def paged_prompts(vocab, bs=16):
    """Six prompts sharing a 144-token system prompt (9 blocks) with 8-40
    token suffixes whose first tokens all differ, then two identical
    160-token prompts (a block multiple: the second copies on write) whose
    first token differs from the system prompt's."""
    rng = np.random.default_rng(4)
    sys_p = rng.integers(0, vocab, 9 * bs)
    firsts = rng.choice(vocab, 6, replace=False)
    prompts = []
    for first in firsts:
        suffix = rng.integers(0, vocab, int(rng.integers(8, 41)))
        suffix[0] = first
        prompts.append(np.concatenate([sys_p, suffix]))
    cow = rng.integers(0, vocab, 10 * bs)
    cow[0] = (sys_p[0] + 1) % vocab
    return prompts + [cow, cow.copy()]


def expected_reuse(prompts, bs):
    """Prompt tokens the reference's sharing rule serves from cached blocks
    for prompts admitted in this order, with nothing evicted: block j is
    shared by reference when it ends at or below plen - 1 and an earlier
    prompt wrote it; a prompt of whole blocks copies its last block on
    write when all the others were shared."""
    cached, total = set(), 0
    for p in prompts:
        plen, m_share = len(p), (len(p) - 1) // bs
        m0 = 0
        while m0 < m_share and tuple(p[:(m0 + 1) * bs]) in cached:
            m0 += 1
        start = m0 * bs
        if (m0 == m_share and (m_share + 1) * bs == plen
                and tuple(p) in cached):
            start += bs
        total += min(start, plen - 1)
        cached |= {tuple(p[:(j + 1) * bs]) for j in range(m_share)}
        if (m_share + 1) * bs == plen:
            cached.add(tuple(p))
    return total


def first_kv_divergence(eng, prompt, donor, shared):
    """Where a shared-prefix prefill first differs from a dense one: the
    dense engine prefills ``prompt`` from 0 into cache A; cache B gets
    ``donor``'s prefill (the blocks the prefix cache holds), then the
    suffix of ``prompt`` from ``shared`` at that offset, as the paged
    engine computes it. Returns (layer, position, max |diff|) of the first
    layer whose K or V differ over the prompt's positions, or None."""
    from repro_torch.models import api
    a, b = (api.init_cache(eng.cfg, 1, eng.max_seq, dtype=torch.float32,
                           device=eng.device) for _ in range(2))
    eng._prefill(prompt, 0, a)
    eng._prefill(donor, 0, b)
    eng._prefill(prompt, shared, b)
    n = len(prompt) - 1
    for layer in range(eng.cfg.n_layers):
        d = torch.stack([(x[layer, 0, :n] - y[layer, 0, :n]).abs()
                         .amax(dim=(1, 2)) for x, y in zip(a, b)]).amax(0)
        if d.max().item() > 0:
            pos = int(torch.nonzero(d)[0, 0])
            return layer, pos, d.max().item()
    return None


def paged(cfg, params):
    """Phase 6: the block-paged pool at full width against the dense
    engine. Returns (stats of the prefix-sharing run, launches, record)."""
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine
    bs = 16
    prompts = paged_prompts(cfg.vocab_size, bs)
    reuse = expected_reuse(prompts, bs)
    if reuse != 5 * 144 + 159:
        raise AssertionError(f"paged: the prompts give {reuse} reusable "
                             f"tokens, not 5*144 + 159")
    kw = dict(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=128)
    paged_kw = dict(kw, cache_block_size=bs, num_cache_blocks=96)

    def run(**engine_kw):
        eng = ServingEngine(cfg, params, **engine_kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        torch.cuda.synchronize()
        if not all(r.done and len(r.output) == 16 for r in reqs):
            raise AssertionError("paged: a request did not finish 16 tokens")
        return eng, [r.output for r in reqs]

    dense_eng, dense = run(**kw)
    unshared_eng, unshared = run(**paged_kw)
    if unshared != dense:
        raise AssertionError("paged: without prefix sharing the streams "
                             "differ from the dense engine's")
    reset_counts()
    eng, shared = run(**paged_kw, prefix_cache=True)
    launches = read_counts()

    # (a) streams: equal, or diverging at a near tie (then stop comparing)
    divergences = []
    for uid, (p, got, want) in enumerate(zip(prompts, shared, dense)):
        j = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        if j is None:
            continue
        seq = torch.as_tensor(np.concatenate([p, want[:j]])[None],
                              device=eng.device)
        top2 = torch.topk(api.forward(params, {"tokens": seq}, cfg)[0][0, -1],
                          2).values
        margin = (top2[0] - top2[1]).item()
        divergences.append({"uid": uid, "position": j, "margin": margin})
        if margin > MARGIN:
            raise AssertionError(f"paged: request {uid} diverges at token {j} "
                                 f"with top-2 margin {margin} > {MARGIN}")
    st = eng.stats()
    # (b) reuse, hits, evictions; (c) only the prefix cache's refs are left
    pc = st["prefix_cache"]
    if st["prefill_tokens_reused"] != reuse:
        raise AssertionError(f"paged: {st['prefill_tokens_reused']} prompt "
                             f"tokens reused, the sharing rule gives {reuse}")
    if pc["hits"] <= 0 or pc["evictions"] != 0:
        raise AssertionError(f"paged: prefix cache {pc}")
    if st["blocks_in_use"] != pc["entries"]:
        raise AssertionError(f"paged: {st['blocks_in_use']} blocks in use, "
                             f"{pc['entries']} prefix entries")
    # (d) the LUT kernels and the row scale ran
    if min(launches[n] for n in PER_ROW_PATH) <= 0:
        raise AssertionError(f"paged: a LUT kernel never ran: {launches}")
    # (e) a paged decode chunk makes the host wait nowhere
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_chunk(sampling=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dense_st = dense_eng.stats()
    kv = first_kv_divergence(dense_eng, prompts[1], prompts[0], 144)
    # decode step wall time of each engine in turns (dense, paged, paged,
    # dense), then one profiled paged step: a profiler session can slow
    # the host's later launches, so it comes last
    walls = {"dense": [], "paged": []}
    for name, e in (("dense", dense_eng), ("paged", eng), ("paged", eng),
                    ("dense", dense_eng)):
        walls[name].append(decode_step_wall(e))
    return st, launches, {
        "divergences": divergences, "first_kv_divergence": kv,
        "dense_prefill_tokens": dense_st["prefill_tokens"],
        "decode_tok_s": {"dense": dense_st["decode_tok_s"],
                         "paged": unshared_eng.stats()["decode_tok_s"],
                         "paged_prefix": st["decode_tok_s"]},
        "decode_step_wall_ms": walls,
        "paged_decode_step": decode_step_profile(eng)}


def decode_step_wall(eng):
    """Wall time per decode step of one decode chunk (host clock,
    synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._decode_chunk(sampling=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / eng.decode_chunk


def decode_step_profile(eng):
    """Wall time of a decode chunk (host clock, synchronized) against the
    device time of its kernels (torch.profiler), per decode step. The
    profiler runs on a second chunk, so its host overhead stays out of the
    wall time."""
    from torch.profiler import ProfilerActivity, profile
    n = eng.decode_chunk
    wall_ms = decode_step_wall(eng)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._decode_chunk(sampling=False)
        torch.cuda.synchronize()
    per_name, counts, fused, kernels = {}, {}, [0.0, 0], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total
            counts[e.name[:60]] = counts.get(e.name[:60], 0) + 1
            kernels += not e.name.startswith(("Memcpy", "Memset"))
            if any(k in e.name for k in FUSED_KERNELS):
                fused[0] += e.device_time_total
                fused[1] += 1
    busy_ms = sum(per_name.values()) / 1e3 / n
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms,
            # None: the profiler saw no device activity (not measured)
            "busy_ms": busy_ms if per_name else None,
            "idle_share": 1.0 - busy_ms / wall_ms if per_name else None,
            "fused_ms": fused[0] / 1e3 / n if per_name else None,
            "fused_kernels": fused[1] / n,
            # CUDA kernels the profiler saw per step (copies and fills apart)
            "kernels": kernels / n,
            "lookup_kernels": lookup_names(per_name, FUSED_KERNELS),
            "top": [(name[:60], t / 1e3 / n) for name, t in top],
            # launches a step of each kernel name
            "by_name": {name: c / n for name, c in counts.items()}}


def lookup_names(per_name, bases):
    """The base names of the lookup kernels (``bases``) the profiler saw."""
    return sorted({b for b in bases for name in per_name if b in name})


# fused_lut_mpgemm's kernels by name (csrc/fused_lut_mpgemm.cu);
# fused_f32_kernel is the float-table paths' first version, which
# ``--float-profile`` meets in an older checkout
FUSED_KERNELS = ("fused_mma_kernel", "fused_bf16_kernel", "fused_f32_kernel")


# lut_mpgemm's kernels by name; lut_f32_kernel and lut_mpgemm_kernel are
# first versions, which ``--float-profile`` and ``--prefill-profile`` meet in
# an older checkout
STAGED_KERNELS = ("lut_mma_kernel", "splitk_epilogue_kernel",
                  "lut_bf16_kernel", "lut_f32_kernel", "lut_mpgemm_kernel")


def prefill_chunk_profile(eng):
    """One 128-token prefill chunk into a fresh batch-1 cache: wall time
    (host clock, synchronized) against the device time of its kernels
    (torch.profiler), the staged lookup's share (``lut_mpgemm``'s kernels)
    among them. The profiler runs on a second chunk, so its host overhead
    stays out of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    prompt = np.random.default_rng(5).integers(0, eng.cfg.vocab_size,
                                               eng.prefill_chunk + 1)
    # the engine's cache dtype (f32 in a checkout without the int8 cache)
    cache = api.init_cache(eng.cfg, 1, eng.max_seq,
                           dtype=getattr(eng, "_cache_dtype", torch.float32),
                           device=eng.device)
    eng._prefill(prompt, 0, cache)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._prefill(prompt, 0, cache)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._prefill(prompt, 0, cache)
        torch.cuda.synchronize()
    per_name, counts = {}, {}
    staged, fused, kernels = [0.0, 0], [0.0, 0], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total
            counts[e.name[:60]] = counts.get(e.name[:60], 0) + 1
            kernels += not e.name.startswith(("Memcpy", "Memset"))
            for names, acc in ((STAGED_KERNELS, staged),
                               (FUSED_KERNELS, fused)):
                if any(k in e.name for k in names):
                    acc[0] += e.device_time_total
                    acc[1] += 1
    busy_ms = sum(per_name.values()) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms,
            # None: the profiler saw no device activity (not measured)
            "busy_ms": busy_ms if per_name else None,
            "idle_share": 1.0 - busy_ms / wall_ms if per_name else None,
            "staged_lookup_ms": staged[0] / 1e3 if per_name else None,
            "staged_lookup_kernels": staged[1],
            # the fused kernel, where a chunk's plan is fused (olmoe's
            # experts at 24 rows an expert)
            "fused_lookup_ms": fused[0] / 1e3 if per_name else None,
            "fused_lookup_kernels": fused[1],
            "kernels": kernels,
            "lookup_kernels": lookup_names(per_name, STAGED_KERNELS),
            "top": [(name[:60], t / 1e3) for name, t in top],
            "by_name": counts}


def prefill_line(rec):
    if rec["busy_ms"] is None:
        return (f"wall {rec['wall_ms']:.2f} ms, device busy not measured "
                f"(the profiler saw no device events)")
    return (f"wall {rec['wall_ms']:.2f} ms, device busy {rec['busy_ms']:.2f} "
            f"ms (idle share {rec['idle_share']:.3f}) in {rec['kernels']} "
            f"CUDA kernels; lut_mpgemm "
            f"{rec['staged_lookup_ms']:.2f} ms in "
            f"{rec['staged_lookup_kernels']} kernels; "
            + (f"fused_lut_mpgemm {rec['fused_lookup_ms']:.2f} ms in "
               f"{rec['fused_lookup_kernels']} kernels; "
               if rec.get("fused_lookup_kernels") else "")
            + "device time by kernel: "
            + ", ".join(f"{n} {t:.2f} ms" for n, t in rec["top"]))


def float_profile(cfg, params, eng):
    """Phase 7's measurements on a float-table engine: one decode step and
    one 128-token prefill chunk profiled, each with the launch counts set
    to 0 just before and read just after, and the teacher-forced forward
    (``float_forward``). Uses only entry points of the port's first
    slices, so ``--float-profile`` runs it on an older checkout too."""
    out = step_and_chunk(eng)
    out["forward"] = float_forward(cfg, params)
    return out


def step_and_chunk(eng):
    """One decode step and one 128-token prefill chunk profiled, each with
    the launch counts set to 0 just before and read just after."""
    out = {}
    for what, run in (("decode_step", decode_step_profile),
                      ("prefill_chunk", prefill_chunk_profile)):
        reset_counts()
        out[what] = run(eng)
        out[what]["launches"] = read_counts()
    return out


def float_forward(cfg, params):
    """A teacher-forced 128-token forward through the kernels (lut_pallas)
    and the plain LUT path (lut_xla), for None and per_group tables: max
    |logit diff|, max |logit|, whether every logit is within rtol = atol =
    the mode's bound (tests/test_torch_model.py: 1e-3 for None, 5e-2 for
    per_group), and the share of positions whose greedy token agrees. The
    control: the same of the plain path against itself with its T·CW
    summed over K in two halves (``contraction_in_halves``), the same
    function in another f32 order, as the kernels' order differs."""
    from repro_torch.models import api
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")

    def logits(mode, tq):
        out = api.forward(params, {"tokens": toks},
                          cfg.with_quant(mpgemm_mode=mode,
                                         table_quant=tq))[0]
        if tuple(out.shape) != (1, 128, cfg.vocab_size) or not (
                torch.isfinite(out).all()):
            raise AssertionError(f"float: bad logits {tuple(out.shape)}")
        return out

    def versus(a, b, tol):
        return {"max_abs_diff": (a - b).abs().max().item(),
                "max_abs_logit": a.abs().max().item(), "tol": tol,
                "within": bool(torch.allclose(a, b, rtol=tol, atol=tol)),
                "greedy_agree": (a.argmax(-1) == b.argmax(-1)).float()
                .mean().item()}

    out = {}
    for tq, tol in ((None, 1e-3), ("per_group", 5e-2)):
        plain = logits("lut_xla", tq)
        with contraction_in_halves():
            halves = logits("lut_xla", tq)
        out[str(tq)] = dict(versus(logits("lut_pallas", tq), plain, tol),
                            control=versus(halves, plain, tol))
    return out


@contextlib.contextmanager
def contraction_in_halves():
    """Within it, the plain LUT path (``kernels.ref.lut_contract``) sums a
    float table's T·CW over K in two halves, then adds them."""
    from repro_torch.kernels import ref
    orig = ref.lut_contract

    def halves(t, qw):
        if t.scale is not None and t.scale.shape[1] == 1:
            return orig(t, qw)  # per_row: exact integer sums
        m = t.values.shape[0]
        tv = (t.values if t.scale is None
              else t.values.to(torch.float32) * t.scale).reshape(m, -1)
        cw, h = ref.build_cw(qw, torch.float32), tv.shape[1] // 2
        return (tv[:, :h] @ cw[:h] + tv[:, h:] @ cw[h:]) * qw.scale[None]

    ref.lut_contract = halves
    try:
        yield
    finally:
        ref.lut_contract = orig


def float_line(rec):
    """Phase 7's profiles and forward as text."""
    step, chunk = rec["decode_step"], rec["prefill_chunk"]
    busy = ("device busy not measured" if step["busy_ms"] is None else
            f"device busy {step['busy_ms']:.2f} ms (idle share "
            f"{step['idle_share']:.3f}) in {step['kernels']:g} CUDA kernels; "
            f"fused_lut_mpgemm {step['fused_ms']:.3f} ms in "
            f"{step['fused_kernels']:g} kernels {step['lookup_kernels']}")
    fwd = "; ".join(
        f"{tq}: max |logit diff| {r['max_abs_diff']:.3g} (max |logit| "
        f"{r['max_abs_logit']:.4g}, rtol = atol = {r['tol']:g} "
        f"{'met' if r['within'] else 'missed'}), greedy token equal at "
        f"{100 * r['greedy_agree']:.1f}% of positions (control, the plain "
        f"path summed in two K halves: {r['control']['max_abs_diff']:.3g}, "
        f"{'met' if r['control']['within'] else 'missed'}, "
        f"{100 * r['control']['greedy_agree']:.1f}%)"
        for tq, r in rec["forward"].items())
    return (f"one decode step: wall {step['wall_ms']:.2f} ms, {busy}, "
            f"launches {step['launches']}; one 128-token prefill chunk: "
            + prefill_line(chunk) + f" {chunk['lookup_kernels']}, launches "
            f"{chunk['launches']}; teacher-forced 128-token forward, "
            f"lut_pallas vs lut_xla: {fwd}")


def float_tables(cfg, params):
    """Phase 7: phase 4's serve with float tables, then ``float_profile``.
    Raises where the f32 paths did not launch (the fused kernel in decode,
    the staged pair in prefill), on more than 1/decode_chunk host syncs a
    token, or where the forward misses its bounds. Returns (stats, launches
    of the serve, the profile record)."""
    cfg = cfg.with_quant(table_quant=None)
    reset_counts()
    eng, reqs = serve(cfg, params, seed=2)
    launches = read_counts()
    st = eng.stats()
    if not all(r.done and len(r.output) == 16 for r in reqs):
        raise AssertionError("float: not every request finished 16 tokens")
    if min(launches[n] for n in MAIN_M) <= 0:
        raise AssertionError(f"float: a LUT kernel never ran: {launches}")
    if st["host_syncs_per_token"] > 1.0 / eng.decode_chunk:
        raise AssertionError(f"float: {st['host_syncs_per_token']} host "
                             f"syncs per token > 1/{eng.decode_chunk}")
    rec = float_profile(cfg, params, eng)
    step, chunk = rec["decode_step"], rec["prefill_chunk"]
    if step["launches"]["fused_lut_mpgemm"] <= 0 or (
            chunk["launches"]["lut_mpgemm"] <= 0):
        raise AssertionError(f"float: decode {step['launches']}, prefill "
                             f"{chunk['launches']}")
    # where the profiler saw the device: the f32 paths' kernels ran
    if step["busy_ms"] is not None and (
            "fused_bf16_kernel" not in step["lookup_kernels"]
            or "lut_bf16_kernel" not in chunk["lookup_kernels"]):
        raise AssertionError(f"float: lookup kernels {step['lookup_kernels']}"
                             f" in decode, {chunk['lookup_kernels']} in "
                             f"prefill")
    # None: every logit within 1e-3; per_group: the greedy token of >= 90%
    # of the positions. per_group's 5e-2 on each logit is recorded, not
    # required: INT8 codes flip wherever an entry sits within a last-bit
    # difference of a rounding boundary, and over 22 layers the plain path
    # summed in another order misses it against itself (the control)
    fwd = rec["forward"]
    if not fwd["None"]["within"] or fwd["per_group"]["greedy_agree"] < 0.9:
        raise AssertionError(f"float: the forward misses its bound: {fwd}")
    return st, launches, rec


def bitnet_config():
    from repro_torch.configs import registry
    return registry.get_config(BITNET).replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_pallas",
                                                   fusion="auto")


def projection_shapes(cfg):
    """{projection: (N, K)} of a dense arch's layer and its head."""
    d, q, kv = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                cfg.n_kv_heads * cfg.head_dim)
    return {"wq": (q, d), "wk": (kv, d), "wv": (kv, d), "wo": (d, q),
            "gate": (cfg.d_ff, d), "up": (cfg.d_ff, d), "down": (d, cfg.d_ff),
            "lm_head": (cfg.vocab_size, d)}


def serve_and_parity(tag, cfg, params):
    """Phases 4 and 5 for one model (phase 8 (c) and (d) for
    paper-bitnet-3b): a warm-up serve, then ``serve`` with the launch
    counts set to 0 just before and read just after, which must finish
    every request, launch every kernel of the per_row path and make at most
    1/decode_chunk host syncs a token; one decode chunk under torch's sync
    check, its launches counted: exactly one fused launch and one row scale
    per projection a step (the layers' and the head's) and nothing else;
    one decode step and one 128-token prefill chunk profiled
    (``step_and_chunk``); a teacher-forced 128-token forward through the
    kernels (lut_pallas) and the plain LUT path (lut_xla), per_row: logits
    equal bit for bit, because every per_row projection is exact integer
    arithmetic with the same epilogue. Returns (engine, record)."""
    from repro_torch.models import api
    serve(cfg, params, seed=1)  # warm-up: lazy CUDA/cuBLAS state, kernels
    reset_counts()
    eng, reqs = serve(cfg, params, seed=2)
    launches = read_counts()
    st = eng.stats()
    if not all(r.done and len(r.output) == 16 for r in reqs):
        raise AssertionError(f"{tag}: not every request finished 16 tokens")
    if min(launches[n] for n in PER_ROW_PATH) <= 0:
        raise AssertionError(f"{tag}: a kernel never ran: {launches}")
    if st["host_syncs_per_token"] > 1.0 / eng.decode_chunk:
        raise AssertionError(f"{tag}: {st['host_syncs_per_token']} host "
                             f"syncs per token > 1/{eng.decode_chunk}")
    per_step = (len(projection_shapes(cfg)) - 1) * cfg.n_layers + 1
    chunk_launches = checked_decode_chunk(tag, eng, {
        "fused_lut_mpgemm": per_step, "row_scale": per_step})
    rec = dict(prompts=[len(r.prompt) for r in reqs], serve=st,
               outputs=[r.output for r in reqs], launches=launches,
               decode_chunk_launches=chunk_launches, **step_and_chunk(eng))

    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")
    logits = {mode: api.forward(params, {"tokens": toks}, cfg.with_quant(
        mpgemm_mode=mode, table_quant="per_row"))[0]
        for mode in ("lut_pallas", "lut_xla")}
    a, b = logits["lut_pallas"], logits["lut_xla"]
    if (tuple(a.shape) != (1, 128, cfg.vocab_size)
            or not torch.isfinite(a).all()):
        raise AssertionError(f"{tag}: bad logits {tuple(a.shape)}")
    rec["parity_max_abs_diff"] = (a - b).abs().max().item()
    rec["parity_max_abs_logit"] = a.abs().max().item()
    if rec["parity_max_abs_diff"] != 0.0:
        raise AssertionError(f"{tag}: kernels and plain path disagree, max "
                             f"|logit diff| {rec['parity_max_abs_diff']}")
    return eng, rec


def serve_lines(tag, cfg, eng, rec):
    """``serve_and_parity``'s record as text, one line a part."""
    st, step, chunk = rec["serve"], rec["decode_step"], rec["prefill_chunk"]
    busy = ("device busy not measured (the profiler saw no device events)"
            if step["busy_ms"] is None else
            f"device busy {step['busy_ms']:.2f} ms (idle share "
            f"{step['idle_share']:.3f}) in {step['kernels']:g} CUDA kernels; "
            f"fused_lut_mpgemm {step['fused_ms']:.3f} ms in "
            f"{step['fused_kernels']:g} kernels; device time by kernel: "
            + ", ".join(f"{n} {t:.2f} ms" for n, t in step["top"]))
    return [
        f"{tag}: {len(rec['prompts'])} requests, prompts {rec['prompts']}, "
        f"{st['decode_tokens']} tokens; decode {st['decode_tok_s']:.1f} "
        f"tok/s, chunk p50 {st['p50_chunk_ms']:.1f} ms / p95 "
        f"{st['p95_chunk_ms']:.1f} ms, host syncs/token "
        f"{st['host_syncs_per_token']:.4f}; launches {rec['launches']}; a "
        f"decode chunk of {eng.decode_chunk} steps under torch's sync check: "
        f"no hidden sync, launches {rec['decode_chunk_launches']}",
        f"{tag}: one decode step ({eng.max_batch} slots, {cfg.n_layers} "
        f"layers): wall {step['wall_ms']:.2f} ms, {busy}; launches "
        f"{step['launches']}",
        f"{tag}: one {eng.prefill_chunk}-token prefill chunk ({cfg.n_layers} "
        f"layers): " + prefill_line(chunk) + f"; launches {chunk['launches']}",
        f"{tag}: parity, 128-token forward, lut_pallas vs lut_xla (per_row), "
        f"max |logit diff| {rec['parity_max_abs_diff']} (tolerance 0: exact),"
        f" max |logit| {rec['parity_max_abs_logit']:.4g}"]


def bitnet(flush):
    """Phase 8: full-width paper-bitnet-3b (ternary, per_row INT8 tables,
    lut_pallas, fusion auto), random weights from seed 0 made on the card
    layer by layer. (a) phase 3's checks at its shapes: ``check_kernels``
    in every table mode and on ``dequant_mpgemm`` at the (N, K) of its
    projections and head with ternary weights (per_row bit-exact, the bf16
    paths within BOUND_REL · Σ|a·w| + 1e-6 of each output: ternary outputs
    are ~100x phase 3's, beyond a fixed atol), ``precompute_checks`` at its
    K;
    (b)
    ``resolve_dispatch`` for each projection at M = 4 and 128, and the
    shared tables' choice (``layers.resolve_fusion``); (c) and (d)
    ``serve_and_parity``. Returns (config, engine, record)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import scheme_name
    from repro_torch.models import api, layers
    from repro_torch.models.quantized import quantized_bytes
    cfg = bitnet_config()
    shapes = projection_shapes(cfg)
    rec = {"arch": BITNET, "scheme": scheme_name(cfg.quant)}
    rec["records"], rec["err"] = check_kernels(
        flush, sorted(set(shapes.values())), ternary_weight,
        scaled_bound=True)
    rec["precompute_records"] = precompute_checks(
        flush, sorted({k for _, k in shapes.values()}))
    rec["err"]["row_scale"] = 0.0  # bit-equal, or precompute_checks raised

    # (b) the pipeline each projection takes at decode and prefill rows
    rec["dispatch"] = {f"M={m}": {
        name: ops.resolve_dispatch(m, n, k // KG, KG, BITS).fusion
        for name, (n, k) in shapes.items()} for m in ROWS}
    rec["shared_tables"] = {f"M={m}": {
        name: layers.resolve_fusion(m, k, cfg.quant)
        for name, k in (("qkv", cfg.d_model), ("gate+up", cfg.d_model))}
        for m in ROWS}

    # (c), (d): serve and parity at full width
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = api.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["param_bytes"] = quantized_bytes(params)
    rec["layer_bytes"] = quantized_bytes(params["layers"])
    rec["lm_head_bytes"] = quantized_bytes({"lm_head": params["lm_head"]})
    eng, served = serve_and_parity("bitnet", cfg, params)
    rec.update(served)
    return cfg, eng, rec


def bound_seeds(card) -> int:
    """``--bound-seeds``: phase 8 (a)'s checks of the bf16 paths at
    paper-bitnet-3b's shapes, ternary weights, for seeds 0, 1 and 2: the
    largest ratio of |kernel - plain| to the bound, and of the one-term
    bf16 control, per kernel and table mode and over every shape and M.
    One line of JSON."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    shapes = sorted(set(projection_shapes(bitnet_config()).values()))
    out = {}
    for seed in (0, 1, 2):
        records, _ = check_kernels(flush, shapes, ternary_weight,
                                   paths=("dequant", None, "per_group"),
                                   scaled_bound=True, seed=seed)
        for r in records:
            if "bound_ratio" in r:
                got = out.setdefault(f"seed {seed}", {}).setdefault(
                    f"{r['kernel']} {r['table_quant']}", [0.0, 0.0])
                got[0] = max(got[0], r["bound_ratio"])
                got[1] = max(got[1], r["control_ratio"])
    print("bound seeds: largest (kernel, one bf16 term) ratio to "
          f"{BOUND_REL} · Σ|a·w| + 1e-6: {json.dumps(out)}", flush=True)
    print(json.dumps({"bound_seeds": out, "card": card}))
    return 0


def bitnet_lines(cfg, eng, rec):
    """Phase 8's record as text, one line a part."""
    disp = rec["dispatch"]
    decode_fused = all(v == "fused" for v in disp["M=4"].values())
    prefill_staged = all(v == "staged" for v in disp["M=128"].values())
    return [
        f"bitnet: {cfg.arch_id} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{rec['scheme']}, per_row tables, lut_pallas, fusion auto): params "
        f"made on the card in {rec['init_s']:.1f} s, "
        f"{rec['param_bytes'] / 1e6:.1f} MB on the card, of which packed "
        f"layers and norms {rec['layer_bytes'] / 1e6:.1f} MB, lm_head "
        f"{rec['lm_head_bytes'] / 1e6:.1f} MB",
        "bitnet: table_precompute and row_scale at its K, bit-equal to the "
        "plain versions: " + "; ".join(
            precompute_line(r) for r in rec["precompute_records"]),
        "bitnet: kernels at its shapes, ternary weights, against the plain "
        "versions (per_row bit-exact; None, per_group and dequant_mpgemm "
        f"within {BOUND_REL} · Σ|a·w| + 1e-6 of each output): " + "; ".join(
            record_line(r) for r in rec["records"]),
        f"bitnet: resolve_dispatch {json.dumps(disp)}; shared tables "
        f"{json.dumps(rec['shared_tables'])}; decode "
        + ("fused" if decode_fused else "NOT fused at every projection")
        + ", prefill " + ("staged" if prefill_staged
                          else "NOT staged at every projection"),
    ] + serve_lines("bitnet", cfg, eng, rec)


def decoding_phase(cfg, params, greedy=None):
    """Phase 9 (module docstring) on phase 4's model and prompts;
    ``greedy``: phase 4's greedy lut_pallas streams (served here when not
    given). Returns the record."""
    from repro_torch.serving.engine import Request, ServingEngine
    t_start = time.perf_counter()
    xla = cfg.with_quant(mpgemm_mode="lut_xla", table_quant="per_row")
    prompts = serve_prompts(cfg.vocab_size, seed=2)
    if greedy is None:
        greedy = [r.output for r in serve(cfg, params, seed=2)[1]]
    rec, legs = {}, {}

    def run(tag, c, pool, eng=None, **engine_kw):
        """Serves ``pool`` ((prompt index, decoding) pairs, 16 new tokens
        each) on a new engine (or ``eng``); records the leg's decode tok/s
        and host syncs per token, which must be <= 1/decode_chunk."""
        eng = eng or ServingEngine(c, params, **SERVE_KW, **engine_kw)
        reqs = [Request(uid=i, prompt=prompts[p], max_new_tokens=16,
                        decoding=d) for i, (p, d) in enumerate(pool)]
        syncs, toks, chunk_s = (eng.decode_syncs, eng.decode_tokens,
                                eng._h_chunk_s.total)
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        torch.cuda.synchronize()
        n_tok = eng.decode_tokens - toks
        per_tok = (eng.decode_syncs - syncs) / max(1, n_tok)
        legs[tag] = {"decode_tok_s": n_tok / (eng._h_chunk_s.total
                                              - chunk_s),
                     "host_syncs_per_token": per_tok,
                     "seconds": time.perf_counter() - t0}
        if not all(r.done for r in reqs) or per_tok > 1 / eng.decode_chunk:
            raise AssertionError(f"decoding {tag}: {legs[tag]}, done "
                                 f"{[r.done for r in reqs]}")
        return eng, reqs

    def hyps(req):
        return [(list(t), sc) for t, sc in req.beams]

    # (a) beam and greedy in one pool, through the kernels vs lut_xla
    pool = [(0, "beam:2"), (1, "greedy"), (2, "greedy")]
    reset_counts()
    eng_a, reqs_a = run("a_lut_pallas", cfg, pool)
    rec["launches"] = read_counts()
    if min(rec["launches"][n] for n in PER_ROW_PATH) <= 0:
        raise AssertionError(f"decoding (a): a kernel never ran: "
                             f"{rec['launches']}")
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng_a._decode_general(has_beam=True, has_spec=False, sampling=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    chunk = read_counts()
    per_step = (len(projection_shapes(cfg)) - 1) * cfg.n_layers + 1
    want = dict({n: 0 for n in chunk},
                fused_lut_mpgemm=per_step * eng_a.decode_chunk,
                row_scale=per_step * eng_a.decode_chunk)
    if chunk != want:
        raise AssertionError(f"decoding (a): a beam decode chunk launched "
                             f"{chunk}, not {want}")
    rec["beam_chunk_launches"] = chunk
    _, reqs_x = run("a_lut_xla", xla, pool)
    if ([r.output for r in reqs_a] != [r.output for r in reqs_x]
            or hyps(reqs_a[0]) != hyps(reqs_x[0])):
        raise AssertionError("decoding (a): lut_pallas and lut_xla serve the "
                             "mixed pool differently")
    if len(reqs_a[0].beams) != 2:
        raise AssertionError(f"decoding (a): {len(reqs_a[0].beams)} beams")
    rec["beams"] = hyps(reqs_a[0])
    _, (beam1,) = run("a_beam1", cfg, [(0, "beam:1")])
    if beam1.output != greedy[0]:
        raise AssertionError("decoding (a): beam:1 differs from greedy")

    # (b) the beam request through the paged pool with prefix caching
    eng_b = ServingEngine(cfg, params, **SERVE_KW, cache_block_size=16,
                          prefix_cache=True)
    rec["paged_blocks"] = []
    for rep in range(2):
        before = eng_b.stats()["blocks_in_use"]
        _, (req,) = run(f"b_paged_{rep}", cfg, [(0, "beam:2")], eng=eng_b)
        st = eng_b.stats()
        rec["paged_blocks"].append((before, st["blocks_in_use"],
                                    st["prefix_cache"]["entries"]))
        if hyps(req) != rec["beams"]:
            raise AssertionError("decoding (b): paged beams differ from (a)")
        if (st["blocks_in_use"] != st["prefix_cache"]["entries"]
                or (rep and st["blocks_in_use"] != before)):
            raise AssertionError(f"decoding (b): blocks in use "
                                 f"{rec['paged_blocks']}")
    rec["paged_reused"] = eng_b.stats()["prefill_tokens_reused"]

    # (c) self-speculation under lut_xla. First, position 0 of the verify
    # forward against an s = 1 forward on the same caches (each slot at its
    # prompt's end)
    eng = ServingEngine(xla, params, **SERVE_KW)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
    eng._admit()
    drafts = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 4)), device=eng.device)
    one = eng._forward(params, eng.last_tok[:, None], eng.pos)[:, 0]
    burst = eng._forward(params, torch.cat([eng.last_tok[:, None], drafts],
                                           dim=1), eng.pos)
    rec["verify_pos0_max_abs_diff"] = (one - burst[:, 0]).abs().max().item()
    rec["spec"] = {}
    for planes in (1, 2):
        eng_c, reqs_c = run(f"c_spec_draft{planes}b", xla,
                            [(i, f"spec:draft{planes}b") for i in range(4)],
                            spec_k=4, spec_draft_planes=planes)
        sp = eng_c.stats()["spec"]
        rec["spec"][planes] = sp
        if [r.output for r in reqs_c] != greedy:
            raise AssertionError(
                f"decoding (c): greedy spec with a {planes}-plane draft "
                f"differs from phase 4's greedy streams (verify position 0 "
                f"vs s = 1: max |logit diff| "
                f"{rec['verify_pos0_max_abs_diff']})")
        if sp["draft_extra_hbm_bytes"] != 0 or (
                planes == 2 and sp["mean_accepted_per_step"] < 3.0):
            raise AssertionError(f"decoding (c): spec stats {sp}")

    # (d) no fallback: the kernels refuse the plane-sliced draft
    eng_d = ServingEngine(cfg, params, **SERVE_KW, spec_k=4,
                          spec_draft_planes=1)
    eng_d.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=4,
                         decoding="spec:draft1b"))
    try:
        eng_d.run_to_completion()
    except NotImplementedError as e:
        rec["lut_pallas_spec_raises"] = str(e)
    else:
        raise AssertionError("decoding (d): spec under lut_pallas ran")
    torch.cuda.synchronize()
    rec["legs"] = legs
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def decoding_lines(rec):
    """Phase 9's record as text, one line a part."""
    legs = "; ".join(f"{k} {v['decode_tok_s']:.1f} tok/s, host syncs/token "
                     f"{v['host_syncs_per_token']:.4f}, {v['seconds']:.1f} s"
                     for k, v in rec["legs"].items())
    spec = "; ".join(
        f"{p}-plane draft: {sp['verify_steps']} verify rounds, "
        f"{sp['accepted_draft_tokens']} drafts accepted, "
        f"{sp['mean_accepted_per_step']:.3f} accepted and "
        f"{sp['mean_emitted_per_step']:.3f} emitted a round, "
        f"{sp['draft_extra_hbm_bytes']} extra weight bytes"
        for p, sp in rec["spec"].items())
    return [
        f"decoding: (a) beam:2 + 2 greedy under lut_pallas equal lut_xla "
        f"(outputs, hypotheses, scores), beam:1 equals phase 4's greedy "
        f"stream; launches {rec['launches']}; a beam decode chunk under "
        f"torch's sync check: no hidden sync, launches "
        f"{rec['beam_chunk_launches']}; hypotheses (tokens, score) "
        f"{rec['beams']}",
        f"decoding: (b) paged (block 16, prefix cache) beams equal (a)'s; "
        f"(blocks in use before, after, prefix entries) per run "
        f"{rec['paged_blocks']}, {rec['paged_reused']} prompt tokens reused",
        f"decoding: (c) greedy spec under lut_xla, k 4, equals phase 4's "
        f"greedy streams: {spec}; verify position 0 vs an s = 1 forward, max "
        f"|logit diff| {rec['verify_pos0_max_abs_diff']}",
        f"decoding: (d) spec under lut_pallas raises NotImplementedError: "
        f"{rec['lut_pallas_spec_raises']}",
        f"decoding: legs: {legs}; phase 9 in {rec['seconds']:.1f} s"]


# phase 10: the tuner's candidates and timed repeats a shape
TUNE_CANDIDATES = 4
TUNE_REPEATS = 5


def step_wall_ms(eng):
    """Mean host wall of a decode step over the engine's decode chunks (its
    chunk histogram: dispatch to the chunk's one sync)."""
    h = eng._h_chunk_s
    return h.total / max(1, h.count) / eng.decode_chunk * 1e3


def traced_step_walls(eng, tracer, rounds=4):
    """Median host wall (ms) of a decode step, a decode chunk at a time
    ending in one sync as in ``step``, with what the tracer adds to a chunk
    (its torch.profiler annotation around the chunk, the span recorded
    after the sync) and without, in turns (off, on, on, off) ``rounds``
    times."""
    walls = {"off": [], "on": []}
    for _ in range(rounds):
        for on in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            with (tracer.annotation("decode_chunk") if on
                  else contextlib.nullcontext()):
                eng._decode_chunk(sampling=False)
                torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
            if on:
                tracer.complete("decode_chunk", t0, t1, cat="decode")
            walls["on" if on else "off"].append(
                (t1 - t0) / 1e6 / eng.decode_chunk)
    return {k: float(np.median(v)) for k, v in walls.items()}


def telemetry_phase(cfg, params, phase4=None):
    """Phase 10 (module docstring) on phase 4's model, engine and requests;
    ``phase4``: phase 4's (greedy streams, decode syncs), served here when
    not given. Returns the record."""
    from repro_torch.core import autotune
    from repro_torch.core import mpgemm as mp
    from repro_torch.kernels import _build, ops
    from repro_torch.obs import dispatch as dispatch_obs
    from repro_torch.obs.trace import Tracer, validate_chrome_trace
    from repro_torch.serving.engine import ServingEngine
    t_start = time.perf_counter()
    if phase4 is None:
        eng, reqs = serve(cfg, params, seed=2)
        phase4 = ([r.output for r in reqs], eng.decode_syncs)
    greedy, syncs = phase4
    rec = {}

    def summary(drec):
        out = {k: v for k, v in drec.summary().items() if k != "records"}
        out["dispatches"] = sum(r.count for r in drec.records("dispatch"))
        return out

    # (a) traced serves (tracer with its torch.profiler annotation, and a
    # dispatch recorder) in turns with untraced ones: tokens and syncs of
    # phase 4, a valid trace
    walls = []
    for on in (False, True, True, False):
        tracer = Tracer() if on else None
        with dispatch_obs.recording() as drec:
            eng, reqs = serve(cfg, params, seed=2, tracer=tracer)
        walls.append(step_wall_ms(eng))
        if [r.output for r in reqs] != greedy or eng.decode_syncs != syncs:
            raise AssertionError(
                f"telemetry (a): tracer {'on' if on else 'off'}: tokens or "
                f"decode syncs ({eng.decode_syncs}; phase 4: {syncs}) differ "
                f"from phase 4's")
        if on and "trace" not in rec:
            evs = tracer.chrome_trace()["traceEvents"]
            check = validate_chrome_trace(evs)
            spans = sum(e["name"] == "decode_chunk" for e in evs)
            ph = check["by_phase"]
            disp = summary(drec)
            if (spans != eng.decode_syncs or ph.get("b") != len(reqs)
                    or ph.get("e") != len(reqs)
                    or disp["heuristic"] != disp["decisions"]):
                raise AssertionError(f"telemetry (a): trace {check}, "
                                     f"{spans} decode_chunk spans, "
                                     f"dispatch {disp}")
            rec["trace"] = dict(check, decode_chunk_spans=spans,
                                dispatch=disp, stats=eng.stats())
            rec["step_wall_ms_chunks"] = traced_step_walls(eng, tracer)
    rec["step_wall_ms_tracer_off_on_on_off"] = walls

    # (b) pretune every dispatched shape at M = 4 and 128, then the same
    # serve with fusion="tuned" from the saved cache
    path = _build.BUILD_DIR / "tuning_cache.json"
    if path.exists():
        path.unlink()
    tcfg = cfg.with_quant(fusion="tuned")
    teng = ServingEngine(tcfg, params, **SERVE_KW, tuning_cache=str(path))
    t0 = time.perf_counter()
    n_tuned = teng.pretune(repeats=TUNE_REPEATS,
                           max_candidates=TUNE_CANDIDATES)
    rec["pretune_seconds"] = time.perf_counter() - t0
    qws = autotune.collect_qw_shapes(params)
    ms = (SERVE_KW["max_batch"], SERVE_KW["prefill_chunk"])
    dev = params["embed"]["table"].device
    tq = mp.resolve_table_quant(cfg.quant["table_quant"], dev)
    if n_tuned != len(ms) * len(qws):
        raise AssertionError(f"telemetry (b): pretuned {n_tuned} shapes, "
                             f"not {len(ms) * len(qws)}")
    rec["tuned"] = []
    for qw in qws:
        for m in ms:
            key = autotune.shape_key(m, qw.n, qw.g, qw.k_group,
                                     qw.num_planes, table_quant=tq)
            best = teng.tuning_cache.entries[key]
            rec["tuned"].append(dict(
                key=key, m=m, n=qw.n, k=qw.k_total, winner=best.knobs,
                winner_ms=best.steady_ms, heuristic_ms=best.heuristic_ms,
                first_call_ms=best.compile_ms))
    reset_counts()
    with dispatch_obs.recording() as drec:
        eng, reqs = serve(tcfg, params, seed=2, tuning_cache=str(path))
        st = eng.stats()
    launches = read_counts()
    disp = summary(drec)
    if disp["decisions"] == 0 or disp["tuned"] != disp["decisions"]:
        raise AssertionError(f"telemetry (b): not every dispatch tuned: "
                             f"{disp}")
    if [r.output for r in reqs] != greedy:
        raise AssertionError("telemetry (b): the tuned serve's tokens "
                             "differ from phase 4's")
    rec["tuned_serve"] = dict(dispatch=disp, launches=launches,
                              tuning_cache=st["tuning_cache"],
                              decode_tok_s=st["decode_tok_s"],
                              host_syncs_per_token=st["host_syncs_per_token"])
    # a decode step and a prefill chunk, auto and tuned in turns
    auto_eng = ServingEngine(cfg, params, **SERVE_KW)
    rec["auto_tuned_tuned_auto"] = [step_and_chunk(e) for e in (
        auto_eng, eng, eng, auto_eng)]

    # (c) every candidate against the heuristic plan on the same operands:
    # per_row bit-equal; float tables within phase 3's bound of the plain
    # path
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    n_int = n_f32 = 0
    f32_err = 0.0
    for qw in qws:
        for m in ms:
            args = (m, qw.n, qw.g, qw.k_group, qw.num_planes)
            x = torch.randn(m, qw.k_total, generator=gen, device=dev)
            want = ops.lut_mpgemm(x, qw, table_quant="per_row")
            for c in autotune.candidate_configs(
                    *args, max_candidates=TUNE_CANDIDATES):
                got = ops.lut_mpgemm(x, qw, table_quant="per_row",
                                     fusion=c.fusion, tile=c.tile,
                                     splits=c.splits)
                if not torch.equal(got, want):
                    raise AssertionError(f"telemetry (c): per_row {args} "
                                         f"{c.knobs} differs from the "
                                         f"heuristic plan")
                n_int += 1
            plain = mp.mpgemm(x, qw, mode="lut_xla", table_quant=None)
            big = plain.abs().max().item()
            for c in autotune.candidate_configs(
                    *args, table_quant=None, max_candidates=TUNE_CANDIDATES):
                got = ops.lut_mpgemm(x, qw, table_quant=None,
                                     fusion=c.fusion, tile=c.tile,
                                     splits=c.splits)
                diff = (got - plain).abs().max().item()
                f32_err = max(f32_err, diff / big)
                if diff > 1e-4 * big or not torch.allclose(
                        got, plain, rtol=1e-4, atol=1e-4):
                    raise AssertionError(f"telemetry (c): None {args} "
                                         f"{c.knobs}: max |diff| {diff}")
                n_f32 += 1
    autotune.deactivate()
    rec.update(per_row_candidates=n_int, f32_candidates=n_f32,
               f32_max_rel_err=f32_err,
               seconds=time.perf_counter() - t_start)
    return rec


def telemetry_lines(rec):
    """Phase 10's record as text, one line a part."""
    tr = rec["trace"]
    tuned = "; ".join(
        f"M={t['m']} (N, K)=({t['n']}, {t['k']}): {t['winner']} "
        f"{t['winner_ms']:.4f} ms vs heuristic {t['heuristic_ms']:.4f} ms"
        for t in rec["tuned"])
    turns = "; ".join(
        f"{tag} decode step wall {r['decode_step']['wall_ms']:.2f} ms busy "
        + ("not measured" if r["decode_step"]["busy_ms"] is None else
           f"{r['decode_step']['busy_ms']:.2f} ms")
        + f", prefill chunk wall {r['prefill_chunk']['wall_ms']:.2f} ms busy "
        + ("not measured" if r["prefill_chunk"]["busy_ms"] is None else
           f"{r['prefill_chunk']['busy_ms']:.2f} ms")
        for tag, r in zip(("auto", "tuned", "tuned", "auto"),
                          rec["auto_tuned_tuned_auto"]))
    ts = rec["tuned_serve"]
    return [
        f"telemetry: (a) traced serves: tokens and decode syncs equal "
        f"phase 4's; trace valid, {tr['events']} events {tr['by_phase']}, "
        f"{tr['decode_chunk_spans']} decode_chunk spans = syncs; dispatch "
        f"{tr['dispatch']}; decode step wall, serves with the tracer off, "
        f"on, on, off: " + ", ".join(
            f"{w:.2f}" for w in rec["step_wall_ms_tracer_off_on_on_off"])
        + " ms; chunks in turns, median: off "
        f"{rec['step_wall_ms_chunks']['off']:.2f} ms, on "
        f"{rec['step_wall_ms_chunks']['on']:.2f} ms",
        f"telemetry: (b) pretuned {len(rec['tuned'])} shapes in "
        f"{rec['pretune_seconds']:.1f} s ({TUNE_CANDIDATES} candidates, "
        f"{TUNE_REPEATS} repeats, device time): {tuned}",
        f"telemetry: (b) fusion=tuned serve from the saved cache: tokens "
        f"equal phase 4's, dispatch {ts['dispatch']}, cache "
        f"{ts['tuning_cache']}, decode {ts['decode_tok_s']:.1f} tok/s, host "
        f"syncs/token {ts['host_syncs_per_token']:.4f}, launches "
        f"{ts['launches']}; in turns: {turns}",
        f"telemetry: (c) {rec['per_row_candidates']} per_row candidates "
        f"bit-equal to the heuristic plan; {rec['f32_candidates']} "
        f"float-table candidates within rtol = atol = 1e-4 of the plain "
        f"path (max |diff| / max |out| {rec['f32_max_rel_err']:.3g}); "
        f"phase 10 in {rec['seconds']:.1f} s"]


# phase 11: the MoE family, full-width olmoe-1b-7b (64 experts, top-8, W2
# experts, float attention)
MOE = "olmoe-1b-7b"
# rows an expert (capacity C) at a decode step of 4 slots and at a 128-token
# prefill chunk: max(8, ⌈t·k·1.25 / E⌉ rounded up to 8)
MOE_ROWS = (8, 24)
BATCHED = ("lut_mpgemm_batched", "fused_lut_mpgemm_batched")


def moe_config():
    from repro_torch.configs import registry
    return registry.get_config(MOE).replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_pallas",
                                                   fusion="auto")


def random_experts(gen, e, n, k):
    """E experts' random W2 weights [E, N, K/4] bytes, scales [E, N]."""
    from repro_torch.core.quantize import QuantizedWeight
    packed = torch.randint(0, 256, (e, n, k * BITS // 8), generator=gen,
                           device="cuda", dtype=torch.uint8)
    scale = torch.rand(e, n, generator=gen, device="cuda") * 0.01 + 1e-3
    return QuantizedWeight(packed, scale, None, (1.0, 2.0), bits=BITS,
                           k_group=KG, k_total=k, n=n)


def expert_kernel_checks(flush, cfg, seed=0, modes=MODES):
    """Phase 11 (a): both LUT kernels' batched wrappers at olmoe's expert
    shapes, E = 64, C ∈ MOE_ROWS, (N, K) of gate/up and down, every table
    mode, on operands padded as ``ops`` pads them (each expert's C rows to
    the tile's rows, Cp; channels and K-groups to the tile): per_row
    bit-equal to the plain version (the 2-D plain version per expert), the
    bf16 paths within BOUND_REL · Σ|a·w| + 1e-6 of it at every output
    (phase 8 (a)'s bound); every mode bit-equal to E launches of the 2-D
    kernel, one an expert, on the same plan (tile and split-K count S);
    one batched launch a call and no 2-D one. Timed with ``time_ms``: the
    batched kernel, the E 2-D launches, the plain version, a bf16
    ``torch.bmm`` of the same [E, C, K] x [E, K, N], and the bound (all E
    experts' packed weights and scales, the activations or table of the
    C real rows, the outputs; 2·E·C·N·K int8 operations per_row, three
    bf16 passes on float tables, plus the table adds where the kernel
    builds the table). ``modes``: the table modes checked (phase 19: per_row
    at E = 32, a rank's experts). Returns (records, max |diff| a
    kernel)."""
    from repro_torch.core import table as T
    from repro_torch.core.quantize import dequantize
    from repro_torch.kernels import fused_lut_mpgemm as fk
    from repro_torch.kernels import lut_mpgemm as lk
    from repro_torch.kernels import ops
    from repro_torch.kernels import table_precompute as tk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    ne, ent = cfg.num_experts, 1 << (KG - 1)
    shapes = ((cfg.d_ff, cfg.d_model), (cfg.d_model, cfg.d_ff))
    records, err = [], {name: 0.0 for name in BATCHED}
    for c in MOE_ROWS:
        for n, k in shapes:
            g = k // KG
            x = torch.randn(ne, c, k, generator=gen, device="cuda")
            qw = random_experts(gen, ne, n, k)
            x_bf16 = x.to(torch.bfloat16)
            w_bf16 = torch.stack([dequantize(qw.expert(i)).T for i in
                                  range(ne)]).to(torch.bfloat16).contiguous()
            library = lambda: torch.bmm(x_bf16, w_bf16)
            pw = dict(k_group=KG, planes=BITS, plane_scales=qw.plane_scales)
            for tq in modes:
                for name in BATCHED:
                    fused = name == "fused_lut_mpgemm_batched"
                    config, bm, bn, bg = ops._expert_tile(c, KG, BITS, tq,
                                                          fused)
                    cp = -(-c // bm) * bm
                    xp = ops._pad_to(ops._pad_to(x, cp, 1), bg * KG, 2)
                    xp = xp.reshape(ne * cp, -1).contiguous()
                    gp = xp.shape[1] // KG
                    rs = (tk.row_scale_plain(xp, KG).contiguous()
                          if tq == "per_row" else None)
                    if fused:
                        pkp, wsp = ops._pad_packed(qw, gp, bn)
                        ops_ = (xp, rs, pkp, wsp)
                        kw = dict(pw, table_quant=tq)
                        mod, one = fk, fk.fused_lut_mpgemm
                        plan = fk.int_plan if tq == "per_row" else lk.f32_plan
                        _, s, _ = plan(ne * cp, pkp.shape[1], gp, KG, BITS,
                                       config)
                        tables = tk.table_precompute_plain(xp, KG, tq, rs)
                    else:
                        tv, ts = tk.table_precompute_plain(xp, KG, tq, rs)
                        ops_ = ops.staged_operands(T.Table(
                            tv.reshape(ne * cp, g, ent),
                            None if ts is None
                            else ts.reshape(ne * cp, -1, 1), None, KG),
                            qw, config)
                        kw, mod, one = pw, lk, lk.lut_mpgemm
                        _, s, _ = lk.staged_plan(
                            int(tq == "per_row"), ne * cp, ops_[2].shape[1],
                            ops_[0].shape[1] // ent, KG, BITS, config)
                        tables = ops_[:2]
                    batched = getattr(mod, name)
                    plain = getattr(mod, name + "_plain")
                    call = lambda: batched(*ops_, tile=config, **kw)
                    what = (f"{name} C={c} N={n} K={k} table_quant={tq}")
                    before = (mod.launches, mod.batched_launches)
                    got = call()
                    if (mod.launches, mod.batched_launches) != (
                            before[0], before[1] + 1):
                        raise AssertionError(f"{what}: not one batched "
                                             f"launch a call")
                    want = plain(*ops_, **kw)
                    rows = lambda t, i: (None if t is None
                                         else t[i * cp:(i + 1) * cp])
                    loop = lambda: [one(
                        rows(ops_[0], i), rows(ops_[1], i), ops_[2][i],
                        ops_[3][i], tile=config, splits=s, **kw)
                        for i in range(ne)]
                    per_expert = torch.cat(loop())
                    if not torch.equal(got, per_expert):
                        raise AssertionError(f"{what}: not bit-equal to "
                                             f"{ne} 2-D launches")
                    diff = (got - want).abs().max().item()
                    err[name] = max(err[name], diff)
                    ratio = None
                    if tq == "per_row":
                        if diff != 0.0:
                            raise AssertionError(f"{what}: per_row must be "
                                                 f"bit-exact, |diff| {diff}")
                    else:
                        sums = torch.cat([lut_sums(
                            rows(tables[0], i), rows(tables[1], i),
                            ops_[2][i], ops_[3][i], **pw)
                            for i in range(ne)])
                        ratio = ((got - want).abs() / (BOUND_REL * sums
                                                       + 1e-6)).max().item()
                        if not ratio <= 1.0:
                            raise AssertionError(
                                f"{what}: |diff| exceeds {BOUND_REL} · "
                                f"Σ|a·w| + 1e-6 (ratio {ratio:.3g})")
                    pk_bytes = qw.packed.numel() + 4 * ne * n
                    rows_ = ne * c
                    if tq == "per_row":
                        nops = {"int8": 2 * rows_ * n * k}
                        tbl_bytes = rows_ * g * ent + 4 * rows_
                    else:
                        nops = {"bf16": lk.F32_PASSES * 2 * rows_ * n * k}
                        tbl_bytes = (4 * rows_ * g * ent if tq is None
                                     else rows_ * g * ent + 4 * rows_ * g)
                    if fused:
                        nops["f32"] = rows_ * g * ent * (KG - 1)
                        in_bytes = 4 * rows_ * k + (4 * rows_ if rs is not None
                                                    else 0)
                    else:
                        in_bytes = tbl_bytes
                    b_ms, b_by = bound(in_bytes + pk_bytes + 4 * rows_ * n,
                                       nops)
                    records.append({
                        "kernel": name, "experts": ne, "c": c, "cp": cp,
                        "n": n, "k": k, "table_quant": tq, "tile": config,
                        "splits": s, "max_abs_err": diff,
                        "bound_ratio": ratio,
                        "kernel_ms": time_ms(call, 10, flush),
                        "two_d_loop_ms": time_ms(loop, 5, flush),
                        "plain_ms": time_ms(lambda: plain(*ops_, **kw), 2,
                                            flush),
                        "library_ms": time_ms(library, 10, flush),
                        "bound_ms": b_ms, "bound_by": b_by})
    return records, err


# each phase 11 serve's own kernels: (launched, not launched). Under
# fusion auto every expert projection is a batched fused lookup with its
# row scale, the head a 2-D fused one at decode; under fusion staged a
# batched staged lookup on a precomputed table, the head a 2-D staged one
MOE_PATHS = {
    "auto": (("fused_lut_mpgemm_batched", "row_scale", "fused_lut_mpgemm"),
             "lut_mpgemm_batched"),
    "staged": (("lut_mpgemm_batched", "table_precompute", "lut_mpgemm"),
               "fused_lut_mpgemm_batched")}


def moe_serve(cfg, params):
    """Phase 11 (b): phase 4's engine and request shapes (prompt tokens from
    olmoe's vocab), served twice, each serve with the launch counts set to
    0 just before it and read just after it: ``fusion="auto"`` (the main
    path, the default: every expert projection fused) and
    ``fusion="staged"`` (what ``--fusion staged`` serves: the batched
    staged kernel, gate and up on one shared table). Each serve launched
    its own kernels (``MOE_PATHS``) and not the other's batched lookup;
    both finish every request with <= 1 / decode_chunk host syncs a token
    and give the same tokens (per_row fused equals staged bit for bit).
    Then one more auto decode chunk under torch's sync check: exactly one
    batched fused launch and one row scale a step for each of the 3·L
    expert projections, one fused launch and one row scale for the head,
    nothing else; and one decode step and one 128-token prefill chunk
    profiled. Returns (engine, record)."""
    from repro_torch.kernels import ops
    serve(cfg, params, seed=1)  # warm-up: lazy CUDA/cuBLAS state, kernels
    reset_counts()
    eng, reqs = serve(cfg, params, seed=2)
    launches = read_counts()
    reset_counts()
    staged_eng, staged_reqs = serve(cfg.with_quant(fusion="staged"), params,
                                    seed=2)
    staged_launches = read_counts()
    st = eng.stats()
    outputs = [r.output for r in reqs]
    if not all(r.done and len(r.output) == 16 for r in reqs + staged_reqs):
        raise AssertionError("moe: not every request finished 16 tokens")
    if [r.output for r in staged_reqs] != outputs:
        raise AssertionError("moe: the staged serve's tokens differ from "
                             "the fused serve's")
    for path, counts in (("auto", launches), ("staged", staged_launches)):
        ran, other = MOE_PATHS[path]
        if min(counts[n] for n in ran) <= 0 or counts[other] != 0:
            raise AssertionError(f"moe: the fusion={path} serve launched "
                                 f"{counts}: wanted {ran} > 0, {other} 0")
    for e in (eng, staged_eng):
        if e.stats()["host_syncs_per_token"] > 1.0 / e.decode_chunk:
            raise AssertionError(f"moe: {e.stats()['host_syncs_per_token']} "
                                 f"host syncs per token")
    experts = 3 * cfg.n_layers
    chunk_launches = checked_decode_chunk("moe", eng, {
        "fused_lut_mpgemm_batched": experts, "fused_lut_mpgemm": 1,
        "row_scale": experts + 1})
    d, f, g = cfg.d_model, cfg.d_ff, cfg.d_model // KG
    return eng, dict(
        prompts=[len(r.prompt) for r in reqs], serve=st,
        staged_serve=staged_eng.stats(), outputs=outputs, launches=launches,
        staged_launches=staged_launches, decode_chunk_launches=chunk_launches,
        dispatch={f"C={c}": {
            "gate/up": ops.resolve_dispatch(
                c, f, g, KG, BITS, experts=cfg.num_experts).fusion,
            "down": ops.resolve_dispatch(
                c, d, f // KG, KG, BITS, experts=cfg.num_experts).fusion}
            for c in MOE_ROWS},
        **step_and_chunk(eng))


def moe_parity(cfg, params):
    """Phase 11 (c): a teacher-forced 128-token forward through the kernels
    (lut_pallas) and the plain LUT path (lut_xla), per_row: logits equal bit
    for bit (routing, drops and the combine are the same code; per_row
    lookups are exact integer sums)."""
    from repro_torch.models import api
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")
    logits = {mode: api.forward(params, {"tokens": toks}, cfg.with_quant(
        mpgemm_mode=mode, table_quant="per_row"))[0]
        for mode in ("lut_pallas", "lut_xla")}
    a, b = logits["lut_pallas"], logits["lut_xla"]
    if (tuple(a.shape) != (1, 128, cfg.vocab_size)
            or not torch.isfinite(a).all()):
        raise AssertionError(f"moe: bad logits {tuple(a.shape)}")
    diff = (a - b).abs().max().item()
    if diff != 0.0:
        raise AssertionError(f"moe: kernels and plain path disagree, max "
                             f"|logit diff| {diff}")
    return {"parity_max_abs_diff": diff,
            "parity_max_abs_logit": a.abs().max().item()}


def moe_paged(cfg, params):
    """Phase 11 (d): phase 6's eight prompts (six share a 144-token system
    prompt, two equal 160-token ones) through the dense engine and the
    block-paged pool (block 16, 96 blocks) without prefix sharing: equal
    streams. Then once with prefix sharing: a prefix hit prefills only the
    suffix, whose shorter chunk has another capacity, so its drops (and
    tokens) may differ from the dense engine's; the tokens that agree and
    the prompt tokens reused are recorded."""
    from repro_torch.serving.engine import Request, ServingEngine
    bs = 16
    prompts = paged_prompts(cfg.vocab_size, bs)
    kw = dict(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=128)
    paged_kw = dict(kw, cache_block_size=bs, num_cache_blocks=96)

    def run(**engine_kw):
        eng = ServingEngine(cfg, params, **engine_kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        torch.cuda.synchronize()
        if not all(r.done and len(r.output) == 16 for r in reqs):
            raise AssertionError("moe paged: a request did not finish")
        return eng, [r.output for r in reqs]

    _, dense = run(**kw)
    _, unshared = run(**paged_kw)
    if unshared != dense:
        raise AssertionError("moe paged: without prefix sharing the streams "
                             "differ from the dense engine's")
    eng, shared = run(**paged_kw, prefix_cache=True)
    agree = sum(x == y for a, b in zip(shared, dense) for x, y in zip(a, b))
    st = eng.stats()
    return {"tokens": 16 * len(prompts), "prefix_agreeing_tokens": agree,
            "prefix_equal_streams": sum(a == b for a, b in zip(shared,
                                                                dense)),
            "prefill_tokens_reused": st["prefill_tokens_reused"],
            "prefill_tokens": st["prefill_tokens"],
            "prefix_cache": st["prefix_cache"]}


def moe_phase(flush):
    """Phase 11: full-width olmoe-1b-7b (16 layers, d_model 2048, MHA
    16/16, 64 experts of d_ff 1024, top-8, vocab 50304), W2 symmetric K=4
    experts and head, float attention, per_row tables, lut_pallas, fusion
    auto, random weights from seed 0 made on the card layer by layer:
    (a) ``expert_kernel_checks``, (b) ``moe_serve``, (c) ``moe_parity``,
    (d) ``moe_paged``. Returns (config, engine, record)."""
    from repro_torch.launch.serve import scheme_name
    from repro_torch.models import api
    from repro_torch.models.quantized import quantized_bytes
    cfg = moe_config()
    rec = {"arch": MOE, "scheme": scheme_name(cfg.quant)}
    t0 = time.perf_counter()
    rec["records"], rec["err"] = expert_kernel_checks(flush, cfg)
    rec["kernels_s"] = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["init_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["param_bytes"] = quantized_bytes(params)
    rec["expert_bytes"] = quantized_bytes(
        [lp["moe"]["experts"] for lp in params["layers"]])
    rec["attention_bytes"] = quantized_bytes(
        [lp["attn"] for lp in params["layers"]])
    t0 = time.perf_counter()
    eng, served = moe_serve(cfg, params)
    rec.update(served)
    rec.update(moe_parity(cfg, params))
    rec["paged"] = moe_paged(cfg, params)
    rec["serve_s"] = time.perf_counter() - t0
    return cfg, eng, rec


def moe_lines(cfg, eng, rec):
    """Phase 11's record as text, one line a part."""
    lines = [
        f"moe: {cfg.arch_id} {rec['scheme']}: {cfg.n_layers} layers, "
        f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top-{cfg.top_k}; "
        f"params made on the card in {rec['init_s']:.1f} s (peak "
        f"{rec['init_peak_bytes'] / 1e9:.2f} GB), {rec['param_bytes'] / 1e9:.3f}"
        f" GB resident ({rec['expert_bytes'] / 1e9:.3f} GB packed experts, "
        f"{rec['attention_bytes'] / 1e9:.3f} GB float attention)",
        "moe: batched kernels at E=64 (per call: kernel / 64 2-D launches "
        "/ plain / bf16 torch.bmm / bound ms): " + "; ".join(
            f"{r['kernel']} C={r['c']} (Cp {r['cp']}) N={r['n']} K={r['k']} "
            f"{r['table_quant']} t{r['tile']} S{r['splits']}: "
            f"{r['kernel_ms']:.4f} / {r['two_d_loop_ms']:.4f} / "
            f"{r['plain_ms']:.2f} / {r['library_ms']:.4f} / "
            f"{r['bound_ms']:.4f} ({r['bound_by']})"
            + ("" if r["bound_ratio"] is None
               else f", bound ratio {r['bound_ratio']:.3g}")
            for r in rec["records"])
        + f" (per_row bit-exact, bf16 paths within {BOUND_REL} · Σ|a·w| + "
        f"1e-6, every mode bit-equal to 64 2-D launches; {rec['kernels_s']:.1f}"
        f" s)",
        f"moe: dispatch {rec['dispatch']}"]
    lines += serve_lines("moe", cfg, eng, rec)[:3]
    st = rec["staged_serve"]
    lines.append(f"moe: fusion=staged serve, same tokens; decode "
                 f"{st['decode_tok_s']:.1f} tok/s, host syncs/token "
                 f"{st['host_syncs_per_token']:.4f}; launches "
                 f"{rec['staged_launches']}")
    lines.append(f"moe: parity, 128-token forward, lut_pallas vs lut_xla "
                 f"(per_row), max |logit diff| {rec['parity_max_abs_diff']} "
                 f"(tolerance 0: exact), max |logit| "
                 f"{rec['parity_max_abs_logit']:.4g}")
    pg = rec["paged"]
    lines.append(f"moe: paged pool without sharing equals dense; with prefix "
                 f"sharing {pg['prefix_agreeing_tokens']} of {pg['tokens']} "
                 f"tokens agree with dense ({pg['prefix_equal_streams']} of 8 "
                 f"streams equal), {pg['prefill_tokens_reused']} prompt "
                 f"tokens reused, {pg['prefill_tokens']} prefilled; phase 11 "
                 f"serves in {rec['serve_s']:.1f} s")
    return lines


# phase 12: the SSM and hybrid families, full-width falcon-mamba-7b (Mamba1,
# attention-free, every projection W2) and zamba2-7b (Mamba2 groups, float
# Mamba projections, one shared W2 attention + MLP block)
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-7b")
# the depth phases 12, 13 and 15 serve these archs at (full width), so
# that the script keeps to its time limit: falcon-mamba-7b 16 of its 64
# layers, zamba2-7b 13 of its 81 (two invocations of the shared block, as
# phases 16 and 17 cut it), llama-3.2-vision-11b 10 of its 40 (two cross
# layers)
SERVE_DEPTH = {"falcon-mamba-7b": 16, "zamba2-7b": 13,
               "llama-3.2-vision-11b": 10}


def full_config(arch, whole=False):
    """An arch at full width as phases 12, 13 and 15 serve it (depth cut
    by ``SERVE_DEPTH`` unless ``whole``): f32 activations, lut_pallas,
    fusion auto."""
    from repro_torch.configs import registry
    cfg = registry.get_config(arch).replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_pallas",
                                                   fusion="auto")
    if arch in SERVE_DEPTH and not whole:
        cfg = cfg.replace(n_layers=SERVE_DEPTH[arch])
    return cfg


def packed_shapes(cfg):
    """{projection: (N, K)} of the packed projections a step runs: the
    Mamba1 layer's four and the head (falcon-mamba), the shared block's
    seven and the head (zamba2: its Mamba2 projections stay float), or the
    attention's, the MLP's and the head (the VLM: wk / wv also make the
    image K/V; whisper: every layer projection, the encoder's too, is one
    of its four shapes)."""
    if cfg.family in ("hybrid", "vlm", "audio"):
        shapes = projection_shapes(cfg)
        if cfg.family == "audio":  # a GELU MLP: up and down
            del shapes["gate"]
        return shapes
    d, di, r, ds = cfg.d_model, cfg.d_inner, cfg.dt_rank, cfg.ssm_state
    return {"in_proj": (2 * di, d), "x_proj": (r + 2 * ds, di),
            "dt_proj": (di, r), "out_proj": (d, di),
            "lm_head": (cfg.vocab_size, d)}


def projections_per_step(cfg) -> int:
    """Packed projections one forward runs: a layer's four per Mamba1
    layer, the shared block's seven per invocation, a self layer's seven
    and a cross layer's five (wq, wo and the MLP's three) in the VLM, a
    whisper decoder layer's eight (self attention's four, wq and wo of the
    cross attention, up and down), and the head."""
    if cfg.family == "hybrid":
        return 7 * (cfg.n_layers // cfg.attn_every) + 1
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.xattn_every
        return 7 * (cfg.n_layers - n_cross) + 5 * n_cross + 1
    if cfg.family == "audio":
        return 8 * cfg.n_layers + 1
    return 4 * cfg.n_layers + 1


def near_ties(tag, cfg, params, prompts, got, want):
    """Streams ``got`` against ``want``: equal, or diverging at a near tie
    (the top-2 logit margin of a full forward over the prompt and the
    agreed tokens <= MARGIN), after which that stream is not compared."""
    from repro_torch.models import api
    out = []
    for uid, (p, g, w) in enumerate(zip(prompts, got, want)):
        j = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if j is None:
            continue
        seq = torch.as_tensor(np.concatenate(
            [p, np.asarray(w[:j], dtype=np.int64)])[None], device="cuda")
        top2 = torch.topk(api.forward(params, {"tokens": seq}, cfg)[0][0, -1],
                          2).values
        margin = (top2[0] - top2[1]).item()
        out.append({"uid": uid, "position": j, "margin": margin})
        if margin > MARGIN:
            raise AssertionError(f"{tag}: request {uid} diverges at token "
                                 f"{j} with top-2 margin {margin} > {MARGIN}")
    return out


def family_serve(tag, cfg, params):
    """Phase 12 (b) / (d): phase 4's engine and request shapes (prompt
    tokens from the arch's vocab), a warm-up serve, then the serve with the
    launch counts set to 0 just before and read just after: every request
    finishes 16 tokens, every kernel of the per_row path ran (the fused
    lookup and its row scale in decode, the staged precompute and lookup in
    prefill), <= 1/decode_chunk host syncs a token. One more decode chunk
    under torch's sync check launches exactly one fused lookup and one row
    scale per packed projection a step (``projections_per_step``). The
    fusion of each projection at M = 4 and 128. Returns (engine,
    record)."""
    from repro_torch.kernels import ops
    serve(cfg, params, seed=1)  # warm-up: lazy CUDA/cuBLAS state, kernels
    reset_counts()
    eng, reqs = serve(cfg, params, seed=2)
    launches = read_counts()
    st = eng.stats()
    if not all(r.done and len(r.output) == 16 for r in reqs):
        raise AssertionError(f"{tag}: not every request finished 16 tokens")
    if min(launches[n] for n in PER_ROW_PATH) <= 0:
        raise AssertionError(f"{tag}: a kernel never ran: {launches}")
    if st["host_syncs_per_token"] > 1.0 / eng.decode_chunk:
        raise AssertionError(f"{tag}: {st['host_syncs_per_token']} host "
                             f"syncs per token > 1/{eng.decode_chunk}")
    per_step = projections_per_step(cfg)
    chunk_launches = checked_decode_chunk(tag, eng, {
        "fused_lut_mpgemm": per_step, "row_scale": per_step})
    return eng, dict(
        prompts=[len(r.prompt) for r in reqs], serve=st,
        outputs=[r.output for r in reqs], launches=launches,
        decode_chunk_launches=chunk_launches,
        dispatch={f"M={m}": {name: ops.resolve_dispatch(
            m, n, k // KG, KG, BITS).fusion for name, (n, k)
            in packed_shapes(cfg).items()} for m in ROWS})


def ssm_parity(tag, cfg, params):
    """A teacher-forced 128-token forward through the kernels (lut_pallas)
    and the plain LUT path (lut_xla), per_row: logits equal bit for bit
    (per_row lookups are exact integer sums; the scan, conv and float
    projections are the same torch ops on the same inputs)."""
    from repro_torch.models import api
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")
    logits = {mode: api.forward(params, {"tokens": toks}, cfg.with_quant(
        mpgemm_mode=mode, table_quant="per_row"))[0]
        for mode in ("lut_pallas", "lut_xla")}
    a, b = logits["lut_pallas"], logits["lut_xla"]
    if (tuple(a.shape) != (1, 128, cfg.vocab_size)
            or not torch.isfinite(a).all()):
        raise AssertionError(f"{tag}: bad logits {tuple(a.shape)}")
    diff = (a - b).abs().max().item()
    if diff != 0.0:
        raise AssertionError(f"{tag}: kernels and plain path disagree, max "
                             f"|logit diff| {diff}")
    return {"parity_max_abs_diff": diff,
            "parity_max_abs_logit": a.abs().max().item()}


def ssm_phase(flush):
    """Phase 12: the SSM and hybrid families at full width, random weights
    from seed 0 made on the card layer by layer, per_row tables,
    lut_pallas, fusion auto. (a) ``check_kernels`` (every table mode and
    ``dequant_mpgemm``, M ∈ {4, 128}; per_row bit-exact, the bf16 paths
    within phase 8 (a)'s bound) at both archs' packed projection shapes
    and ``precompute_checks`` at their K; (b) falcon-mamba-7b served
    (``family_serve``) and its teacher-forced parity (``ssm_parity``); (c)
    the same prompts served with prefill chunk 32: the greedy streams of
    chunk 128 (``near_ties``); (d) zamba2-7b served, its parity, the
    block-paged pool (block 16) giving the dense streams exactly,
    ``prefix_cache=True`` turned off with the engine's warning, a ``spec``
    request refused with ValueError; (e) one decode step and one 128-token
    prefill chunk of each profiled (``step_and_chunk``). Returns
    {arch: (config, engine)} and the record."""
    from repro_torch.launch.serve import scheme_name
    from repro_torch.models import api
    from repro_torch.models.quantized import quantized_bytes
    cfgs = {arch: full_config(arch) for arch in SSM_ARCHS}
    shapes = sorted({s for cfg in cfgs.values()
                     for s in packed_shapes(cfg).values()})
    rec = {}
    t0 = time.perf_counter()
    rec["records"], rec["err"] = check_kernels(flush, shapes,
                                               scaled_bound=True)
    rec["precompute_records"] = precompute_checks(
        flush, sorted({k for _, k in shapes}))
    rec["err"]["row_scale"] = 0.0  # bit-equal, or precompute_checks raised
    rec["kernels_s"] = time.perf_counter() - t0
    engines = {}
    for arch, cfg in cfgs.items():
        a = rec[arch] = {"scheme": scheme_name(cfg.quant)}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = api.init_params(gen, cfg, "cuda")
        torch.cuda.synchronize()
        a["init_s"] = time.perf_counter() - t0
        a["init_peak_bytes"] = torch.cuda.max_memory_allocated()
        a["param_bytes"] = quantized_bytes(params)
        layers = params.get("layers") or [
            lp for grp in params["groups"] for lp in grp] + params.get(
                "tail", [])
        a["mamba_bytes"] = quantized_bytes(layers)
        t0 = time.perf_counter()
        eng, served = family_serve(arch, cfg, params)
        a.update(served)
        a.update(ssm_parity(arch, cfg, params))
        prompts = serve_prompts(cfg.vocab_size, 2)
        if cfg.family == "ssm":
            # (c) chunked-prefill state: prefill chunk 32 against 128, both
            # with a right-padded tail
            tails = [((len(p) - 1) % 128, (len(p) - 1) % 32) for p in prompts]
            if not any(x and y for x, y in tails):
                raise AssertionError(f"{arch}: no prompt ends on a padded "
                                     f"tail in both chunkings: {tails}")
            ceng, creqs = serve(cfg, params, seed=2, prefill_chunk=32)
            got = [r.output for r in creqs]
            a["chunk32"] = {
                "tails": tails, "equal_streams": sum(
                    g == w for g, w in zip(got, a["outputs"])),
                "divergences": near_ties(arch, cfg, params, prompts, got,
                                         a["outputs"]),
                "prefill_dispatches": ceng.stats()["prefill_dispatches"]}
        else:
            # (d) paged equals dense; prefix caching off; spec refused
            a.update(paged_and_refusals(arch, cfg, params, eng,
                                        a["outputs"]))
        # (e) a decode step and a prefill chunk profiled
        a.update(step_and_chunk(eng))
        a["serve_s"] = time.perf_counter() - t0
        engines[arch] = (cfg, eng)
        del params
    return engines, rec


def paged_and_refusals(tag, cfg, params, eng, outputs):
    """Phase 12 (d) / 13 (b), (c): phase 4's prompts through the
    block-paged pool (block 16: the attention K/V pooled, slot-resident
    state dense), its launch counts set to 0 just before and read just
    after, giving the dense engine ``eng``'s streams ``outputs`` exactly;
    ``prefix_cache=True`` turned off with the engine's warning; a ``spec``
    request refused with ValueError. Returns the record."""
    from repro_torch.serving.engine import Request, ServingEngine
    out = {}
    reset_counts()
    peng, preqs = serve(cfg, params, seed=2, cache_block_size=16)
    out["paged_launches"] = read_counts()
    if [r.output for r in preqs] != outputs:
        raise AssertionError(f"{tag}: the paged pool's streams differ from "
                             f"the dense engine's")
    pst = peng.stats()
    out["paged"] = {k: pst[k] for k in (
        "cache_block_size", "num_cache_blocks", "blocks_in_use",
        "cache_hbm_bytes", "decode_tok_s", "host_syncs_per_token")}
    out["dense_cache_hbm_bytes"] = eng.stats()["cache_hbm_bytes"]
    del peng
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xeng = ServingEngine(cfg, params, **SERVE_KW, cache_block_size=16,
                             prefix_cache=True)
    said = [str(w.message) for w in caught
            if "prefix caching needs every cache leaf paged"
            in str(w.message)]
    if not said or xeng.prefix_caching:
        raise AssertionError(f"{tag}: prefix caching was not turned off "
                             f"with its warning")
    out["prefix_cache_warning"] = said[0]
    del xeng
    seng = ServingEngine(cfg, params, **SERVE_KW, spec_draft_planes=1)
    try:
        seng.submit(Request(uid=0, prompt=preqs[0].prompt, decoding="spec"))
    except ValueError as e:
        out["spec_refused"] = str(e)
    else:
        raise AssertionError(f"{tag}: a spec request was accepted")
    return out


def ssm_lines(engines, rec):
    """Phase 12's record as text, one line a part."""
    lines = [
        "ssm: kernels at falcon-mamba-7b's and zamba2-7b's shapes, against "
        "the plain versions (per_row bit-exact; None, per_group and "
        f"dequant_mpgemm within {BOUND_REL} · Σ|a·w| + 1e-6 of each output; "
        f"{rec['kernels_s']:.1f} s): " + "; ".join(
            record_line(r) for r in rec["records"]),
        "ssm: table_precompute and row_scale at their K, bit-equal to the "
        "plain versions: " + "; ".join(
            precompute_line(r) for r in rec["precompute_records"])]
    for arch, (cfg, eng) in engines.items():
        a = rec[arch]
        what = (f"{cfg.n_layers} Mamba1 layers, d_model {cfg.d_model}, "
                f"d_inner {cfg.d_inner}, dt_rank {cfg.dt_rank}, state "
                f"{cfg.ssm_state}, vocab {cfg.vocab_size}"
                if cfg.family == "ssm" else
                f"{cfg.n_layers} Mamba2 layers ({cfg.ssm_heads} heads, state "
                f"{cfg.ssm_state}) in {cfg.n_layers // cfg.attn_every} groups "
                f"of {cfg.attn_every} with a shared attention block "
                f"({cfg.n_heads} heads, d_ff {cfg.d_ff}), vocab "
                f"{cfg.vocab_size}")
        lines.append(
            f"{arch}: {what}, {a['scheme']}: params made on the card in "
            f"{a['init_s']:.1f} s (peak {a['init_peak_bytes'] / 1e9:.2f} GB),"
            f" {a['param_bytes'] / 1e9:.3f} GB resident, Mamba layers "
            f"{a['mamba_bytes'] / 1e9:.3f} GB; dispatch {a['dispatch']}")
        lines += serve_lines(arch, cfg, eng, a)
        if "chunk32" in a:
            c = a["chunk32"]
            lines.append(
                f"{arch}: prefill chunk 32 against 128 (tails {c['tails']}): "
                f"{c['equal_streams']} of 4 greedy streams equal, "
                + ("no divergence" if not c["divergences"] else
                   f"near ties {c['divergences']}")
                + f"; {c['prefill_dispatches']} prefill chunks")
        if "paged" in a:
            p = a["paged"]
            lines.append(
                f"{arch}: paged pool (block 16) streams equal the dense "
                f"engine's; cache {p['cache_hbm_bytes'] / 1e6:.1f} MB paged "
                f"vs {a['dense_cache_hbm_bytes'] / 1e6:.1f} MB dense, decode "
                f"{p['decode_tok_s']:.1f} tok/s; launches "
                f"{a['paged_launches']}; prefix_cache=True turned off: "
                f"{a['prefix_cache_warning']!r}; spec refused: "
                f"{a['spec_refused']!r}; phase 12 serves in "
                f"{a['serve_s']:.1f} s")
    return lines


# phase 13: the VLM and audio families at full width
XATTN_ARCHS = ("llama-3.2-vision-11b", "whisper-tiny")
# init_params leaves the VLM's cross gates at 0, where a cross layer adds
# exactly nothing; phase 13 sets both gates of every cross layer to this
# (tanh(0.5) = 0.46)
XATTN_GATE = 0.5
# the served lookups of the largest M: the image K/V (wk and wv over 1601
# image tokens) and whisper's encoder (every projection over 1500 frames)
LARGE_M = {"llama-3.2-vision-11b": (1601, ((1024, 4096),)),
           "whisper-tiny": (1500, ((384, 384), (1536, 384), (384, 1536)))}
# new tokens a request of a beam leg (phase 13 (b), (c), (e))
BEAM_NEW = 8


def stub_inputs(cfg, seed=4):
    """The stub frontend's output for one request, made on the card from
    ``seed``: [1, n, d_model] normal draws × 0.1
    (tests/test_archs_smoke.py's scale), image embeddings (n = 1601) or
    audio frames (n = 1500). Returns (batch key, tensor)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    vlm = cfg.family == "vlm"
    n = cfg.n_image_tokens if vlm else cfg.n_audio_frames
    return ("image_embeds" if vlm else "audio_frames",
            0.1 * torch.randn(1, n, cfg.d_model, generator=gen,
                              device="cuda"))


def cross_forward(cfg, params, inputs):
    """The image K/V (VLM) or the encoder and its cross K/V (whisper) alone:
    the served lookups of the largest M."""
    from repro_torch.models import audio, vlm
    if cfg.family == "vlm":
        return vlm.compute_image_kv(params, inputs, cfg)
    return audio.compute_cross_kv(params, audio.encode(params, inputs, cfg),
                                  cfg)


def busy_profile(fn):
    """Wall time of ``fn`` (host clock, synchronized, after a warm-up)
    against the device time of its CUDA kernels (torch.profiler, on a
    second call, so its host overhead stays out of the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_name, kernels = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total
            kernels += not e.name.startswith(("Memcpy", "Memset"))
    busy_ms = sum(per_name.values()) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall_ms,
            # None: the profiler saw no device activity (not measured)
            "busy_ms": busy_ms if per_name else None,
            "idle_share": 1.0 - busy_ms / wall_ms if per_name else None,
            "kernels": kernels,
            "top": [(name[:60], t / 1e3) for name, t in top]}


def xattn_parity(tag, cfg, params):
    """Phase 13 (b) / (c): teacher-forced 128-token forwards through the
    kernels (lut_pallas) and the plain LUT path (lut_xla), per_row, twice:
    with the stub frontend's inputs (``stub_inputs``: the image K/V or the
    encoder run in the forward), and with tokens only over a zeroed cache
    (the engine's case: a zero cross K/V, so each cross attention hands
    ``wo`` all-zero rows). Logits finite and equal bit for bit, and the
    cross inputs must move them (> 1e-3). Then the image K/V / encoder
    alone (``cross_forward``), its launch counts set to 0 just before and
    read just after: two lookups a cross layer (VLM), or six an encoder
    layer and two a decoder layer (whisper), on the path the fusion rule
    picks at that M (``ops.resolve_dispatch``), the plans from the
    dispatch recorder; its wall and device time (``busy_profile``).
    Returns the record."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.obs import dispatch as dispatch_obs
    key, inputs = stub_inputs(cfg)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")
    out, seen = {}, {}
    for case, batch, cached in (
            ("inputs", {"tokens": toks, key: inputs}, False),
            ("tokens_only", {"tokens": toks}, True)):
        logits = {}
        for mode in ("lut_pallas", "lut_xla"):
            c = cfg.with_quant(mpgemm_mode=mode, table_quant="per_row")
            caches = (api.init_cache(c, 1, SERVE_KW["max_seq"],
                                     dtype=torch.float32, device="cuda")
                      if cached else None)
            logits[mode] = api.forward(params, batch, c, caches=caches)[0]
        a, b = logits["lut_pallas"], logits["lut_xla"]
        if (tuple(a.shape) != (1, 128, cfg.vocab_size)
                or not (torch.isfinite(a).all() and torch.isfinite(b).all())):
            raise AssertionError(f"{tag} ({case}): bad logits "
                                 f"{tuple(a.shape)}")
        diff = (a - b).abs().max().item()
        if diff != 0.0:
            raise AssertionError(f"{tag} ({case}): kernels and plain path "
                                 f"disagree, max |logit diff| {diff}")
        out[f"parity_{case}"] = {"max_abs_diff": diff,
                                 "max_abs_logit": a.abs().max().item()}
        seen[case] = a
    out["cross_moves_logits"] = (seen["inputs"]
                                 - seen["tokens_only"]).abs().max().item()
    if not out["cross_moves_logits"] > 1e-3:
        raise AssertionError(f"{tag}: the cross inputs move the logits by "
                             f"{out['cross_moves_logits']} only")
    del seen, logits, a, b

    m = inputs.shape[1]
    reset_counts()
    with dispatch_obs.recording() as drec:
        kv = cross_forward(cfg, params, inputs)
        torch.cuda.synchronize()
    launches = read_counts()
    if not all(torch.isfinite(t).all() for t in kv):
        raise AssertionError(f"{tag}: non-finite cross K/V")
    del kv
    lookups = launches["lut_mpgemm"] + launches["fused_lut_mpgemm"]
    if cfg.family == "vlm":
        want = 2 * (cfg.n_layers // cfg.xattn_every)
        rule = ops.resolve_dispatch(m, cfg.n_kv_heads * cfg.head_dim,
                                    cfg.d_model // KG, KG, BITS).fusion
        ran = "lut_mpgemm" if rule == "staged" else "fused_lut_mpgemm"
        if launches[ran] != want:
            raise AssertionError(f"{tag}: the image K/V ran {launches}, not "
                                 f"{want} {ran} launches ({rule})")
    else:
        want = 6 * cfg.enc_layers + 2 * cfg.n_layers
        rule = {f"{n}x{k}": ops.resolve_dispatch(m, n, k // KG, KG,
                                                 BITS).fusion
                for n, k in LARGE_M[cfg.arch_id][1]}
    if lookups != want:
        raise AssertionError(f"{tag}: {lookups} lookups at M = {m}, not "
                             f"{want}: {launches}")
    out["cross_lookups"] = {
        "m": m, "launches": launches, "rule": rule,
        "plans": [r.as_dict() for r in drec.records("dispatch")]}
    out["cross_forward"] = busy_profile(
        lambda: cross_forward(cfg, params, inputs))
    return out


def beam_legs(tag, cfg, params, paged):
    """Phase 13 (b), (c), (e): a beam:2 request beside two greedy ones
    (phase 4's prompts 0-2, ``BEAM_NEW`` new tokens each) on phase 4's
    engine shape, under lut_pallas (its launch counts set to 0 just before
    and read just after: every kernel of the per_row path must run) and
    under lut_xla, dense, and with ``paged`` through the block-paged pool
    (block 16) under lut_pallas: the greedy streams and the ranked
    hypotheses (tokens and scores) equal, <= 1/decode_chunk host syncs a
    token. Returns the record."""
    from repro_torch.serving.engine import Request, ServingEngine
    prompts = serve_prompts(cfg.vocab_size, seed=2)[:3]
    out = {}

    def run(leg, c, **engine_kw):
        eng = ServingEngine(c, params, **SERVE_KW, **engine_kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=BEAM_NEW,
                        decoding="beam:2" if i == 0 else "greedy")
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        torch.cuda.synchronize()
        st = eng.stats()
        out[leg] = {"seconds": time.perf_counter() - t0,
                    "decode_tok_s": st["decode_tok_s"],
                    "host_syncs_per_token": st["host_syncs_per_token"]}
        if (not all(r.done for r in reqs) or len(reqs[0].beams) != 2
                or st["host_syncs_per_token"] > 1 / eng.decode_chunk):
            raise AssertionError(f"{tag} beam ({leg}): {out[leg]}, done "
                                 f"{[r.done for r in reqs]}")
        return ([r.output for r in reqs[1:]],
                [(list(t), sc) for t, sc in reqs[0].beams])

    reset_counts()
    want = run("lut_pallas", cfg)
    out["launches"] = read_counts()
    if min(out["launches"][n] for n in PER_ROW_PATH) <= 0:
        raise AssertionError(f"{tag} beam: a kernel never ran: "
                             f"{out['launches']}")
    legs = [("lut_xla", cfg.with_quant(mpgemm_mode="lut_xla",
                                       table_quant="per_row"), {})]
    if paged:
        legs.append(("paged", cfg, dict(cache_block_size=16)))
    for leg, c, kw in legs:
        if run(leg, c, **kw) != want:
            raise AssertionError(f"{tag} beam: {leg} serves the pool "
                                 f"differently from lut_pallas dense")
    out["beams"] = want[1]
    return out


def xattn_phase(flush, ssm_models):
    """Phase 13: the VLM and audio families at full width (module
    docstring), random weights from seed 0 made on the card layer by
    layer, per_row tables, lut_pallas, fusion auto. ``ssm_models``:
    {arch: (config, params)} of phase 12's models for (e), run first and
    then dropped from the dict, so that phase 12's weights are freed
    before the VLM is made. Returns {arch: (config, engine)} and the
    record."""
    import gc
    from repro_torch.launch.serve import scheme_name
    from repro_torch.models import api
    from repro_torch.models.quantized import quantized_bytes
    from repro_torch.kernels import ops
    rec = {"ssm_beam": {}}
    t0 = time.perf_counter()
    # (e) beam search on the SSM families, on phase 12's models
    for arch, (cfg, params) in ssm_models.items():
        rec["ssm_beam"][arch] = beam_legs(arch, cfg, params,
                                          paged=cfg.family == "hybrid")
    ssm_models.clear()
    params = None
    gc.collect()
    torch.cuda.empty_cache()
    rec["ssm_beam_s"] = time.perf_counter() - t0

    # (a) the kernels at the two archs' shapes, and at the served large M
    cfgs = {arch: full_config(arch) for arch in XATTN_ARCHS}
    shapes = sorted({s for cfg in cfgs.values()
                     for s in packed_shapes(cfg).values()})
    t0 = time.perf_counter()
    rec["records"], rec["err"] = check_kernels(flush, shapes,
                                               scaled_bound=True)
    rec["large_m_records"] = []
    for arch, (m, large) in LARGE_M.items():
        recs, err = check_kernels(flush, large, paths=("per_row",),
                                  rows=(m,), scaled_bound=True)
        for r in recs:
            r["fusion_rule"] = ops.resolve_dispatch(
                m, r["n"], r["k"] // KG, KG, BITS).fusion
        rec["large_m_records"] += recs
        for name, e in err.items():
            rec["err"][name] = max(rec["err"][name], e)
    ks = sorted({k for _, k in shapes if k < 4096})  # 384, 1536
    rec["precompute_records"] = (
        precompute_checks(flush, ks)
        + precompute_checks(flush, ks, rows=(1500,), row_scale_m=())
        + precompute_checks(flush, (4096,), rows=(1601,), row_scale_m=()))
    rec["err"]["row_scale"] = 0.0  # bit-equal, or precompute_checks raised
    rec["kernels_s"] = time.perf_counter() - t0

    engines = {}
    for arch, cfg in cfgs.items():
        a = rec[arch] = {"scheme": scheme_name(cfg.quant)}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = api.init_params(gen, cfg, "cuda")
        for xp in params.get("xattn_layers", []):
            xp["gate_attn"].fill_(XATTN_GATE)
            xp["gate_mlp"].fill_(XATTN_GATE)
        torch.cuda.synchronize()
        a["init_s"] = time.perf_counter() - t0
        a["init_peak_bytes"] = torch.cuda.max_memory_allocated()
        a["param_bytes"] = quantized_bytes(params)
        layer_keys = ("self_groups", "xattn_layers", "enc_layers",
                      "dec_layers")
        a["layer_bytes"] = quantized_bytes(
            [params[k] for k in layer_keys if k in params])
        a["head_bytes"] = quantized_bytes(params["lm_head"])
        a["embed_bytes"] = quantized_bytes(params["embed"])
        t0 = time.perf_counter()
        # (b) / (c): the serve, its parity and cross forward, paged, the
        # refusals, beam
        eng, served = family_serve(arch, cfg, params)
        a.update(served)
        a.update(xattn_parity(arch, cfg, params))
        a.update(paged_and_refusals(arch, cfg, params, eng, a["outputs"]))
        a["beam"] = beam_legs(arch, cfg, params, paged=True)
        # (d) a decode step and a prefill chunk profiled
        a.update(step_and_chunk(eng))
        a["serve_s"] = time.perf_counter() - t0
        engines[arch] = (cfg, eng)
        del params
    return engines, rec


def xattn_lines(engines, rec):
    """Phase 13's record as text, one line a part."""
    lines = []
    for arch, b in rec["ssm_beam"].items():
        lines.append(
            f"{arch}: beam:2 beside two greedy requests ({BEAM_NEW} tokens "
            f"each) equal under lut_pallas and lut_xla"
            + (" and paged (block 16)" if "paged" in b else "")
            + f"; launches {b['launches']}; legs " + ", ".join(
                f"{leg} {b[leg]['decode_tok_s']:.1f} tok/s"
                for leg in ("lut_pallas", "lut_xla", "paged") if leg in b))
    lines += [
        "xattn: kernels at llama-3.2-vision-11b's and whisper-tiny's "
        "shapes, against the plain versions (per_row bit-exact; None, "
        f"per_group and dequant_mpgemm within {BOUND_REL} · Σ|a·w| + 1e-6 "
        f"of each output; {rec['kernels_s']:.1f} s): " + "; ".join(
            record_line(r) for r in rec["records"]),
        "xattn: per_row at the served large M (the image K/V, whisper's "
        "encoder), staged and fused, bit-exact: " + "; ".join(
            record_line(r) + f" [the fusion rule picks {r['fusion_rule']}]"
            for r in rec["large_m_records"]),
        "xattn: table_precompute and row_scale at their K (and M 1500 / "
        "1601), bit-equal to the plain versions: " + "; ".join(
            precompute_line(r) for r in rec["precompute_records"])]
    for arch, (cfg, eng) in engines.items():
        a = rec[arch]
        what = (f"{cfg.n_layers} layers in {cfg.n_layers // cfg.xattn_every}"
                f" groups of {cfg.xattn_every - 1} self layers and a cross "
                f"layer (gates {XATTN_GATE}), d_model {cfg.d_model}, GQA "
                f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
                f"{cfg.vocab_size}, {cfg.n_image_tokens} image tokens"
                if cfg.family == "vlm" else
                f"{cfg.enc_layers} encoder + {cfg.n_layers} decoder layers, "
                f"d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff "
                f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.n_audio_frames} "
                f"frames")
        lines.append(
            f"{arch}: {what}, {a['scheme']}: params made on the card in "
            f"{a['init_s']:.1f} s (peak {a['init_peak_bytes'] / 1e9:.2f} GB),"
            f" {a['param_bytes'] / 1e9:.3f} GB resident: layers "
            f"{a['layer_bytes'] / 1e9:.3f} GB, head "
            f"{a['head_bytes'] / 1e9:.3f} GB, embedding "
            f"{a['embed_bytes'] / 1e9:.3f} GB; dispatch {a['dispatch']}")
        lines += serve_lines(arch, cfg, eng, dict(
            a, parity_max_abs_diff=a["parity_inputs"]["max_abs_diff"],
            parity_max_abs_logit=a["parity_inputs"]["max_abs_logit"]))
        c, f = a["cross_lookups"], a["cross_forward"]
        lines.append(
            f"{arch}: parity with tokens only over a zero cross K/V (the "
            f"engine's case): max |logit diff| "
            f"{a['parity_tokens_only']['max_abs_diff']}, every logit finite;"
            f" the cross inputs move the logits by "
            f"{a['cross_moves_logits']:.4g}; "
            + ("the image K/V" if cfg.family == "vlm" else
               "the encoder and cross K/V")
            + f" at M = {c['m']}: launches {c['launches']} (the rule picks "
            f"{c['rule']}), plans {c['plans']}; wall {f['wall_ms']:.2f} ms, "
            + ("device busy not measured" if f["busy_ms"] is None else
               f"device busy {f['busy_ms']:.2f} ms (idle share "
               f"{f['idle_share']:.3f}) in {f['kernels']} CUDA kernels: "
               + ", ".join(f"{n} {t:.2f} ms" for n, t in f["top"])))
        p, b = a["paged"], a["beam"]
        lines.append(
            f"{arch}: paged pool (block 16) streams equal the dense "
            f"engine's; cache {p['cache_hbm_bytes'] / 1e6:.1f} MB paged vs "
            f"{a['dense_cache_hbm_bytes'] / 1e6:.1f} MB dense; launches "
            f"{a['paged_launches']}; prefix_cache=True turned off: "
            f"{a['prefix_cache_warning']!r}; spec refused: "
            f"{a['spec_refused']!r}; beam:2 beside two greedy requests "
            f"equal under lut_pallas, lut_xla and paged, beams "
            f"{[(t, round(sc, 4)) for t, sc in b['beams']]}, launches "
            f"{b['launches']}; phase 13 serves in {a['serve_s']:.1f} s")
    return lines


# phase 14: training full-width tinyllama-1.1b, then serving what it learned
TRAIN_STEPS = 30           # AdamW steps, lr_schedule(3e-4, 20, total=30)
TRAIN_CKPT = 20            # the RestartManager checkpoint the restart reads
TRAIN_BATCH, TRAIN_SEQ = 8, 256


def train_config():
    """Phase 14's model: full-width tinyllama-1.1b, W2 symmetric K=4 QAT
    (the float params' forward fake-quantizes every projection and the
    head), f32 activations, as the reference's launch/train.py trains it."""
    from repro_torch.configs import registry
    return registry.get_config("tinyllama-1.1b").replace(
        activation_dtype=torch.float32)


def train_steps(step_fn, box, batch_at, steps, rm=None):
    """Runs ``steps`` (data steps, the batch ``batch_at(step)``) from the
    state in ``box``, a one-element list that it empties: the caller then
    holds no reference to that state, and each step's input state is freed
    as the next begins. Returns (state, losses, grad norms, ms a step, the
    host clock at each step's end). Each step's metrics are read at its
    end, so the host clock times a finished step; a step's ms take in its
    batch's making and leave out its checkpoint snapshot, its end takes
    it in."""
    state = box.pop()
    losses, gnorms, ms, ends = [], [], [], []
    for step in steps:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch_at(step))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if rm is not None:
            rm.maybe_save(step + 1, state)
        ends.append(time.perf_counter())
    return state, losses, gnorms, ms, ends


def train_phase():
    """Phase 14: (a) full-width tinyllama-1.1b trained 30 QAT steps with
    AdamW (``lr_schedule(3e-4, warmup=20, total=30)``), batch 8, seq 256,
    ``SyntheticLM(seed=0)``, through ``make_train_step`` from float params
    made on the card from seed 0: every loss and grad norm finite, the mean
    of the last 5 losses below the first 5's; tokens a second and ms a step
    over steps 2-30 by wall time (the checkpoint included), the median
    step, peak device memory. (b) The run checkpoints its whole state (params,
    AdamW m and v, step counters) with ``RestartManager`` at step 20 (an
    async write, its host snapshot taken before the step returns); the
    checkpoint is restored into a fresh state (other params, seed 1) and
    steps 21–30 rerun from the same data steps: their losses and grad norms
    and the final params must equal the straight run's bit for bit. Both
    runs are under ``torch.use_deterministic_algorithms(True)`` (cuBLAS
    workspace ``CUBLAS_WORKSPACE_CONFIG`` set at the top of this script).
    (c) The trained params packed (``models.quantized.quantize_params``)
    and served as phases 4 and 5 serve (``serve_and_parity``: every kernel
    of the per_row path launched, lut_pallas = lut_xla logits bit for
    bit); recorded, not checked: the max |logit difference| between the
    QAT forward of the float params and the packed lut_xla forward (the
    serving quantizer searches a clip ratio, fake_quant uses absmax)."""
    import shutil
    from repro_torch.kernels import _build
    from repro_torch.models import api, quantized
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    from repro_torch.core.tree import tree_leaves
    cfg = train_config()
    opt = opt_mod.make_optimizer("adamw", lr=opt_mod.lr_schedule(
        3e-4, warmup=20, total=TRAIN_STEPS))
    step_fn = make_train_step(cfg, opt, qat=True)
    data = SyntheticLM(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    ckpt_dir = str(_build.BUILD_DIR / "train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rec = {"arch": cfg.arch_id, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "optimizer": "adamw", "qat": True}
    torch.use_deterministic_algorithms(True)
    try:
        # (a) the straight run, checkpointing at step 20
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        t0 = time.perf_counter()
        box = [init_train_state(gen, cfg, opt, "cuda")]
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["params"] = sum(p.numel() for p in tree_leaves(box[0]["params"]))
        rm = ckpt_mod.RestartManager(ckpt_dir, every=TRAIN_CKPT, keep=1)
        t0 = time.perf_counter()
        state, losses, gnorms, ms, ends = train_steps(
            step_fn, box, data.batch_at, range(TRAIN_STEPS), rm)
        rec["train_s"] = ends[-1] - t0
        t0 = time.perf_counter()
        rm.wait()
        rec["ckpt_wait_s"] = time.perf_counter() - t0
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec.update(losses=losses, grad_norms=gnorms, step_ms=ms)
        # the rate: every token of steps 2-30 over the wall time from the
        # end of step 1 to the end of step 30, the step-20 checkpoint's
        # snapshot and its async write's cost to the later steps included
        window_s = ends[-1] - ends[0]
        rec["first_step_ms"] = ms[0]
        rec["step_ms_wall"] = window_s / (TRAIN_STEPS - 1) * 1e3
        rec["step_ms_median"] = sorted(ms[1:])[len(ms[1:]) // 2]
        rec["tokens_s"] = (TRAIN_STEPS - 1) * TRAIN_BATCH * TRAIN_SEQ / window_s
        # where the window goes beyond the steps: the checkpoint's host
        # snapshot (its step's end less its start and its ms), and the
        # steps that ran beside the async write against those before it
        i = TRAIN_CKPT - 1
        rec["snapshot_s"] = ends[i] - ends[i - 1] - ms[i] / 1e3
        before = sorted(ms[1:i])
        rec["step_ms_before_ckpt"] = before[len(before) // 2]
        rec["step_ms_during_write"] = (min(ms[i + 1:]), max(ms[i + 1:]))
        if not all(np.isfinite(losses + gnorms)):
            raise AssertionError(f"train: a loss or grad norm is not finite: "
                                 f"{losses} {gnorms}")
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        rec["first5"], rec["last5"] = first5, last5
        if not last5 < first5:
            raise AssertionError(f"train: the loss did not fall: first 5 "
                                 f"{first5}, last 5 {last5}")
        if ckpt_mod.list_steps(ckpt_dir) != [TRAIN_CKPT]:
            raise AssertionError(f"train: checkpoints "
                                 f"{ckpt_mod.list_steps(ckpt_dir)}")
        trained = state["params"]
        del state

        # (b) restart from the step-20 checkpoint into a fresh state
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        fresh = init_train_state(gen, cfg, opt, "cuda")
        t0 = time.perf_counter()
        box = [None]
        box[0], start = rm.restore_or_none(fresh)
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t0
        del fresh
        if start != TRAIN_CKPT or int(box[0]["step"]) != TRAIN_CKPT:
            raise AssertionError(f"train: restored step {start}")
        state, r_losses, r_gnorms, _, _ = train_steps(
            step_fn, box, data.batch_at, range(TRAIN_CKPT, TRAIN_STEPS))
        equal_params = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(state["params"]), tree_leaves(trained)))
        rec["restart"] = {
            "losses": r_losses, "grad_norms": r_gnorms,
            "bit_equal": (r_losses == losses[TRAIN_CKPT:]
                          and r_gnorms == gnorms[TRAIN_CKPT:]
                          and equal_params),
            "max_abs_loss_diff": max(abs(a - b) for a, b in zip(
                r_losses, losses[TRAIN_CKPT:]))}
        # one more step (31) profiled on the restarted state: where a train
        # step's device time goes
        rec["step_profile"] = train_step_profile(step_fn, state,
                                                 data.batch_at(TRAIN_STEPS))
        del state
        if not rec["restart"]["bit_equal"]:
            raise AssertionError(f"train: the restart is not bit-equal to "
                                 f"the straight run: {rec['restart']}, "
                                 f"params equal {equal_params}")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (c) serve the trained weights through the kernels
    gc_cuda()
    scfg = main_config()
    t0 = time.perf_counter()
    packed = quantized.quantize_params(trained, scfg.quant)
    torch.cuda.synchronize()
    rec["quantize_s"] = time.perf_counter() - t0
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")
    with torch.no_grad():
        qat = api.forward(trained, {"tokens": toks},
                          cfg.with_quant(qat=True))[0]
    del trained
    gc_cuda()
    lut = api.forward(packed, {"tokens": toks}, scfg.with_quant(
        mpgemm_mode="lut_xla", table_quant="per_row"))[0]
    rec["qat_vs_packed_max_abs_logit_diff"] = (qat - lut).abs().max().item()
    rec["qat_max_abs_logit"] = qat.abs().max().item()
    del qat, lut
    eng, serve_rec = serve_and_parity("train", scfg, packed)
    rec["serve"] = serve_rec
    rec["launches"] = serve_rec["launches"]
    return scfg, eng, rec


def train_step_profile(step_fn, state, batch):
    """One train step under torch.profiler: wall (host clock, synchronized,
    the profiler on), device busy, idle share, CUDA kernels, and device time
    by kernel (GEMMs: cuBLAS / CUTLASS kernels by name)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.device_time_total
    busy_ms = sum(per_name.values()) / 1e3
    gemm_ms = sum(t for n, t in per_name.items()
                  if re.search(r"gemm|cutlass|sm90_xmma|ampere", n)) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms if per_name else None,
            "idle_share": 1.0 - busy_ms / wall_ms if per_name else None,
            "gemm_ms": gemm_ms if per_name else None,
            "kernel_names": len(per_name),
            "top": [(n[:60], t / 1e3) for n, t in top]}


def gc_cuda():
    """Frees what Python no longer holds, and the allocator's cached
    blocks, before a phase that needs the card's memory."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def train_lines(cfg, eng, rec):
    """``train_phase``'s record as text."""
    rs, prof = rec["restart"], rec["step_profile"]
    return [
        f"train: {rec['arch']} ({rec['params'] / 1e9:.3f} B params), QAT "
        f"W2 symmetric, AdamW lr_schedule(3e-4, 20, {rec['steps']}), batch "
        f"{rec['batch']} x seq {rec['seq']}: {rec['steps']} steps in "
        f"{rec['train_s']:.1f} s; steps 2-{rec['steps']} at "
        f"{rec['tokens_s']:.0f} tokens/s, {rec['step_ms_wall']:.1f} ms a "
        f"step by wall time (the checkpoint at step {TRAIN_CKPT} included; "
        f"median step {rec['step_ms_median']:.1f} ms, the first "
        f"{rec['first_step_ms']:.1f} ms); the step-{TRAIN_CKPT} snapshot "
        f"{rec['snapshot_s']:.2f} s; steps {TRAIN_CKPT + 1}-{rec['steps']} "
        f"{rec['step_ms_during_write'][0]:.1f}-"
        f"{rec['step_ms_during_write'][1]:.1f} ms beside the async write "
        f"(median of steps 2-{TRAIN_CKPT - 1} "
        f"{rec['step_ms_before_ckpt']:.1f} ms); peak "
        f"device memory {rec['peak_bytes'] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); loss "
        f"{rec['losses'][0]:.4f} -> {rec['losses'][-1]:.4f}, mean of the "
        f"first 5 {rec['first5']:.4f}, last 5 {rec['last5']:.4f}; grad "
        f"norms {rec['grad_norms'][0]:.4g} -> {rec['grad_norms'][-1]:.4g}",
        f"train: restart from the step-{TRAIN_CKPT} checkpoint (params, "
        f"AdamW m and v; waited {rec['ckpt_wait_s']:.1f} s for the async "
        f"write after step {rec['steps']}, restored in "
        f"{rec['restore_s']:.1f} s) into a fresh state: steps "
        f"{TRAIN_CKPT + 1}-{rec['steps']} "
        + ("bit-equal to the straight run (losses, grad norms, final params;"
           " deterministic algorithms)" if rs["bit_equal"] else
           f"NOT bit-equal (max |loss diff| {rs['max_abs_loss_diff']})"),
        "train: one step profiled (step 31, the profiler on): " + (
            "device busy not measured (the profiler saw no device events)"
            if prof["busy_ms"] is None else
            f"wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['busy_ms']:.1f} ms (idle share {prof['idle_share']:.3f}),"
            f" GEMM kernels {prof['gemm_ms']:.1f} ms; device time by kernel: "
            + ", ".join(f"{n} {t:.1f} ms" for n, t in prof["top"])),
        f"train: the trained params packed in {rec['quantize_s']:.1f} s; "
        f"QAT forward vs the packed lut_xla forward, 128 tokens: max |logit "
        f"diff| {rec['qat_vs_packed_max_abs_logit_diff']:.4g} (max |logit| "
        f"{rec['qat_max_abs_logit']:.4g}; a record: the serving quantizer "
        f"searches a clip ratio, fake_quant takes absmax)",
    ] + serve_lines("train", cfg, eng, rec["serve"])


# ---------------------------------------------------------------------------
# phase 15: the int8 KV cache
# ---------------------------------------------------------------------------

# (c)'s models, each served once on an int8 cache
KV_FAMILIES = ("whisper-tiny", "zamba2-7b")
KV_ARCHS = ("tinyllama-1.1b", MOE) + KV_FAMILIES
# (b): olmoe's beam:2 legs and spec request, whose lut_xla forwards run 64
# experts' plain lookups one expert at a time (~3 s a decode step on the
# H100): as few new tokens as the checks need, two verify rounds of spec k
# 4, each leg's decode chunk as long as its request (a chunk runs all its
# steps, a finished request's too)
KV_BEAM_NEW, KV_SPEC_NEW = 3, 2
# (b)'s olmoe depth: 4 of its 16 layers (its lut_xla legs' time is linear
# in the layers)
KV_MOE_LAYERS = 4
# tinyllama-1.1b's depth in phase 15 (full width), for the time limit
KV_TINY_LAYERS = 11
# the reference's bound on int8 against f32 cache logits
# (tests/test_perf_features.py)
KV_CORRCOEF = 0.999


def cache_formula(cfg, batch, positions, int8):
    """An engine's cache bytes from the config alone: every attention
    layer's K and V at ``positions`` positions (f32: 4·hd bytes a head;
    int8: hd bytes of codes and a 4-byte scale), plus the slot-resident
    state of ``batch`` slots: whisper's cross K/V (f32, or int8 zeros) and
    zamba2's Mamba2 conv and SSM state (f32)."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    n_attn = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
              else cfg.n_layers)
    total = n_attn * positions * 2 * kv * (hd + 4 if int8 else 4 * hd)
    if cfg.family == "audio":
        total += (2 * cfg.n_layers * batch * cfg.n_audio_frames * kv * hd
                  * (1 if int8 else 4))
    if cfg.family == "hybrid":
        hd_ssm = cfg.d_inner // cfg.ssm_heads
        total += 4 * cfg.n_layers * batch * (
            (cfg.d_conv - 1) * cfg.d_inner
            + cfg.ssm_heads * hd_ssm * cfg.ssm_state)
    return total


def check_cache_bytes(tag, cfg, params, **engine_kw):
    """``stats()["cache_hbm_bytes"]`` of an f32 and an int8 engine (made,
    nothing served) against ``cache_formula``. Returns {dtype: bytes}."""
    from repro_torch.serving.engine import ServingEngine
    kw = dict(SERVE_KW, **engine_kw)
    out = {}
    for dt in ("bf16", "int8"):
        eng = ServingEngine(cfg, params, kv_cache_dtype=dt, **kw)
        got = eng.stats()["cache_hbm_bytes"]
        positions = (eng.num_cache_blocks * eng.cache_block_size
                     if eng.paged else kw["max_batch"] * kw["max_seq"])
        want = cache_formula(cfg, kw["max_batch"], positions, dt == "int8")
        if got != want:
            raise AssertionError(f"{tag}: {dt} cache of {got} bytes, the "
                                 f"formula gives {want}")
        out[dt] = got
        del eng
    return out


def stream_agreement(got, want):
    """Tokens equal position by position, and each stream's tokens before
    its first difference, over the streams ``got`` against ``want``."""
    equal = sum(x == y for a, b in zip(got, want) for x, y in zip(a, b))
    prefix = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b))) for a, b in zip(got, want)]
    return {"tokens": sum(len(a) for a in want), "equal_tokens": equal,
            "agreeing_prefix": prefix}


def int8_serve(tag, cfg, params, per_step):
    """Phase 4's requests on an int8 cache (``cfg.kv_cache_dtype``), a
    warm-up serve first, the launch counts set to 0 just before the serve
    and read just after: every request finishes 16 tokens, every kernel of
    the per_row path ran (the MoE serve's batched ones, ``MOE_PATHS``),
    <= 1/decode_chunk host syncs a token; one more decode chunk under
    torch's sync check launches ``per_step`` (kernel -> launches a step)
    and nothing else. Returns (engine, requests, record)."""
    serve(cfg, params, seed=1)  # warm-up
    reset_counts()
    eng, reqs = serve(cfg, params, seed=2)
    launches = read_counts()
    st = eng.stats()
    ran = MOE_PATHS["auto"][0] if cfg.family == "moe" else PER_ROW_PATH
    if not all(r.done and len(r.output) == 16 for r in reqs):
        raise AssertionError(f"{tag}: not every request finished 16 tokens")
    if min(launches[n] for n in ran) <= 0:
        raise AssertionError(f"{tag}: a kernel never ran: {launches}")
    if st["host_syncs_per_token"] > 1.0 / eng.decode_chunk:
        raise AssertionError(f"{tag}: {st['host_syncs_per_token']} host "
                             f"syncs per token > 1/{eng.decode_chunk}")
    chunk = checked_decode_chunk(tag, eng, per_step)
    return eng, reqs, {"serve": st, "launches": launches,
                       "decode_chunk_launches": chunk,
                       "outputs": [r.output for r in reqs]}


def added_kernels(f32, int8):
    """Kernel names launched more often in the int8 profile than in the
    f32 one (launches a step or chunk), most added first."""
    names = set(f32["by_name"]) | set(int8["by_name"])
    delta = {n: int8["by_name"].get(n, 0) - f32["by_name"].get(n, 0)
             for n in names}
    return sorted(((n, d) for n, d in delta.items() if d),
                  key=lambda nd: -nd[1])


def decode_steps(params, cfg, toks, start, cache):
    """One per-slot decode step (s = 1, a [1] ``cache_pos``) for each token
    of ``toks`` [1, S] from position ``start`` on, into ``cache`` (filled
    up to ``start``): the list of their logits, each [1, 1, V]."""
    from repro_torch.models import api
    return [api.forward(params, {"tokens": toks[:, p:p + 1]}, cfg,
                        caches=cache,
                        cache_pos=torch.full((1,), p, device="cuda"))[0]
            for p in range(start, toks.shape[1])]


def int8_forward(cfg, params):
    """(a)'s teacher-forced forward: 120 tokens prefilled at offset 0 into
    a batch-1 cache, then 8 per-slot decode steps (positions 120-127).
    On int8 caches through the kernels (lut_pallas) and the plain LUT path
    (lut_xla), per_row: logits bit-equal at all 128 positions (the int8
    cache is the same torch ops on both paths). The decode positions'
    logits against an f32 cache's, for float tables (None) and per_row,
    in two settings: (1) the reference's own test's
    (tests/test_perf_features.py): a prefill at the static offset 0
    attends over its unquantized K/V and writes them quantized, so only
    the decode steps read int8 codes; here the f32 cache's prefill, its
    120 positions then quantized into an int8 cache (``_quantize_kv_slice``
    a layer); (2) the engine's (and the reference engine's, whose traced
    offset reads the cache): the prefill attends over the dequantized
    cache. A bf16 cache in setting (2) is the control: per_row INT8
    activation tables turn any change of a K/V into code flips, whatever
    its size. The gate is the reference's bound, corrcoef > KV_CORRCOEF,
    in its test's setting: float tables (its "auto" on the CPU), (1)."""
    from repro_torch.models import api, kvcache
    from repro_torch.models.layers import _quantize_kv_slice
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")

    def decode(c, cache, out):
        return torch.cat(out + decode_steps(params, c, toks, 120, cache),
                         dim=1)

    def run(c, dtype):
        cache = api.init_cache(c, 1, 128, dtype=dtype, device="cuda")
        return decode(c, cache, [api.forward(
            params, {"tokens": toks[:, :120]}, c, caches=cache,
            cache_pos=0)[0]])

    def exact_prefill(c):
        c32 = api.init_cache(c, 1, 128, dtype=torch.float32, device="cuda")
        api.forward(params, {"tokens": toks[:, :120]}, c, caches=c32,
                    cache_pos=0)
        c8 = kvcache.attn_cache(cfg.n_layers, 1, 128, cfg.n_kv_heads,
                                cfg.head_dim, "int8", device="cuda")
        for i in (0, 1):
            codes, scales = _quantize_kv_slice(c32[i][:, :, :120])
            c8[i][:, :, :120], c8[i + 2][:, :, :120] = codes, scales
        return decode(c, c8, [])

    quant = lambda mode, tq: cfg.with_quant(mpgemm_mode=mode, table_quant=tq)
    a = run(quant("lut_pallas", "per_row"), "int8")
    b = run(quant("lut_xla", "per_row"), "int8")
    if (tuple(a.shape) != (1, 128, cfg.vocab_size)
            or not torch.isfinite(a).all()):
        raise AssertionError(f"kvint8: bad logits {tuple(a.shape)}")
    diff = (a - b).abs().max().item()
    if diff != 0.0:
        raise AssertionError(f"kvint8: int8-cache logits, kernels vs plain "
                             f"path, max |diff| {diff}")
    out = {"parity_max_abs_diff": diff}
    for tq in (None, "per_row"):
        c = quant("lut_pallas", tq)
        dec32 = run(c, torch.float32)[0, 120:].double()

        def vs_f32(logits):
            d = logits[0, -8:].double()
            return {"corrcoef": torch.corrcoef(torch.stack(
                        [d.flatten(), dec32.flatten()]))[0, 1].item(),
                    "max_abs_diff": (d - dec32).abs().max().item(),
                    "argmax_equal": int((d.argmax(-1) == dec32.argmax(-1))
                                        .sum().item())}

        out[str(tq)] = {
            "max_abs_logit": dec32.abs().max().item(),
            "exact_prefill": vs_f32(exact_prefill(c)),
            "engine_prefill": vs_f32(a if tq else run(c, "int8")),
            "bf16_cache_control": vs_f32(run(c, torch.bfloat16))}
    cc = out["None"]["exact_prefill"]["corrcoef"]
    if not cc > KV_CORRCOEF:
        raise AssertionError(f"kvint8: int8 vs f32 cache decode logits, "
                             f"float tables, after an exact prefill: "
                             f"corrcoef {cc} <= {KV_CORRCOEF} ({out})")
    return out


def cache_dtype_forward(cfg, params):
    """(c)'s check of zamba2-7b's int8 streams: a teacher-forced forward
    through the kernels (120 tokens prefilled at offset 0 into a batch-1
    cache, then 8 per-slot decode steps) on an f32, a bf16 and an int8
    cache, with per_row tables (the served ones) and float tables (None).
    For the bf16 and the int8 cache against the f32 one: the 8 decode
    positions' logits (corrcoef, max |diff|, argmax equal), and the
    prefill's last position, whose logits pick a stream's first token
    (max |diff|, argmax equal); the f32 cache's top-2 margin there and at
    the first decode position. A record: int8 within bf16's deviation is
    judged from the numbers (PERF.md §6)."""
    from repro_torch.models import api
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")

    def run(c, dtype):
        cache = api.init_cache(c, 1, 128, dtype=dtype, device="cuda")
        last = api.forward(params, {"tokens": toks[:, :120]}, c,
                           caches=cache, cache_pos=0)[0][:, -1:]
        return torch.cat([last] + decode_steps(params, c, toks, 120, cache),
                         dim=1)[0].double()  # [9, V]: 119, 120-127

    def margin(row):
        top2 = torch.topk(row, 2).values
        return (top2[0] - top2[1]).item()

    out = {}
    for tq in (None, "per_row"):
        c = cfg.with_quant(mpgemm_mode="lut_pallas", table_quant=tq)
        f32 = run(c, torch.float32)
        r = {"max_abs_logit": f32.abs().max().item(),
             "f32_top2_margin_prefill_last": margin(f32[0]),
             "f32_top2_margin_first_decode": margin(f32[1])}
        for name, dtype in (("bf16", torch.bfloat16), ("int8", "int8")):
            x = run(c, dtype)
            d, ref = x[1:], f32[1:]
            r[name] = {
                "corrcoef": torch.corrcoef(torch.stack(
                    [d.flatten(), ref.flatten()]))[0, 1].item(),
                "max_abs_diff": (d - ref).abs().max().item(),
                "argmax_equal": int((d.argmax(-1) == ref.argmax(-1)).sum()),
                "prefill_last_max_abs_diff": (x[0] - f32[0]).abs().max()
                .item(),
                "prefill_last_argmax_equal": bool(x[0].argmax()
                                                  == f32[0].argmax())}
        out[str(tq)] = r
    return out


def int8_paged(tag, cfg, params):
    """Phase 6's prompts (16 new tokens each) on int8 caches, the dense
    engine against the block-paged pool (block 16, 96 blocks) with prefix
    sharing: the dense streams up to a near tie (phase 6's rule) and the
    prompt tokens reused equal to ``expected_reuse``."""
    from repro_torch.serving.engine import Request, ServingEngine
    bs = 16
    prompts = paged_prompts(cfg.vocab_size, bs)
    paged_kw = dict(SERVE_KW, cache_block_size=bs, num_cache_blocks=96)

    def run(**kw):
        eng = ServingEngine(cfg, params, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        torch.cuda.synchronize()
        if not all(r.done and len(r.output) == 16 for r in reqs):
            raise AssertionError(f"{tag} paged: a request did not finish")
        return eng, [r.output for r in reqs]

    _, dense = run(**SERVE_KW)
    eng, shared = run(**paged_kw, prefix_cache=True)
    st = eng.stats()
    reuse = expected_reuse(prompts, bs)
    if st["prefill_tokens_reused"] != reuse:
        raise AssertionError(f"{tag} paged: {st['prefill_tokens_reused']} "
                             f"prompt tokens reused, the rule gives {reuse}")
    return {"requests": len(prompts),
            "divergences": near_ties(f"{tag} paged", cfg, params, prompts,
                                     shared, dense),
            "prefill_tokens_reused": st["prefill_tokens_reused"],
            "expected_reuse": reuse}


def moe_int8_decoding(cfg, params, greedy):
    """(b)'s decoding modes on olmoe's int8 caches, phase 4's prompts:
    beam:1 of prompt 0 (16 new tokens) equal to its greedy stream; a
    beam:2 request through the batched kernels and under lut_xla
    (``KV_BEAM_NEW`` new tokens): the same hypotheses in the same order,
    scores within 1e-4 relative; a spec:draft1b request (spec k 4, under
    lut_xla, ``KV_SPEC_NEW`` new tokens) on a draft of zero extra weight
    bytes, its verify steps, mean accepted drafts and agreement with the
    greedy stream recorded (capacity couples a burst's tokens: equality is
    not required). One lut_xla decode step of the pool is timed."""
    from repro_torch.serving.engine import Request, ServingEngine
    prompt = serve_prompts(cfg.vocab_size, seed=2)[0]
    xla = cfg.with_quant(mpgemm_mode="lut_xla", table_quant="per_row")
    out = {}

    def run(leg, c, decoding, n_new, **kw):
        eng = ServingEngine(c, params, **dict(SERVE_KW, **kw))
        req = Request(uid=0, prompt=prompt, max_new_tokens=n_new,
                      decoding=decoding)
        t0 = time.perf_counter()
        eng.submit(req)
        eng.run_to_completion()
        torch.cuda.synchronize()
        st = eng.stats()
        out[leg] = {"seconds": time.perf_counter() - t0,
                    "decode_tok_s": st["decode_tok_s"],
                    "host_syncs_per_token": st["host_syncs_per_token"]}
        # one sync a decode chunk: a short request's one chunk too
        if (not req.done or len(req.output) != n_new or st["decode_syncs"]
                > -(-st["decode_tokens"] // eng.decode_chunk)):
            raise AssertionError(f"moe int8 {leg}: {out[leg]}, "
                                 f"{st['decode_syncs']} syncs")
        return eng, req

    _, b1 = run("beam1", cfg, "beam:1", 16)
    if b1.output != greedy:
        raise AssertionError("moe int8: beam:1 differs from greedy")
    beams = {}
    for leg, c in (("beam2_lut_pallas", cfg), ("beam2_lut_xla", xla)):
        eng, req = run(leg, c, "beam:2", KV_BEAM_NEW,
                       decode_chunk=KV_BEAM_NEW)
        beams[leg] = req.beams
    # one more lut_xla decode step of the pool, timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._forward(params, eng.last_tok[:, None], eng.pos)
    torch.cuda.synchronize()
    out["lut_xla_step_s"] = time.perf_counter() - t0
    del eng
    got, want = beams["beam2_lut_pallas"], beams["beam2_lut_xla"]
    if (len(got) != 2 or [list(t) for t, _ in got]
            != [list(t) for t, _ in want]
            or not np.allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-4, atol=0)):
        raise AssertionError(f"moe int8: beam:2 through the kernels {got} "
                             f"vs lut_xla {want}")
    out["beams"] = [(list(t), s) for t, s in got]
    eng, req = run("spec_lut_xla", xla, "spec:draft1b", KV_SPEC_NEW,
                   spec_k=4, spec_draft_planes=1, decode_chunk=KV_SPEC_NEW)
    sp = eng.stats()["spec"]
    if sp["draft_extra_hbm_bytes"] != 0 or sp["verify_steps"] <= 0:
        raise AssertionError(f"moe int8: spec stats {sp}")
    out["spec"] = dict(sp, output=req.output,
                       agreement=stream_agreement([req.output],
                                                  [greedy[:KV_SPEC_NEW]]))
    return out


def made(cfg):
    """``cfg``'s params from seed 0, made on the card; (params, seconds)."""
    from repro_torch.models import api
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = api.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def kvint8_phase():
    """Phase 15 (module docstring): the int8 KV cache at full width, each
    model made from seed 0 and freed after its part. Returns the record."""
    t_start = time.perf_counter()
    rec = {}

    # (a) tinyllama-1.1b, KV_TINY_LAYERS of its 22 layers
    cfg = main_config().replace(n_layers=KV_TINY_LAYERS)
    c8 = cfg.replace(kv_cache_dtype="int8")
    params, init_s = made(cfg)
    per_step = (len(projection_shapes(cfg)) - 1) * cfg.n_layers + 1
    serve(cfg, params, seed=1)  # warm-up
    eng32, reqs32 = serve(cfg, params, seed=2)
    eng8, reqs8, a = int8_serve("kvint8 tinyllama", c8, params, {
        "fused_lut_mpgemm": per_step, "row_scale": per_step})
    a.update(init_s=init_s, serve_f32=eng32.stats(),
             agreement_vs_f32=stream_agreement(a["outputs"],
                                               [r.output for r in reqs32]))
    a["cache_bytes"] = check_cache_bytes("kvint8 tinyllama", cfg, params)
    a["paged_cache_bytes"] = check_cache_bytes(
        "kvint8 tinyllama paged", cfg, params, cache_block_size=16,
        num_cache_blocks=96)
    # profiles in turns, f32 then int8, each with its launches
    a["profile_f32"], a["profile_int8"] = (step_and_chunk(eng32),
                                           step_and_chunk(eng8))
    a["added_kernels"] = {what: added_kernels(a["profile_f32"][what],
                                              a["profile_int8"][what])
                          for what in ("decode_step", "prefill_chunk")}
    a["forward"] = int8_forward(cfg, params)
    a["paged"] = int8_paged("kvint8 tinyllama", c8, params)
    a["beam"] = beam_legs("kvint8 tinyllama", c8, params, paged=False)
    rec["tinyllama-1.1b"] = a
    del eng32, eng8, params
    gc_cuda()
    rec["tinyllama_s"] = time.perf_counter() - t_start

    # (b) olmoe-1b-7b, its depth cut to KV_MOE_LAYERS
    t0 = time.perf_counter()
    cfg = moe_config().replace(n_layers=KV_MOE_LAYERS)
    c8 = cfg.replace(kv_cache_dtype="int8")
    params, init_s = made(cfg)
    experts = 3 * cfg.n_layers
    eng8, reqs8, b = int8_serve("kvint8 olmoe", c8, params, {
        "fused_lut_mpgemm_batched": experts, "fused_lut_mpgemm": 1,
        "row_scale": experts + 1})
    del eng8
    b["init_s"] = init_s
    _, paged_reqs = serve(c8, params, seed=2, cache_block_size=16)
    if [r.output for r in paged_reqs] != b["outputs"]:
        raise AssertionError("kvint8 olmoe: paged int8 streams differ from "
                             "the dense int8 ones")
    b["cache_bytes"] = check_cache_bytes("kvint8 olmoe", cfg, params)
    b["paged_cache_bytes"] = check_cache_bytes(
        "kvint8 olmoe paged", cfg, params, cache_block_size=16)
    b["decoding"] = moe_int8_decoding(c8, params, b["outputs"][0])
    b["seconds"] = time.perf_counter() - t0
    rec[MOE] = b
    del params
    gc_cuda()

    # (c) whisper-tiny and zamba2-7b, one int8 greedy serve each
    for arch in KV_FAMILIES:
        t0 = time.perf_counter()
        cfg = full_config(arch)
        c8 = cfg.replace(kv_cache_dtype="int8")
        params, init_s = made(cfg)
        n = projections_per_step(cfg)
        eng8, _, r = int8_serve(f"kvint8 {arch}", c8, params, {
            "fused_lut_mpgemm": n, "row_scale": n})
        r.update(init_s=init_s, decode_step_wall_ms=decode_step_wall(eng8),
                 cache_bytes=check_cache_bytes(f"kvint8 {arch}", cfg,
                                               params))
        del eng8
        if cfg.family == "hybrid":
            r["cache_dtypes"] = cache_dtype_forward(cfg, params)
        r["seconds"] = time.perf_counter() - t0
        rec[arch] = r
        del params
        gc_cuda()
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def kvint8_lines(rec):
    """Phase 15's record as text."""
    a = rec["tinyllama-1.1b"]
    lines = []
    for arch in KV_ARCHS:
        r = rec[arch]
        st, ag = r["serve"], r.get("agreement_vs_f32")
        lines.append(
            f"kvint8: {arch}"
            + (f" ({KV_MOE_LAYERS} of its 16 layers)" if arch == MOE else "")
            + ", int8 KV cache, phase 4's requests: "
            f"{st['decode_tokens']} tokens, decode {st['decode_tok_s']:.1f} "
            f"tok/s, host syncs/token {st['host_syncs_per_token']:.4f}; "
            f"launches {r['launches']}; an int8 decode chunk under torch's "
            f"sync check: launches {r['decode_chunk_launches']}; cache bytes "
            f"f32 {r['cache_bytes']['bf16']} / int8 "
            f"{r['cache_bytes']['int8']} (the formula)"
            + (f", paged f32 {r['paged_cache_bytes']['bf16']} / int8 "
               f"{r['paged_cache_bytes']['int8']}"
               if "paged_cache_bytes" in r else "")
            + (f"; streams vs the f32 cache: {ag['equal_tokens']} of "
               f"{ag['tokens']} tokens equal, agreeing prefixes "
               f"{ag['agreeing_prefix']}" if ag else "")
            + f"; params made in {r['init_s']:.1f} s")
    for tq, z in rec["zamba2-7b"]["cache_dtypes"].items():
        lines.append(
            f"kvint8: zamba2-7b teacher-forced forward (120 tokens "
            f"prefilled, 8 decode steps; {tq} tables, the kernels) against "
            f"the f32 cache's: " + "; ".join(
                f"{n} cache: decode logits corrcoef {z[n]['corrcoef']:.6f}, "
                f"max |diff| {z[n]['max_abs_diff']:.4g}, argmax equal at "
                f"{z[n]['argmax_equal']} of 8; the prefill's last position "
                f"max |diff| {z[n]['prefill_last_max_abs_diff']:.4g}, argmax "
                + ("equal" if z[n]["prefill_last_argmax_equal"]
                   else "differs") for n in ("bf16", "int8"))
            + f"; the f32 cache's top-2 margin "
            f"{z['f32_top2_margin_prefill_last']:.4g} at the prefill's last "
            f"position, {z['f32_top2_margin_first_decode']:.4g} at the first "
            f"decode step (max |logit| {z['max_abs_logit']:.4g})")
    for what in ("decode_step", "prefill_chunk"):
        p32, p8 = a["profile_f32"][what], a["profile_int8"][what]
        lines.append(
            f"kvint8: tinyllama {what.replace('_', ' ')}, f32 vs int8 cache: "
            + " vs ".join(
                "busy not measured" if p["busy_ms"] is None else
                f"{p['kernels']:g} kernels, busy {p['busy_ms']:.2f} / wall "
                f"{p['wall_ms']:.2f} ms (idle {p['idle_share']:.3f})"
                for p in (p32, p8))
            + "; added kernels: " + ", ".join(
                f"{n} +{d:g}" for n, d in a["added_kernels"][what][:8]))
    fw, pg = a["forward"], a["paged"]
    vs = lambda r: (f"corrcoef {r['corrcoef']:.6f}, max |diff| "
                    f"{r['max_abs_diff']:.4g}, argmax equal at "
                    f"{r['argmax_equal']} of 8")
    lines.append(
        f"kvint8: tinyllama 128-token forward on int8 caches, lut_pallas vs "
        f"lut_xla max |logit diff| {fw['parity_max_abs_diff']} (exact); the "
        f"8 decode positions vs the f32 cache's: " + "; ".join(
            f"{tq} tables (max |logit| {fw[tq]['max_abs_logit']:.4g}): after "
            f"an exact prefill (the reference test's setting) "
            f"{vs(fw[tq]['exact_prefill'])}, after the engine's prefill "
            f"{vs(fw[tq]['engine_prefill'])}, a bf16 cache (control) "
            f"{vs(fw[tq]['bf16_cache_control'])}" for tq in ("None",
                                                             "per_row"))
        + f"; gate: None, exact prefill, corrcoef > {KV_CORRCOEF}")
    lines.append(
        f"kvint8: tinyllama paged int8 (block 16, 96 blocks, prefix "
        f"sharing) vs dense int8 on phase 6's {pg['requests']} requests: "
        f"near-tie divergences {pg['divergences']}, "
        f"{pg['prefill_tokens_reused']} tokens reused (rule "
        f"{pg['expected_reuse']}); beam:2 through the kernels = lut_xla "
        "(legs " + ", ".join(f"{k} {a['beam'][k]['seconds']:.1f} s"
                             for k in ("lut_pallas", "lut_xla"))
        + ")")
    d = rec[MOE]["decoding"]
    sp = d["spec"]
    lines.append(
        f"kvint8: {MOE} int8 decoding: paged = dense; beam:1 = greedy; "
        f"one lut_xla decode step {d['lut_xla_step_s']:.2f} s; beam:2 "
        f"({KV_BEAM_NEW} tokens) through the batched kernels = lut_xla, "
        f"scores {[round(s, 6) for _, s in d['beams']]}; spec:draft1b "
        f"(spec k 4, lut_xla, {KV_SPEC_NEW} tokens): {sp['verify_steps']} "
        f"verify steps, {sp['mean_accepted_per_step']:.2f} drafts accepted a"
        f" step, extra weight bytes {sp['draft_extra_hbm_bytes']}, "
        f"{sp['agreement']['equal_tokens']} of {KV_SPEC_NEW} tokens equal to"
        f" greedy; legs " + ", ".join(
            f"{k} {v['seconds']:.1f} s" for k, v in d.items()
            if isinstance(v, dict) and "seconds" in v))
    lines.append(f"kvint8: phase 15 in {rec['seconds']:.1f} s (tinyllama "
                 f"{rec['tinyllama_s']:.1f}, olmoe "
                 f"{rec[MOE]['seconds']:.1f}, " + ", ".join(
                     f"{arch} {rec[arch]['seconds']:.1f}"
                     for arch in KV_FAMILIES) + ")")
    return lines


# ---------------------------------------------------------------------------
# phase 16: QAT training on the SSM, hybrid, VLM and audio families
# ---------------------------------------------------------------------------

FAMILY_STEPS = 10
FAMILY_SEQ = 256
# the legs, in order: arch -> (layers kept, None for all; batch; optimizer;
# microbatches)
FAMILY_LEGS = {
    "falcon-mamba-7b": (4, 4, "adamw", 1),
    "zamba2-7b": (13, 4, "adafactor", 1),
    "llama-3.2-vision-11b": (5, 2, "adamw", 1),
    "whisper-tiny": (None, 8, "adamw", 2),
}
# lr_schedule(FAMILY_LR, warmup=FAMILY_WARMUP, total=FAMILY_STEPS)
FAMILY_LR, FAMILY_WARMUP = 3e-4, 3
# the least fall (nats) of step 0's batch's loss over the steps: a no-op
# update gives 0, a wrong-signed one a rise
FAMILY_FIXED_DROP = 0.05
# the leg that first trains with the 8-bit AdamW, a record (no gate): the
# reference's INT8 m and v diverge (PERF.md §6)
FAMILY_8BIT = "falcon-mamba-7b"
# the engine leg of falcon-mamba-7b's trained weights: requests x new tokens
FAMILY_SERVE = (2, 8)


def family_config(arch, layers):
    """``arch`` at full width as phase 16 trains it: f32 activations, W2
    symmetric K=4 QAT (the config's quant block), its depth cut to
    ``layers`` (None: whole)."""
    from repro_torch.configs import registry
    cfg = registry.get_config(arch).replace(activation_dtype=torch.float32)
    return cfg if layers is None else cfg.replace(n_layers=layers)


def family_batch(cfg, data, step):
    """``data``'s batch at ``step``; for the VLM and whisper with the stub
    frontend's input beside the tokens: [batch, n, d_model] normal draws ×
    0.1 made on the card from seed 1000 + step."""
    batch = data.batch_at(step)
    if cfg.family in ("vlm", "audio"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1000 + step)
        vlm = cfg.family == "vlm"
        n = cfg.n_image_tokens if vlm else cfg.n_audio_frames
        batch["image_embeds" if vlm else "audio_frames"] = 0.1 * torch.randn(
            data.batch, n, cfg.d_model, generator=gen, device="cuda")
    return batch


def family_forward(tag, cfg, params):
    """A teacher-forced forward of the trained, packed weights: 128 tokens
    prefilled at offset 0 into a batch-1 f32 cache (the engine's prefill
    chunk; with the stub frontend's input, ``stub_inputs``, for the VLM
    and whisper), then 8 per-slot decode steps (positions 128-135),
    through the kernels (lut_pallas, the launch counts set to 0 just
    before and read just after) and the plain LUT path (lut_xla), per_row:
    logits [1, 136, V] finite and equal bit for bit, every kernel of the
    per_row path launched (the staged pair in the prefill, the fused
    lookup and its row scale in the decode steps)."""
    from repro_torch.models import api
    s = 136
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, s)), device="cuda")
    extra = (dict([stub_inputs(cfg)]) if cfg.family in ("vlm", "audio")
             else {})

    def run(mode):
        c = cfg.with_quant(mpgemm_mode=mode, table_quant="per_row")
        cache = api.init_cache(c, 1, s, dtype=torch.float32, device="cuda")
        prefill = api.forward(params, dict(extra, tokens=toks[:, :128]), c,
                              caches=cache, cache_pos=0)[0]
        return torch.cat([prefill] + decode_steps(params, c, toks, 128,
                                                  cache), dim=1)

    reset_counts()
    a = run("lut_pallas")
    torch.cuda.synchronize()
    launches = read_counts()
    b = run("lut_xla")
    if (tuple(a.shape) != (1, s, cfg.vocab_size)
            or not (torch.isfinite(a).all() and torch.isfinite(b).all())):
        raise AssertionError(f"{tag}: bad logits {tuple(a.shape)}")
    diff = (a - b).abs().max().item()
    if diff != 0.0:
        raise AssertionError(f"{tag}: kernels and plain path disagree, max "
                             f"|logit diff| {diff}")
    if min(launches[n] for n in PER_ROW_PATH) <= 0:
        raise AssertionError(f"{tag}: a kernel never ran: {launches}")
    return {"parity_max_abs_diff": diff,
            "max_abs_logit": a.abs().max().item(), "launches": launches}


def family_engine(tag, cfg, params):
    """The trained, packed weights through phase 4's engine
    (``SERVE_KW``): ``FAMILY_SERVE`` requests (phase 4's first prompts)
    with the launch counts set to 0 just before and read just after: every
    request finishes its tokens, every kernel of the per_row path ran, <=
    1/decode_chunk host syncs a token; one more decode chunk under torch's
    sync check launches exactly one fused lookup and one row scale per
    packed projection a step (``projections_per_step``)."""
    from repro_torch.serving.engine import Request, ServingEngine
    n_req, n_new = FAMILY_SERVE
    t0 = time.perf_counter()
    reset_counts()
    eng = ServingEngine(cfg, params, **SERVE_KW)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in
            enumerate(serve_prompts(cfg.vocab_size, seed=2)[:n_req])]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    launches = read_counts()
    st = eng.stats()
    if not all(r.done and len(r.output) == n_new for r in reqs):
        raise AssertionError(f"{tag}: a request did not finish {n_new} "
                             "tokens")
    if min(launches[n] for n in PER_ROW_PATH) <= 0:
        raise AssertionError(f"{tag}: a kernel never ran: {launches}")
    if st["host_syncs_per_token"] > 1.0 / eng.decode_chunk:
        raise AssertionError(f"{tag}: {st['host_syncs_per_token']} host "
                             f"syncs per token > 1/{eng.decode_chunk}")
    per_step = projections_per_step(cfg)
    chunk = checked_decode_chunk(tag, eng, {"fused_lut_mpgemm": per_step,
                                            "row_scale": per_step})
    return {"outputs": [r.output for r in reqs], "launches": launches,
            "decode_chunk_launches": chunk,
            "decode_tok_s": st["decode_tok_s"],
            "host_syncs_per_token": st["host_syncs_per_token"],
            "seconds": time.perf_counter() - t0}


def family_loss(cfg, params, batch):
    """The QAT training loss (``make_loss_fn``) of ``params`` on ``batch``,
    no grad: the fixed batch that phase 16's gate reads before and after
    the steps."""
    from repro_torch.training.train_loop import make_loss_fn
    b = {k: torch.as_tensor(v, device="cuda").to(
        torch.int64 if k in ("tokens", "labels") else torch.float32)
         for k, v in batch.items()}
    with torch.no_grad():
        loss, _ = make_loss_fn(cfg.with_quant(qat=True))(params, b)
    return float(loss)


def family_train(cfg, opt_name, batch, micro, lr):
    """``FAMILY_STEPS`` QAT steps of ``cfg`` through ``make_train_step``,
    float params made on the card from seed 0 (the VLM's gates set to
    ``XATTN_GATE``), ``SyntheticLM(seed=0)`` batches (``family_batch``),
    ``opt_name`` with ``lr_schedule(lr, FAMILY_WARMUP, FAMILY_STEPS)``.
    Returns (the trained params, a record: losses, grad norms, ms a step,
    the median of steps 2-10 and tokens a second over them, peak device
    memory from the params' making on, the device memory already held
    when the run began, and the loss of step 0's batch under the params
    before the first step and after the last, ``family_loss``)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    opt = opt_mod.make_optimizer(opt_name, lr=opt_mod.lr_schedule(
        lr, warmup=FAMILY_WARMUP, total=FAMILY_STEPS))
    step_fn = make_train_step(cfg, opt, microbatches=micro, qat=True)
    data = SyntheticLM(cfg.vocab_size, batch, FAMILY_SEQ, seed=0)
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    # in a box that train_steps empties: the VLM's state (params, m and v:
    # 25.7 GB) must not outlive its first step
    box = [init_train_state(gen, cfg, opt, "cuda")]
    for xp in box[0]["params"].get("xattn_layers", []):
        xp["gate_attn"].fill_(XATTN_GATE)
        xp["gate_mlp"].fill_(XATTN_GATE)
    torch.cuda.synchronize()
    rec = {"optimizer": opt_name, "lr": lr,
           "init_s": time.perf_counter() - t0,
           "params": sum(p.numel() for p in tree_leaves(box[0]["params"])),
           "base_bytes": base}
    fixed = family_batch(cfg, data, 0)
    rec["fixed_before"] = family_loss(cfg, box[0]["params"], fixed)
    state, losses, gnorms, ms, _ = train_steps(
        step_fn, box, lambda step: family_batch(cfg, data, step),
        range(FAMILY_STEPS))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["fixed_after"] = family_loss(cfg, state["params"], fixed)
    later = sorted(ms[1:])
    rec.update(losses=losses, grad_norms=gnorms, step_ms=ms,
               step_ms_median=later[len(later) // 2],
               tokens_s=(batch * FAMILY_SEQ * (FAMILY_STEPS - 1)
                         / (sum(ms[1:]) / 1e3)),
               first3=float(np.mean(losses[:3])),
               last3=float(np.mean(losses[-3:])))
    return state["params"], rec


def family_train_leg(arch, lr):
    """One leg of phase 16 (module docstring): ``arch`` at full width, its
    depth cut as ``FAMILY_LEGS`` says, trained (``family_train``) at base
    lr ``lr``: every loss and grad norm finite, the mean of the last 3
    losses below the first 3's, and step 0's batch's loss after the steps
    at least ``FAMILY_FIXED_DROP`` below its loss before them (a fall that
    the batches' order cannot make); then its params packed and served (``family_forward``;
    falcon-mamba-7b also ``family_engine``), the model freed. The
    ``FAMILY_8BIT`` leg first trains the same model with the 8-bit AdamW,
    recorded, not gated. Returns the record."""
    from repro_torch.models import quantized
    layers, batch, opt_name, micro = FAMILY_LEGS[arch]
    t_leg = time.perf_counter()
    cfg = family_config(arch, layers)
    rec = {"layers": cfg.n_layers, "batch": batch, "seq": FAMILY_SEQ,
           "microbatches": micro, "steps": FAMILY_STEPS}
    if arch == FAMILY_8BIT:
        rec["adamw8bit"] = family_train(cfg, "adamw8bit", batch, micro,
                                        lr)[1]
    trained, r = family_train(cfg, opt_name, batch, micro, lr)
    rec.update(r)
    if not all(np.isfinite(r["losses"] + r["grad_norms"])):
        raise AssertionError(f"train {arch}: a loss or grad norm is not "
                             f"finite: {r['losses']} {r['grad_norms']}")
    if not (r["last3"] < r["first3"] and r["fixed_after"]
            < r["fixed_before"] - FAMILY_FIXED_DROP):
        raise AssertionError(
            f"train {arch}: the loss did not fall: first 3 {r['first3']}, "
            f"last 3 {r['last3']}; step 0's batch {r['fixed_before']} -> "
            f"{r['fixed_after']} (at least {FAMILY_FIXED_DROP} lower "
            f"wanted); losses {r['losses']}, grad norms {r['grad_norms']}")
    gc_cuda()
    scfg = full_config(arch).replace(n_layers=cfg.n_layers)
    t0 = time.perf_counter()
    packed = quantized.quantize_params(trained, scfg.quant)
    torch.cuda.synchronize()
    rec["quantize_s"] = time.perf_counter() - t0
    del trained
    gc_cuda()
    rec["forward"] = family_forward(f"train {arch}", scfg, packed)
    if arch == "falcon-mamba-7b":
        rec["engine"] = family_engine(f"train {arch}", scfg, packed)
    del packed
    gc_cuda()
    rec["seconds"] = time.perf_counter() - t_leg
    return rec


def train_families_phase(lr=FAMILY_LR):
    """Phase 16: the legs of ``FAMILY_LEGS`` in order at base lr ``lr``,
    each model freed before the next. Returns the record."""
    t0 = time.perf_counter()
    rec = {}
    for arch in FAMILY_LEGS:
        gc_cuda()
        print(f"train families: {arch} leg begins with "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held",
              flush=True)
        rec[arch] = family_train_leg(arch, lr)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def train_families_lines(rec):
    """Phase 16's record as text, one line a leg."""
    lines = []
    for arch, (layers, _, _, _) in FAMILY_LEGS.items():
        r, fw = rec[arch], rec[arch]["forward"]
        lines.append(
            f"train families: {arch} ({r['layers']} layers"
            + ("" if layers is None else ", depth cut")
            + f", {r['params'] / 1e9:.3f} B params), QAT W2, "
            f"{r['optimizer']} lr_schedule({r['lr']}, {FAMILY_WARMUP}, "
            f"{r['steps']}), batch {r['batch']} x seq {r['seq']}"
            + (f" in {r['microbatches']} microbatches"
               if r["microbatches"] > 1 else "")
            + f": median step {r['step_ms_median']:.1f} ms (first "
            f"{r['step_ms'][0]:.1f}), {r['tokens_s']:.0f} tokens/s over steps "
            f"2-{r['steps']}; peak device memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB (held before the leg "
            f"{r['base_bytes'] / 2**30:.2f}); loss {r['losses'][0]:.4f} "
            f"-> {r['losses'][-1]:.4f} (mean of the first 3 "
            f"{r['first3']:.4f}, last 3 {r['last3']:.4f}); step 0's batch "
            f"{r['fixed_before']:.4f} -> {r['fixed_after']:.4f}; grad norms "
            f"{r['grad_norms'][0]:.4g} -> {r['grad_norms'][-1]:.4g}; "
            f"packed in {r['quantize_s']:.1f} s; teacher-forced forward "
            f"(128 prefilled, 8 decode steps) lut_pallas vs lut_xla max "
            f"|logit diff| {fw['parity_max_abs_diff']} (exact; max |logit| "
            f"{fw['max_abs_logit']:.4g}), launches {fw['launches']}"
            + ("" if "engine" not in r else
               f"; engine, {FAMILY_SERVE[0]} requests x {FAMILY_SERVE[1]} "
               f"tokens: decode {r['engine']['decode_tok_s']:.1f} tok/s, "
               f"host syncs/token {r['engine']['host_syncs_per_token']:.4f}"
               f", launches {r['engine']['launches']}, a decode chunk under "
               f"torch's sync check {r['engine']['decode_chunk_launches']}")
            + f"; params made in {r['init_s']:.1f} s; leg "
            f"{r['seconds']:.1f} s")
        if "adamw8bit" in r:
            e = r["adamw8bit"]
            lines.append(
                f"train families: {arch}, the same model and data with "
                f"adamw8bit (a record, no gate): losses "
                f"{[round(x, 3) for x in e['losses']]}, grad norms "
                f"{[round(x, 4) for x in e['grad_norms']]}; step 0's batch "
                f"{e['fixed_before']:.4f} -> {e['fixed_after']:.4f}; median step "
                f"{e['step_ms_median']:.1f} ms, {e['tokens_s']:.0f} tokens/s;"
                f" peak device memory {e['peak_bytes'] / 2**30:.2f} GiB")
    lines.append(f"train families: phase 16 in {rec['seconds']:.1f} s")
    return lines


# ---------------------------------------------------------------------------
# phase 17: sliding-window attention, the rolling KV cache
# ---------------------------------------------------------------------------

WINDOW_ARCH = "zamba2-7b"
# its depth: 13 of 81 layers, two invocations of the shared block (as
# phase 16 (b) cuts it)
WINDOW_LAYERS = 13
WINDOW_CHUNK = 128         # prefill chunk
WINDOW_DECODE = 64         # greedy s = 1 steps past the wrap


def window_stream(cfg, params, prompt, cache, window):
    """Greedy decoding of ``prompt`` [1, P] through ``cache`` under the
    window: the prompt prefilled in WINDOW_CHUNK-token chunks at offsets
    0, 128, ..., then WINDOW_DECODE s = 1 steps at positions P, P + 1, ...
    Returns (tokens, the logits that picked them [WINDOW_DECODE + 1, V],
    seconds)."""
    from repro_torch.models import api
    p = prompt.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for off in range(0, p, WINDOW_CHUNK):
        last = off + WINDOW_CHUNK >= p
        logits = api.forward(params, {"tokens": prompt[:, off:off
                                                       + WINDOW_CHUNK]},
                             cfg, caches=cache, cache_pos=off, head=last,
                             window=window)[0]
    rows = [logits[0, -1]]
    toks = [int(rows[-1].argmax())]
    for j in range(WINDOW_DECODE):
        tok = torch.tensor([[toks[-1]]], device="cuda")
        rows.append(api.forward(params, {"tokens": tok}, cfg, caches=cache,
                                cache_pos=p + j, window=window)[0][0, -1])
        toks.append(int(rows[-1].argmax()))
    torch.cuda.synchronize()
    return toks, torch.stack(rows), time.perf_counter() - t0


def attn_kv_bytes(cache) -> int:
    """Bytes of a cache tree's attention K/V leaves (the hybrid's "kv")."""
    from repro_torch.core.tree import tree_leaves
    kv = cache["kv"] if isinstance(cache, dict) else cache
    return sum(t.numel() * t.element_size() for t in tree_leaves(kv))


def window_phase():
    """Phase 17 (module docstring): zamba2-7b at full width, 13 of its 81
    layers, lut_pallas, decoding past the wrap of long_500k's 8192-token
    rolling window. Returns the record."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import api
    t_start = time.perf_counter()
    base = full_config(WINDOW_ARCH).replace(n_layers=WINDOW_LAYERS)
    shape = base.shape("long_500k")
    window = shape.window
    params, made_s = made(base)
    rec = {"arch": WINDOW_ARCH, "layers": WINDOW_LAYERS, "window": window,
           "shape": vars(shape), "params_s": made_s}
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, base.vocab_size, (1, window)), device="cuda")
    s_cache = window + WINDOW_DECODE + 1

    # (a) float tables: the rolling cache against a full-length cache with
    # the window mask, 64 greedy steps past the wrap
    cfg_f = base.with_quant(table_quant=None)
    reset_counts()
    rolling = api.init_cache(cfg_f, 1, s_cache, torch.float32, "cuda",
                             window=window)
    if rolling["kv"][0].shape[2] != window:
        raise AssertionError(f"window: the rolling cache holds "
                             f"{rolling['kv'][0].shape[2]} positions, not "
                             f"{window}")
    got, got_logits, roll_s = window_stream(cfg_f, params, prompt, rolling,
                                            window)
    float_launches = read_counts()
    full = api.init_cache(cfg_f, 1, s_cache, torch.float32, "cuda")
    want, want_logits, full_s = window_stream(cfg_f, params, prompt, full,
                                              window)
    del full
    j = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y), None)
    upto = len(got) if j is None else j + 1
    gap = (got_logits[:upto] - want_logits[:upto]).abs().max().item()
    div = None
    if j is not None:
        top2 = torch.topk(want_logits[j], 2).values
        div = {"step": j, "margin": (top2[0] - top2[1]).item()}
        if div["margin"] > MARGIN:
            raise AssertionError(
                f"window: the rolling and full-cache streams diverge at step "
                f"{j} (position {window + j - 1}) with top-2 margin "
                f"{div['margin']} > {MARGIN}")
    if not (torch.isfinite(got_logits).all()
            and got_logits.shape == (WINDOW_DECODE + 1, base.vocab_size)):
        raise AssertionError(f"window: bad logits {tuple(got_logits.shape)}")
    rec["a"] = {"tokens": len(got), "equal_tokens_before_divergence": upto
                if j is None else j, "divergence": div,
                "max_logit_gap": gap,
                "max_abs_logit": want_logits.abs().max().item(),
                "rolling_s": roll_s, "full_cache_s": full_s,
                "launches": float_launches}

    # (b) per_row: one decode step past the wrap, kernels vs lut_xla, from
    # clones of the rolling cache
    pos = window + WINDOW_DECODE
    tok = torch.tensor([[got[-1]]], device="cuda")
    step = {}
    for mode in ("lut_pallas", "lut_xla"):
        c = base.with_quant(mpgemm_mode=mode, table_quant="per_row")
        cache = tree_map(lambda t: t.clone(), rolling)
        if mode == "lut_pallas":
            reset_counts()
        step[mode] = api.forward(params, {"tokens": tok}, c, caches=cache,
                                 cache_pos=pos, window=window)[0]
        if mode == "lut_pallas":
            torch.cuda.synchronize()
            kernel_launches = read_counts()
        del cache
    diff = (step["lut_pallas"] - step["lut_xla"]).abs().max().item()
    if diff != 0.0:
        raise AssertionError(f"window: a rolling decode step past the wrap, "
                             f"kernels vs lut_xla: max |logit diff| {diff}")
    launches = {n: (float_launches[n] or 0) + (kernel_launches[n] or 0)
                for n in float_launches}
    if min(launches[n] for n in PER_ROW_PATH) <= 0:
        raise AssertionError(f"window: a kernel never ran: {launches}")
    rec["b"] = {"position": pos, "max_abs_diff": diff,
                "launches": kernel_launches}
    rec["launches"] = launches

    # (c) the rolling cache's bytes against attn_cache's formula, here and
    # at long_500k's full depth; the per_row decode step's wall and busy
    n_attn = base.n_layers // base.attn_every
    kv_f32 = n_attn * window * 2 * base.n_kv_heads * base.head_dim * 4
    if attn_kv_bytes(rolling) != kv_f32:
        raise AssertionError(f"window: rolling cache of "
                             f"{attn_kv_bytes(rolling)} bytes, the formula "
                             f"gives {kv_f32}")
    full_cfg = full_config(WINDOW_ARCH, whole=True)
    meta = lambda w: attn_kv_bytes(api.init_cache(
        full_cfg, shape.global_batch, shape.seq_len, device="meta",
        window=w))
    n_full = full_cfg.n_layers // full_cfg.attn_every
    formula = lambda s: (n_full * s * 2 * full_cfg.n_kv_heads
                         * full_cfg.head_dim * 2)
    rec["c"] = {"kv_bytes_here_f32": kv_f32,
                "long_500k_bf16_rolling": meta(window),
                "long_500k_bf16_full": meta(None)}
    if (rec["c"]["long_500k_bf16_rolling"] != formula(window)
            or rec["c"]["long_500k_bf16_full"] != formula(shape.seq_len)):
        raise AssertionError(f"window: long_500k cache bytes {rec['c']} "
                             f"against the formula")
    c_k = base.with_quant(table_quant="per_row")
    cache = tree_map(lambda t: t.clone(), rolling)
    rec["c"]["decode_step"] = busy_profile(lambda: api.forward(
        params, {"tokens": tok}, c_k, caches=cache, cache_pos=pos,
        window=window))
    del cache, rolling, params
    gc_cuda()
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def window_lines(rec):
    a, b, c = rec["a"], rec["b"], rec["c"]
    step = c["decode_step"]
    busy = ("device busy not measured" if step["busy_ms"] is None else
            f"device busy {step['busy_ms']:.2f} ms (idle share "
            f"{step['idle_share']:.3f}) in {step['kernels']} CUDA kernels")
    agree = ("all agree" if a["divergence"] is None else
             f"agree up to step {a['divergence']['step']}, a near tie "
             f"(top-2 margin {a['divergence']['margin']:.4f} <= {MARGIN})")
    return [
        f"window: {rec['arch']}, {rec['layers']} layers, window "
        f"{rec['window']} (long_500k), float tables: an {rec['window']}-token "
        f"prompt in {WINDOW_CHUNK}-token chunks, then {WINDOW_DECODE} greedy "
        f"steps past the wrap on the rolling cache ({a['rolling_s']:.1f} s) "
        f"and on a full-length cache under the window mask "
        f"({a['full_cache_s']:.1f} s): {a['tokens']} tokens, {agree}; "
        f"largest logit gap over the compared steps {a['max_logit_gap']:.4g} "
        f"(max |logit| {a['max_abs_logit']:.4g}); launches {a['launches']}",
        f"window: per_row, one decode step at position {b['position']} "
        f"(slot {b['position'] % rec['window']}) from clones of the rolling "
        f"cache: lut_pallas vs lut_xla max |logit diff| {b['max_abs_diff']} "
        f"(tolerance 0: exact); launches {b['launches']}",
        f"window: cache bytes, rolling K/V here {c['kv_bytes_here_f32']} "
        f"(f32, {rec['layers'] // 6} invocations x {rec['window']} "
        f"positions, as attn_cache's formula); long_500k at full depth "
        f"(bf16): rolling "
        f"{c['long_500k_bf16_rolling']} B against "
        f"{c['long_500k_bf16_full']} B without the window; per_row decode "
        f"step past the wrap: wall {step['wall_ms']:.2f} ms, {busy}; phase "
        f"17 in {rec['seconds']:.1f} s"]


# ---------------------------------------------------------------------------
# phase 18: the offline-CW weight store
# ---------------------------------------------------------------------------

def cw_phase():
    """Phase 18 (module docstring): full-width tinyllama-1.1b under
    lut_xla, the offline-CW store against the packed store. Returns the
    record."""
    from repro_torch.models import api
    from repro_torch.models import quantized as qz
    from repro_torch.serving.engine import ServingEngine
    t_start = time.perf_counter()
    cfg = main_config().with_quant(mpgemm_mode="lut_xla",
                                   table_quant="per_row")
    params, made_s = made(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cw = qz.to_cw_params(params)
    torch.cuda.synchronize()
    rec = {"params_s": made_s, "expand_s": time.perf_counter() - t0,
           "packed_bytes": qz.quantized_bytes(params),
           "cw_bytes": qz.quantized_bytes(cw)}
    if not qz.has_cw(cw) or qz.has_cw(params):
        raise AssertionError("cw: the expanded tree holds no CW weight")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")
    a = api.forward(params, {"tokens": toks}, cfg)[0]
    b = api.forward(cw, {"tokens": toks}, cfg)[0]
    if tuple(a.shape) != (1, 128, cfg.vocab_size) or not torch.isfinite(
            a).all():
        raise AssertionError(f"cw: bad logits {tuple(a.shape)}")
    rec["forward_max_abs_diff"] = (a - b).abs().max().item()
    if rec["forward_max_abs_diff"] != 0.0:
        raise AssertionError(f"cw: CW vs packed 128-token forward, max "
                             f"|logit diff| {rec['forward_max_abs_diff']}")
    streams = {}
    for store, tree in (("packed", params), ("cw", cw)):
        # the engine keeps the tree it is given (store "packed" pins it
        # anywhere; on the card nothing is converted unless asked)
        t0 = time.perf_counter()
        eng, reqs = serve(cfg.with_quant(store=store), tree, seed=2)
        serve_s = time.perf_counter() - t0
        if qz.has_cw(eng.params) != (store == "cw"):
            raise AssertionError(f"cw: the {store} engine converted its tree")
        streams[store] = [r.output for r in reqs]
        # one step a decode chunk: the profile covers a single step
        eng.decode_chunk = 1
        rec[store] = {"serve": eng.stats(), "serve_s": serve_s,
                      "decode_step": decode_step_profile(eng)}
        del eng
    if streams["cw"] != streams["packed"]:
        raise AssertionError(f"cw: CW and packed greedy streams differ: "
                             f"{stream_agreement(streams['cw'], streams['packed'])}")
    rec["streams_equal"] = True
    try:
        ServingEngine(main_config(), cw, **SERVE_KW)
    except ValueError as e:
        rec["lut_pallas_refusal"] = str(e)[:120]
    else:
        raise AssertionError("cw: lut_pallas accepted the CW tree")
    del cw, params
    gc_cuda()
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def cw_lines(rec):
    step = lambda s: (f"wall {rec[s]['decode_step']['wall_ms']:.2f} ms, "
                      + ("device busy not measured"
                         if rec[s]["decode_step"]["busy_ms"] is None else
                         f"busy {rec[s]['decode_step']['busy_ms']:.2f} ms"))
    return [
        f"cw: tinyllama-1.1b, lut_xla, per_row: the packed tree "
        f"{rec['packed_bytes']} B, the CW tree {rec['cw_bytes']} B "
        f"(expanded in {rec['expand_s']:.2f} s); 128-token forward CW vs "
        f"packed max |logit diff| {rec['forward_max_abs_diff']} (tolerance "
        f"0: exact); 4-request greedy serves equal; one decode step, packed "
        f"{step('packed')}, CW {step('cw')}; decode tok/s packed "
        f"{rec['packed']['serve']['decode_tok_s']:.1f}, CW "
        f"{rec['cw']['serve']['decode_tok_s']:.1f}; lut_pallas on the CW "
        f"tree refused ({rec['lut_pallas_refusal']!r}); phase 18 in "
        f"{rec['seconds']:.1f} s"]


# ---------------------------------------------------------------------------
# phase 19: serving across a model-axis mesh
# ---------------------------------------------------------------------------

# (b): tinyllama-1.1b's meshes, 1 x m over ranks on the card (gloo where
# they share it, NCCL where each has its own); (c): olmoe-1b-7b's, at
# phase 15's depth (4 of 16 layers)
TP_MESHES = (2, 4)
TP_MOE_MESH, TP_MOE_LAYERS = 2, KV_MOE_LAYERS
# tinyllama-1.1b's depth in phases 19 (b) and 20 (b): 4 of its 22 layers
# at full width (gloo's host time a step grows with the layers), so that
# the script keeps to its time limit
MESH_LAYERS = 4
# the card's memory, bytes: the ranks' peaks must sum below it
CARD_BYTES = 80e9

# ranks kept up across phases 19-21, one pool a world size: a spawn's
# ranks take ~20 s to come up on the card (PERF.md §6), so each world's
# ranks start once and run each phase's function in turn; main() stops
# them at its end
_POOLS = {}


def pool_entry(rank, world, init_method, device, tasks, done, out_dir):
    """A pool rank: joins the group once (``launch.mesh.init_rank``), then
    runs each task ``(fn, args)`` of ``tasks`` as ``fn(rank, device,
    *args)`` until it gets None, the result saved under ``out_dir`` and
    ``(rank, path, error)`` put on ``done``."""
    import traceback
    from repro_torch.launch import mesh as mesh_mod
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = mesh_mod.init_rank(rank, world, init_method, device)
    try:
        for n in itertools.count():
            task = tasks.get()
            if task is None:
                return
            try:
                path = os.path.join(out_dir, f"rank{rank}_{n}.pt")
                fn, args = task
                torch.save(fn(rank, dev, *args), path)
                done.put((rank, path, None))
            except BaseException:
                done.put((rank, None, traceback.format_exc()))
                raise
            finally:
                gc_cuda()
    finally:
        torch.distributed.destroy_process_group()


class RankPool:
    """``world`` ranks spawned once (``launch.mesh.spawn``'s ranks, kept
    up): ``run(fn, args)`` is ``spawn(fn, world, args=args)`` on them,
    their results in rank order; a rank that fails or exits fails
    ``run`` and the pool is stopped."""

    def __init__(self, world, device="cuda"):
        import tempfile
        import torch.multiprocessing as mp
        from repro_torch.launch import mesh as mesh_mod
        mesh_mod.rank_device(0, device)  # raise here, not in every rank
        ctx = mp.get_context("spawn")
        self.world = world
        self.dir = tempfile.TemporaryDirectory(prefix="pool")
        self.tasks = [ctx.SimpleQueue() for _ in range(world)]
        self.done = ctx.Queue()
        init = f"tcp://localhost:{mesh_mod.free_port()}"
        self.procs = [ctx.Process(target=pool_entry, args=(
            r, world, init, device, self.tasks[r], self.done,
            self.dir.name)) for r in range(world)]
        self.closed = False
        for p in self.procs:
            p.start()

    def run(self, fn, args=()):
        import queue
        for q in self.tasks:
            q.put((fn, tuple(args)))
        paths = {}
        while len(paths) < self.world:
            try:
                rank, path, err = self.done.get(timeout=5)
            except queue.Empty:
                gone = [p.exitcode for p in self.procs if not p.is_alive()]
                if gone:
                    self.close()
                    raise RuntimeError(f"a pool rank exited: {gone}")
                continue
            if err is not None:
                self.close()
                raise RuntimeError(f"pool rank {rank} failed:\n{err}")
            paths[rank] = path
        out = [torch.load(paths[r], weights_only=False)
               for r in range(self.world)]
        for path in paths.values():
            os.remove(path)
        return out

    def close(self):
        """Stops the ranks: each ends its loop, or is terminated where it
        does not within 30 s (a rank in a collective whose peer failed)."""
        if self.closed:
            return
        self.closed = True
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        self.dir.cleanup()


def rank_pool(world) -> RankPool:
    """The pool of ``world`` ranks on the card, started at its first
    use."""
    if world not in _POOLS:
        _POOLS[world] = RankPool(world)
    return _POOLS[world]


def close_pools():
    while _POOLS:
        _POOLS.popitem()[1].close()


def tp_plan(m):
    """A 1 x m plan as rank 0 sees it, for shapes and the one-device
    control (no group)."""
    from repro_torch.distributed.sharding import AxisPlan, Mesh
    return AxisPlan(Mesh(("data", "model"), (1, m), (0, 0), {}))


def tp_shapes(cfg, m):
    """{projection: ((N, K), K_whole or None)} of a rank of a 1 x m mesh:
    column-parallel N / m (the head's vocab too); row-parallel K / m of a
    K_whole row (``wo``, ``down``); attention whole where its KV heads do
    not divide by m (``sharding.attention_split``)."""
    from repro_torch.distributed.sharding import attention_split
    full = projection_shapes(cfg)
    out = {}
    for name, (n, k) in full.items():
        if name in ("wq", "wk", "wv", "wo") and not attention_split(
                cfg, tp_plan(m)):
            out[name] = ((n, k), None)
        elif name in ("wo", "down"):
            out[name] = ((n, k // m), k)
        else:
            out[name] = ((n // m, k), None)
    return out


def tp_kernels(flush, cfg, mcfg):
    """Phase 19 (a): the kernels at the per-shard shapes of (b) and (c),
    per_row, M ∈ {4, 128}, against their plain versions bit for bit with
    phase 3's times, bounds and library calls (``check_kernels``): the
    column-parallel shapes from whole rows, the row-parallel ones on a
    K-range with the whole row's scale given; the row scale alone at the
    row-parallel K-ranges (``precompute_checks``); the batched kernels at
    a rank's 32 of olmoe's 64 experts (``expert_kernel_checks``)."""
    shapes, whole = {}, {}
    for m in TP_MESHES:
        for (nk, kw) in tp_shapes(cfg, m).values():
            if nk not in SHAPES:  # phase 3 checks the single-device ones
                shapes[nk] = None
                if kw is not None:
                    whole[nk] = kw
    shapes[tp_shapes(mcfg, TP_MOE_MESH)["lm_head"][0]] = None
    records, err = check_kernels(flush, shapes=tuple(shapes),
                                 paths=("per_row",), whole_k=whole, seed=5)
    ks = sorted({k for _, k in whole})
    pre = precompute_checks(flush, ks=ks, rows=(), row_scale_m=ROWS)
    err["row_scale"] = 0.0  # bit-equal, or precompute_checks raised
    experts, e_err = expert_kernel_checks(
        flush, mcfg.replace(num_experts=mcfg.num_experts // TP_MOE_MESH),
        seed=6, modes=("per_row",))
    err.update(e_err)
    return records + pre, experts, err


def tp_requests(vocab):
    """Phase 4's four requests (seed 2), 16 new tokens each."""
    return [dict(uid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(serve_prompts(vocab, 2))]


def tp_streams(cfg, params):
    """Phase 4's serve of ``cfg`` on one device: its streams."""
    _, reqs = serve(cfg, params, seed=2)
    return [r.output for r in reqs]


# the ranks' probes (``launch.mesh_job``: fn(ctx, *args) on every rank,
# after its serves, under the plan)

def tp_collectives_probe(ctx, rows, reps):
    """Every op of ``distributed.collectives`` on the rank's device, of
    values that say which rank sent them, and the host microseconds of an
    f32 all-reduce of [rows, 2048] (the mean over ``reps``)."""
    from repro_torch.distributed import collectives
    dev, r, out = ctx["device"], ctx["plan"].rank_along("model"), {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((5,), float(r + 1), dtype=dtype, device=dev)
        for op in ("sum", "max"):
            out[f"all_reduce_{op}_{dtype}"] = collectives.all_reduce(
                x, op).tolist()
    for dtype in (torch.float32, torch.int64):
        x = torch.full((2, 3), r + 1, dtype=dtype, device=dev)
        out[f"all_gather_{dtype}"] = collectives.all_gather(x, dim=0).tolist()
    x = torch.randn(rows, 2048, device=dev)
    collectives.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        collectives.all_reduce(x)
    torch.cuda.synchronize()
    out["all_reduce_us"] = (time.perf_counter() - t0) / reps * 1e6
    return out


def tp_collectives_ok(out, m):
    """Whether ``tp_collectives_probe``'s values are a 1 x m mesh's."""
    gathered = [[r + 1] * 3 for r in range(m) for _ in range(2)]
    return all(out[f"all_reduce_sum_{t}"] == [m * (m + 1) / 2] * 5
               and out[f"all_reduce_max_{t}"] == [float(m)] * 5
               for t in (torch.float32, torch.bfloat16)) and all(
        out[f"all_gather_{t}"] == gathered
        for t in (torch.float32, torch.int64))


def tp_step_probe(ctx, name):
    """One decode step of the rank's ``name`` engine (a one-step chunk):
    its wall and device busy time (``decode_step_profile``), and the
    collectives' calls and host seconds a step."""
    from repro_torch.distributed import collectives
    eng = ctx["engines"][name]
    n, eng.decode_chunk = eng.decode_chunk, 1
    try:
        collectives.reset_counters()
        wall_ms = decode_step_wall(eng)
        c = collectives.counters()
        prof = decode_step_profile(eng)
    finally:
        eng.decode_chunk = n
    return {"wall_ms": wall_ms, "busy_ms": prof["busy_ms"],
            "collective_calls": c["calls"], "collective_s": c["seconds"]}


def tp_moe_probe(ctx, cfg, xs):
    """Each MoE layer's ``moe_mlp_apply`` on its given input x_l."""
    from repro_torch.models import moe
    return [moe.moe_mlp_apply(lp["moe"], x.to(ctx["device"]), cfg,
                              cfg.quant, aux=False)[0].cpu()
            for lp, x in zip(ctx["params"]["layers"], xs)]


def tp_ranks(tag, res, kernels, fails):
    """Checks on every rank's result of a job: replicated leaves, logits,
    streams and MoE outputs equal to rank 0's; each serve of ``kernels``
    {serve: kernel names} launched each of them on every rank; the ranks'
    peaks summed below the card's memory. A failed check is added to
    ``fails``. Returns the per-rank record."""
    first = res[0]
    for r in res[1:]:
        if not (r["replicated_digest"] == first["replicated_digest"]
                and all(torch.equal(v, first["forwards"][k])
                        for k, v in r["forwards"].items())
                and all(v["outputs"] == first["serves"][k]["outputs"]
                        for k, v in r["serves"].items())
                and all(torch.equal(a, b) for a, b in zip(
                    r["probes"].get("moe", []),
                    first["probes"].get("moe", [])))):
            fails.append(f"{tag}: rank {r['rank']}'s replicated leaves, "
                         "logits, streams or MoE outputs differ from rank "
                         "0's")
    for name, names in kernels.items():
        for r in res:
            counts = r["serves"][name]["launches"]
            if min(counts[n] for n in names) <= 0:
                fails.append(f"{tag} {name}: rank {r['rank']} launched "
                             f"{counts}")
    ranks = [{"rank": r["rank"], "device": r["device"],
              "backend": r["backend"], "load_s": r["load_s"],
              "seconds": r["seconds"], "peak_bytes": r["peak_bytes"],
              "step": r["probes"]["step"],
              "serves": {name: {k: v[k] for k in (
                  "launches", "wall_s", "collectives")}
                  | {"decode_tok_s": v["stats"]["decode_tok_s"],
                     "host_syncs_per_token": v["stats"][
                         "host_syncs_per_token"],
                     "mesh": v["stats"]["mesh"]}
                  for name, v in r["serves"].items()}} for r in res]
    peak = sum(r["peak_bytes"] for r in res)
    if not peak < CARD_BYTES:
        fails.append(f"{tag}: the ranks' peaks sum to {peak} B")
    return {"ranks": ranks, "peak_sum_bytes": peak,
            "replicated_digest": first["replicated_digest"]}


def tp_against(tag, got, logits, want, want_logits, ctl, ctl_logits, fails):
    """The mesh's streams and logits against one device's (agreement, the
    logit gap) and against the one-device control's, which they must
    equal bit for bit (``ctl`` None: the logits alone; a failed check is
    added to ``fails``)."""
    out = stream_agreement(got, want)
    out["logits"] = logit_gap(logits, want_logits)
    out["control_equal"] = {"logits": torch.equal(logits, ctl_logits)}
    if ctl is not None:
        out["control_equal"]["streams"] = got == ctl
    if not all(out["control_equal"].values()):
        out["control_gap"] = logit_gap(logits, ctl_logits)
        out["control_streams"] = stream_agreement(got, ctl)
        fails.append(f"{tag}: the ranks' streams or logits differ from the "
                     f"one-device control's ({out['control_equal']}, logits "
                     f"max |diff| {out['control_gap']['max_abs_diff']})")
    return out


def logit_gap(got, want):
    """Max |diff| and the correlation coefficient of two [1, S, V] logit
    tensors, and the share of the S positions whose greedy token agrees."""
    a, b = got.double().flatten(), want.double().flatten()
    agree = (got.argmax(-1) == want.argmax(-1)).double().mean().item()
    return {"max_abs_diff": (a - b).abs().max().item(),
            "corrcoef": torch.corrcoef(torch.stack([a, b]))[0, 1].item(),
            "argmax_agreement": agree}


def tp_phase(flush):
    """Phase 19: the dense and MoE families served across a model-axis
    mesh, ranks spawned on the card (``launch.mesh.spawn``: ranks share
    cuda:0 over gloo, as NCCL refuses two ranks on one device; on a host
    with a card a rank they run NCCL), each running ``launch.mesh_job.run``
    on weights made here and saved to the build directory: at 1x2
    tinyllama's job then olmoe's, at 1x4 tinyllama's. (a) ``tp_kernels``;
    (b) full-width tinyllama-1.1b (``MESH_LAYERS`` of its 22 layers) at
    1x2 and 1x4: phase 4's requests
    per_row and on float tables, and teacher-forced 128-token logits,
    equal bit for bit to the one-device control's
    (``sharding.one_device_control``: the mesh's split contractions and
    head blocks in turn on one device), against one device's: float-table
    streams equal, per_row streams diverging only at near ties, the logit
    gap and greedy token agreement recorded; each collective on card
    tensors (1x2); (c) olmoe-1b-7b (4 layers) at 1x2: each MoE layer's
    output on the single-device layer's input bit-equal to it, phase 4's
    greedy streams and the logits equal to the control's, their agreement
    with one device recorded. Every serve's kernels launched on every
    rank, the ranks' outputs and replicated leaves equal, their peak
    device memory summed below the card's, one decode step's wall and busy
    time on each. Every check runs; the phase fails at its end if any
    failed."""
    from repro_torch.distributed.sharding import one_device_control, tree_to
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import mesh_job
    from repro_torch.models import api, moe
    t0 = time.perf_counter()
    fails = []
    card = torch.device("cuda", 0)
    rec = {"backends": {m: mesh_mod.choose_backend(m, card)
                        for m in sorted({*TP_MESHES, TP_MOE_MESH})},
           "cards": torch.cuda.device_count(),
           "compute_mode": subprocess.run(
               ["nvidia-smi", "--query-gpu=compute_mode",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "card": device_line()}
    print(f"tp: backends {rec['backends']} by mesh size ({rec['cards']} "
          f"card(s); rank r on cuda:(r % {rec['cards']})), compute mode "
          f"{rec['compute_mode']}, card {rec['card']}", flush=True)
    cfg = main_config().replace(n_layers=MESH_LAYERS)
    mcfg = moe_config().replace(n_layers=TP_MOE_LAYERS)
    ta = time.perf_counter()
    rec["kernels"], rec["expert_kernels"], rec["err"] = tp_kernels(
        flush, cfg, mcfg)
    rec["kernels_s"] = time.perf_counter() - ta
    print(f"tp: (a) in {rec['kernels_s']:.1f} s", flush=True)

    # (b)'s weights, requests and one device's streams and logits
    fcfg = cfg.with_quant(table_quant=None)
    params, _ = made(cfg)
    path = str(_build.BUILD_DIR / "tp_tinyllama.pt")
    torch.save(tree_to(params, "cpu"), path)
    reqs = tp_requests(cfg.vocab_size)
    prompts = [r["prompt"] for r in reqs]
    cfgs = {"per_row": cfg, "float": fcfg}
    want = {"per_row": tp_streams(cfg, params),
            "float": tp_streams(fcfg, params)}
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 128)), device="cuda")
    want_logits = {name: api.forward(params, {"tokens": toks}, c)[0].cpu()
                   for name, c in cfgs.items()}

    # (c)'s: each MoE layer's input and output on one device, the streams
    # and logits of one device and of the control
    mparams, _ = made(mcfg)
    mpath = str(_build.BUILD_DIR / "tp_olmoe.pt")
    torch.save(tree_to(mparams, "cpu"), mpath)
    layer_io = []
    apply = moe.moe_mlp_apply

    def record(p, x, *a, **kw):
        y, losses = apply(p, x, *a, **kw)
        layer_io.append((x.cpu(), y.cpu()))
        return y, losses

    mtoks = torch.as_tensor(np.random.default_rng(3).integers(
        0, mcfg.vocab_size, (1, 128)), device="cuda")
    moe.moe_mlp_apply = record
    try:
        mlogits = api.forward(mparams, {"tokens": mtoks}, mcfg)[0].cpu()
    finally:
        moe.moe_mlp_apply = apply
    mreqs = tp_requests(mcfg.vocab_size)
    mwant = tp_streams(mcfg, mparams)
    ctl = one_device_control(mparams, tp_plan(TP_MOE_MESH), mcfg)
    mctl = (tp_streams(mcfg, ctl),
            api.forward(ctl, {"tokens": mtoks}, mcfg)[0].cpu())
    del ctl, mparams
    moe_job = dict(cfg=mcfg, params=mpath,
                   forwards={"greedy": (mcfg, mtoks.cpu())},
                   serves={"greedy": (mcfg, SERVE_KW, mreqs)},
                   probes={"moe": (tp_moe_probe, (mcfg, [
                       x for x, _ in layer_io])),
                       "step": (tp_step_probe, ("greedy",))})
    assert TP_MOE_MESH in TP_MESHES  # its job runs on that mesh's ranks

    for m in TP_MESHES:
        tb = time.perf_counter()
        probes = {"step": (tp_step_probe, ("per_row",))}
        if m == 2:
            probes["collectives"] = (tp_collectives_probe, (4, 20))
        jobs = [dict(cfg=cfg, params=path, probes=probes,
                     serves={n: (c, SERVE_KW, reqs)
                             for n, c in cfgs.items()},
                     forwards={n: (c, toks.cpu())
                               for n, c in cfgs.items()})]
        if m == TP_MOE_MESH:
            jobs.append(moe_job)
        res = rank_pool(m).run(mesh_job.run, (jobs,))
        rec["spawn_s_1x%d" % m] = time.perf_counter() - tb
        for r in res:
            if r[0]["backend"] != rec["backends"][m]:
                fails.append(f"tp 1x{m}: rank {r[0]['rank']} ran "
                             f"{r[0]['backend']}")
            if m == 2 and not tp_collectives_ok(
                    r[0]["probes"]["collectives"], m):
                fails.append(f"tp: rank {r[0]['rank']}'s collectives on "
                             f"card tensors: {r[0]['probes']['collectives']}")
        if m == 2:
            rec["collectives"] = res[0][0]["probes"]["collectives"]
        leg = tp_ranks(f"tp 1x{m}", [r[0] for r in res], {
            "per_row": PER_ROW_PATH,
            "float": ("fused_lut_mpgemm", "lut_mpgemm")}, fails)
        ctl = one_device_control(params, tp_plan(m), cfg)
        for name, c in cfgs.items():
            got = res[0][0]["serves"][name]["outputs"]
            # float tables: the streams must equal one device's, which
            # says more than the control's would
            leg[name] = tp_against(
                f"tp 1x{m} {name}", got, res[0][0]["forwards"][name],
                want[name], want_logits[name],
                tp_streams(c, ctl) if name == "per_row" else None,
                api.forward(ctl, {"tokens": toks}, c)[0].cpu(), fails)
            if name == "float" and got != want[name]:
                fails.append(f"tp 1x{m} float: the streams differ from one "
                             "device's")
            if name == "per_row":
                try:
                    leg[name]["near_ties"] = near_ties(
                        f"tp 1x{m} {name}", c, params, prompts, got,
                        want[name])
                except AssertionError as e:
                    fails.append(str(e))
        del ctl
        leg["seconds"] = time.perf_counter() - tb
        print(tp_leg_line(f"1x{m}", leg), flush=True)
        rec[f"1x{m}"] = leg
        if m != TP_MOE_MESH:
            continue
        # (c) olmoe-1b-7b at 1x2, the ranks' second job
        tag = f"tp olmoe 1x{m}"
        mres = [r[1] for r in res]
        leg = tp_ranks(tag, mres, {"greedy": (
            "fused_lut_mpgemm_batched", "row_scale", "fused_lut_mpgemm")},
            fails)
        leg["moe_layers"] = []
        for j, ((_, y), got) in enumerate(zip(layer_io,
                                              mres[0]["probes"]["moe"])):
            leg["moe_layers"].append((got - y).abs().max().item())
            if not torch.equal(got, y):
                fails.append(f"{tag}: MoE layer {j}'s output differs from "
                             f"the single-device layer's (max |diff| "
                             f"{leg['moe_layers'][-1]})")
        leg["greedy"] = tp_against(
            tag, mres[0]["serves"]["greedy"]["outputs"],
            mres[0]["forwards"]["greedy"], mwant, mlogits, *mctl, fails)
        leg["seconds"] = mres[0]["seconds"]  # the ranks' job alone
        print(tp_leg_line(f"olmoe_1x{m}", leg), flush=True)
        rec[f"olmoe_1x{m}"] = leg
    for f in (path, mpath):
        os.remove(f)
    del params, want_logits
    gc_cuda()
    rec["seconds"] = time.perf_counter() - t0
    print(f"tp: phase 19 in {rec['seconds']:.1f} s", flush=True)
    if fails:
        raise AssertionError("tp: " + "; ".join(fails))
    return rec


def tp_launches(rec, name, leg=None):
    """Rank 0's launches of kernel ``name`` in phase 19's main serves:
    {leg: launches}, or one leg's count as {name: launches}."""
    serve = lambda key: "greedy" if key.startswith("olmoe") else "per_row"
    legs = {key: rec[key]["ranks"][0]["serves"][serve(key)]["launches"]
            for key in [f"1x{m}" for m in TP_MESHES]
            + [f"olmoe_1x{TP_MOE_MESH}"]}
    if leg is not None:
        return legs[leg]
    return {key: counts[name] for key, counts in legs.items()}


def tp_leg_line(key, leg):
    """One phase 19 leg's record as text (printed as the leg ends)."""
    parts = []
    for name in ("per_row", "float", "greedy"):
        if name not in leg:
            continue
        a, g = leg[name], leg[name]["logits"]
        parts.append(
            f"{name}: equal to the one-device control's "
            f"{a['control_equal']}"
            + (f" (streams {a['control_streams']})"
               if "control_streams" in a else "") + "; streams "
            f"{a['equal_tokens']}/{a['tokens']} tokens equal to one device "
            f"position by position, agreeing prefixes "
            f"{a['agreeing_prefix']}" + (
                f", divergences at near ties {a['near_ties']}"
                if "near_ties" in a else "")
            + f"; logits vs one device max |diff| {g['max_abs_diff']:.4g}, "
            f"corrcoef {g['corrcoef']:.6f}, greedy token equal at "
            f"{g['argmax_agreement']:.3f} of the positions")
    if "moe_layers" in leg:
        parts.append(f"MoE layers' outputs vs one device max |diff| "
                     f"{leg['moe_layers']}")
    for r in leg["ranks"]:
        step = r["step"]
        parts.append(
            f"rank {r['rank']} ({r['device']}, {r['backend']}): one decode "
            f"step wall {step['wall_ms']:.1f} ms, busy "
            + ("not measured" if step["busy_ms"] is None else
               f"{step['busy_ms']:.2f} ms")
            + f", {step['collective_calls']:g} collectives "
            f"{step['collective_s'] * 1e3:.1f} ms a step; " + "; ".join(
                f"{name} serve {sv['wall_s']:.2f} s, decode "
                f"{sv['decode_tok_s']:.1f} tok/s, launches "
                f"{ {k: v for k, v in sv['launches'].items() if v} }, "
                f"collectives {sv['collectives']['calls']} calls "
                f"{sv['collectives']['bytes']} B "
                f"{sv['collectives']['seconds']:.2f} s"
                for name, sv in r["serves"].items()))
    parts.append("peaks " + ", ".join(
        f"rank {r['rank']} {r['peak_bytes'] / 1e9:.2f} GB"
        for r in leg["ranks"])
        + f", sum {leg['peak_sum_bytes'] / 1e9:.2f} GB; replicated leaves, "
        f"logits and streams equal on every rank; leg {leg['seconds']:.1f} s")
    return f"tp {key}: " + "; ".join(parts)


def tp_lines(rec):
    """Phase 19's record as text: (a), the collectives' probe and the
    phase seconds (the legs' lines were printed as each leg ended)."""
    lines = [f"tp (a): per-shard kernels, per_row, bit-exact to the plain "
             f"versions (row-parallel K-ranges with the whole row's scale "
             f"given), in {rec['kernels_s']:.1f} s: " + "; ".join(
                 record_line(r) if r["kernel"] in ("lut_mpgemm",
                                                   "fused_lut_mpgemm")
                 else precompute_line(r) for r in rec["kernels"]),
             "tp (a): batched kernels at 32 experts a rank: " + "; ".join(
                 f"{r['kernel']} C={r['c']} N={r['n']} K={r['k']}: "
                 f"{r['kernel_ms']:.4f} ms (plain {r['plain_ms']:.4f}, bf16 "
                 f"bmm {r['library_ms']:.4f}, bound {r['bound_ms']:.5f} by "
                 f"{r['bound_by']})" for r in rec["expert_kernels"])]
    c = rec["collectives"]
    lines.append(
        f"tp: collectives on card tensors ({rec['backends'][2]}), rank 0 of "
        f"1x2: all_reduce sum/max f32 "
        f"{c['all_reduce_sum_torch.float32'][:1]}/"
        f"{c['all_reduce_max_torch.float32'][:1]}, bf16 "
        f"{c['all_reduce_sum_torch.bfloat16'][:1]}/"
        f"{c['all_reduce_max_torch.bfloat16'][:1]}, all_gather f32 "
        f"{c['all_gather_torch.float32']} and int64 "
        f"{c['all_gather_torch.int64']}; an f32 [4, 2048] all_reduce "
        f"{c['all_reduce_us']:.0f} us of host time")
    lines.append(f"tp: phase 19 in {rec['seconds']:.1f} s ((a) "
                 f"{rec['kernels_s']:.1f} s; the 1x2 ranks (tinyllama, "
                 f"then olmoe: its job {rec['olmoe_1x2']['seconds']:.1f} s) "
                 f"{rec['spawn_s_1x2']:.1f} s and the checks after them "
                 f"{rec['1x2']['seconds'] - rec['spawn_s_1x2']:.1f} s; the "
                 f"1x4 ranks {rec['spawn_s_1x4']:.1f} s and the checks "
                 f"{rec['1x4']['seconds'] - rec['spawn_s_1x4']:.1f} s)")
    return lines


# ---------------------------------------------------------------------------
# phase 20: the data axis: per-rank builds and data-parallel serving
# ---------------------------------------------------------------------------

# (b): tinyllama-1.1b's meshes, data x model; (c): olmoe-1b-7b's, at
# phase 15's depth (4 of its 16 layers); (e): a data rank's decode rows at
# phase 4's 4 slots over 2 data ranks
DP_MESHES = ((2, 1), (2, 2))
DP_MOE_MESH = (2, 2)
DP_M = 2
# (b)'s sampled leg: phase 4's prompts, its seed and sampling params
DP_SAMPLE = dict(temperature=0.8, top_k=50, top_p=0.95)
DP_SAMPLE_SEED = 5


def dp_plan(d, m, coords=(0, 0)):
    """A d x m plan as the rank at ``coords`` sees it (no group): shapes,
    blocks and the one-device control."""
    from repro_torch.distributed.sharding import AxisPlan, Mesh
    return AxisPlan(Mesh(("data", "model"), (d, m), coords, {}))


def tree_leaves_of(tree):
    """(path, leaf) of a param tree (``core.tree.tree_paths``), a packed
    weight as its children, the marks (``"tp"``...) as leaves too."""
    from repro_torch.core.quantize import QuantizedWeight
    from repro_torch.core.tree import tree_paths
    for path, leaf in tree_paths(tree):
        if isinstance(leaf, QuantizedWeight):
            for c in ("packed", "scale", "zero_prime", "cw"):
                if getattr(leaf, c) is not None:
                    yield f"{path}.{c}", getattr(leaf, c)
        else:
            yield path, leaf


def tree_digest(tree) -> str:
    """sha256 over every leaf of a param tree, its path, dtype, shape and
    bytes, and its marks."""
    import hashlib
    h = hashlib.sha256()
    for path, leaf in tree_leaves_of(tree):
        if torch.is_tensor(leaf):
            t = leaf.detach().contiguous().cpu()
            h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        else:
            h.update(f"{path}={leaf!r}".encode())
    return h.hexdigest()


def tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in tree_leaves_of(tree) if torch.is_tensor(leaf))


def float_leaf_bytes(cfg) -> dict:
    """Bytes of the largest float subtrees a build makes whole before it
    cuts them (in the per-rank bound): the embedding, one layer's float
    projections before they are packed, the head."""
    item = torch.empty((), dtype=cfg.param_dtype).element_size()
    d, hd = cfg.d_model, cfg.head_dim
    proj = (d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
            + 3 * d * cfg.d_ff)
    return {"embed": cfg.vocab_size * d * item, "layer": proj * item,
            "head": cfg.vocab_size * d * item}


def dp_build_probe(ctx, cfg):
    """(a) on a rank: ``launch/serve.py``'s build (``build_params``: the
    rank's blocks, each layer cut as it is made); its peak device memory
    from the params' making on (``max_memory_allocated`` over what the
    rank held before), the shard's bytes and its digest."""
    from repro_torch.launch import serve as serve_mod
    dev = ctx["device"]
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = serve_mod.build_params(cfg, dev, True, ctx["plan"])
    torch.cuda.synchronize(dev)
    out = {"seconds": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
           "resident_bytes": torch.cuda.memory_allocated(dev) - base,
           "shard_bytes": tree_bytes(params), "digest": tree_digest(params)}
    del params
    gc_cuda()
    return out


def quantize_working_bytes(cfg):
    """Device bytes packing the LM head takes beside its float weight
    (``core.quantize``: the rows in blocks, the packed parts joined), on
    this process's card alone."""
    from repro_torch.core import quantize as Q
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    w = torch.randn(cfg.d_model, cfg.vocab_size, generator=gen,
                    device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    qw = Q.quantize(w.T, cfg.quant["weight_bits"], k_group=4)
    torch.cuda.synchronize()
    out = torch.cuda.max_memory_allocated() - base
    del qw, w
    gc_cuda()
    return out


def dp_build(cfg):
    """(a): the per-rank build at 1x2 against the one-device build. Every
    rank's blocks bit-equal (digest) to ``shard_params`` of the whole
    build's tree; each rank's peak below the one-device build's peak.
    Recorded beside the peak: the per-rank bound (the shard and the
    largest float subtree made whole), and that bound with what the rank
    holds once built in place of the shard and the packing's own working
    memory (measured alone, ``quantize_working_bytes``): the packing needs
    memory beside the float weight it packs, so the bound alone
    cannot hold at the head."""
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.launch import mesh_job
    from repro_torch.launch import serve as serve_mod
    fails, rec = [], {}
    t0 = time.perf_counter()
    res = rank_pool(2).run(mesh_job.run, ([{"probes": {
        "build": (dp_build_probe, (cfg,))}}],))
    rec["spawn_s"] = time.perf_counter() - t0
    gc_cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    whole = serve_mod.build_params(cfg, torch.device("cuda"), True)
    torch.cuda.synchronize()
    rec["one_device_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    rec["one_device_bytes"] = tree_bytes(whole)
    want = [tree_digest(shard_params(whole, dp_plan(1, 2, (0, m)), cfg))
            for m in range(2)]
    del whole
    gc_cuda()
    rec["float_leaf_bytes"] = float_leaf_bytes(cfg)
    largest = max(rec["float_leaf_bytes"].values())
    rec["quantize_working_bytes"] = quantize_working_bytes(cfg)
    rec["ranks"] = []
    for r in res:
        b = r[0]["probes"]["build"]
        bound = b["shard_bytes"] + largest
        limit = b["resident_bytes"] + largest + rec["quantize_working_bytes"]
        rank = dict({k: b[k] for k in ("seconds", "peak_bytes",
                                       "resident_bytes", "shard_bytes")},
                    rank=r[0]["rank"], bound_bytes=bound, limit_bytes=limit,
                    within_bound=b["peak_bytes"] <= bound,
                    digest_equal=b["digest"] == want[r[0]["coords"][1]])
        rec["ranks"].append(rank)
        if not rank["digest_equal"]:
            fails.append(f"dp (a): rank {r[0]['rank']}'s blocks differ from "
                         "the whole build's")
        if not b["peak_bytes"] < rec["one_device_peak_bytes"]:
            fails.append(f"dp (a): rank {r[0]['rank']}'s peak "
                         f"{b['peak_bytes']} B is not below the one-device "
                         f"build's {rec['one_device_peak_bytes']} B")
    return rec, fails


def dp_requests(vocab, **kw):
    """Phase 4's four requests (seed 2), 16 new tokens each, ``kw`` on
    each."""
    return [dict(uid=i, prompt=p, max_new_tokens=16, **kw)
            for i, p in enumerate(serve_prompts(vocab, 2))]


def dp_serves(cfg, fcfg, d, m):
    """{name: (cfg, engine kwargs, requests)} of a d x m tinyllama leg:
    greedy per_row and float tables at every mesh; at 2x1 also the seeded
    sampled leg, phase 6's paged pool with prefix caching and a beam:2
    leg."""
    vocab = cfg.vocab_size
    out = {"per_row": (cfg, SERVE_KW, dp_requests(vocab)),
           "float": (fcfg, SERVE_KW, dp_requests(vocab))}
    if (d, m) == (2, 1):
        out["sample"] = (cfg, dict(SERVE_KW, seed=DP_SAMPLE_SEED),
                         dp_requests(vocab, **DP_SAMPLE))
        out["paged"] = (cfg, dict(SERVE_KW, cache_block_size=16,
                                  num_cache_blocks=96, prefix_cache=True),
                        [dict(uid=i, prompt=p, max_new_tokens=16)
                         for i, p in enumerate(paged_prompts(vocab))])
        out["beam"] = (cfg, SERVE_KW, dp_requests(vocab, decoding="beam:2"))
    return out


def engine_streams(cfg, params, engine_kw, requests):
    """A single-device engine's streams (and beams) of ``requests``; its
    stats."""
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(cfg, params, **engine_kw)
    reqs = [Request(**r) for r in requests]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    st = eng.stats()
    del eng
    return [r.output for r in reqs], [r.beams for r in reqs], st


def dp_moe_probe(ctx, cfg, xs):
    """(c) on a rank: each MoE layer on this data rank's rows of its input
    x_l (the whole batch's): its output rows and the whole batch's keep
    mask."""
    from repro_torch.distributed.sharding import local_rows
    from repro_torch.models import moe
    rows = local_rows(ctx["plan"], xs[0].shape[0])
    out = []
    for lp, x in zip(ctx["params"]["layers"], xs):
        y, aux = moe.moe_mlp_apply(lp["moe"], x[rows].to(ctx["device"]),
                                   cfg, cfg.quant, aux=False, with_keep=True)
        out.append((y.cpu(), aux["keep"].cpu()))
    return out


def dp_leg_record(tag, res, serves, kernels, fails):
    """Every rank's record of a leg: the ranks' streams and logits equal
    (rank (0, 0)'s), replicated leaves equal within each model
    coordinate, each serve's kernels launched on every rank, host syncs
    at most one a chunk, the peaks summed below the card's memory; per
    rank the launches, collectives by axis, serve wall, decode tok/s and
    a decode step's wall and busy time."""
    first = res[0]
    for r in res[1:]:
        same_model = [x for x in res if x["coords"][1] == r["coords"][1]]
        if r["replicated_digest"] != same_model[0]["replicated_digest"]:
            fails.append(f"{tag}: rank {r['rank']}'s replicated leaves "
                         "differ from its model coordinate's")
        if not (all(torch.equal(v, first["forwards"][k])
                    for k, v in r["forwards"].items())
                and all(v["outputs"] == first["serves"][k]["outputs"]
                        for k, v in r["serves"].items())):
            fails.append(f"{tag}: rank {r['rank']}'s logits or streams "
                         "differ from rank 0's")
    for name in serves:
        for r in res:
            sv = r["serves"][name]
            counts = sv["launches"]
            if min(counts[n] for n in kernels.get(name, PER_ROW_PATH)) <= 0:
                fails.append(f"{tag} {name}: rank {r['rank']} launched "
                             f"{counts}")
            if sv["stats"]["host_syncs_per_token"] > 1 / SERVE_KW[
                    "decode_chunk"]:
                fails.append(f"{tag} {name}: rank {r['rank']} host syncs a "
                             f"token {sv['stats']['host_syncs_per_token']}")
    ranks = [{"rank": r["rank"], "coords": r["coords"], "device": r["device"],
              "backend": r["backend"], "seconds": r["seconds"],
              "load_s": r["load_s"], "peak_bytes": r["peak_bytes"],
              "step": r["probes"].get("step"),
              "serves": {name: {k: v[k] for k in (
                  "launches", "wall_s", "collectives")}
                  | {"decode_tok_s": v["stats"]["decode_tok_s"],
                     "host_syncs_per_token": v["stats"][
                         "host_syncs_per_token"],
                     "prefill_tokens_reused": v["stats"][
                         "prefill_tokens_reused"],
                     "slots": v["stats"]["mesh"]["slots"]}
                  for name, v in r["serves"].items()}} for r in res]
    peak = sum(r["peak_bytes"] for r in res)
    if not peak < CARD_BYTES:
        fails.append(f"{tag}: the ranks' peaks sum to {peak} B")
    return {"ranks": ranks, "peak_sum_bytes": peak}


def dp_phase(flush):
    """Phase 20: the data axis. Ranks are spawned on the card
    (``launch.mesh.spawn``: they share cuda:0 over gloo; on a host with a
    card a rank, NCCL), each running ``launch.mesh_job.run`` on a d x m
    mesh and building its own blocks (``launch/serve.py``'s
    ``build_params``). (e) first: the per-shard kernels at the data
    ranks' decode rows (M = 2). (a) the per-rank build at 1x2
    (``dp_build``), the whole model. (b) full-width tinyllama-1.1b
    (``MESH_LAYERS`` of its 22 layers) at 2x1 and 2x2: phase 4's
    requests with per_row and float tables (at 2x1 also a seeded
    sampled leg, phase 6's paged pool with prefix caching and a beam:2
    leg) and teacher-forced 128-token logits of 2 rows, equal bit for bit
    to the one-device control (``sharding.one_device_control``: the data
    ranks' row blocks in turn, within each the model ranks' blocks);
    against one device: float-table streams equal, per_row parting only
    at near ties, the logit gap and greedy agreement recorded; the paged
    serve reusing exactly one device's prompt tokens. (c) olmoe-1b-7b (4
    of 16 layers) at 2x2, the 2x2 ranks' second job: greedy streams and
    logits equal to the control's, each MoE layer's keep mask on the data
    ranks' rows equal to one device's on the whole batch. (d) per serve
    and rank: launches, host syncs a token, collectives by axis, a decode
    step's wall and busy time, the aggregate decode tok/s beside one
    device's. Every check runs; the phase fails at its end if any
    failed."""
    from repro_torch.distributed.sharding import one_device_control
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import mesh_job
    from repro_torch.models import api, moe
    t0 = time.perf_counter()
    fails = []
    card = torch.device("cuda", 0)
    rec = {"backends": {f"{d}x{m}": mesh_mod.choose_backend(d * m, card)
                        for d, m in DP_MESHES},
           "card": device_line()}
    print(f"dp: backends {rec['backends']} ({torch.cuda.device_count()} "
          f"card(s)), card {rec['card']}", flush=True)
    cfg = main_config()
    mcfg = moe_config().replace(n_layers=KV_MOE_LAYERS)

    # (e) the per-shard kernels at M = 2
    ta = time.perf_counter()
    records, rec["err"] = check_kernels(flush, paths=("per_row",),
                                        rows=(DP_M,), seed=7)
    pre = precompute_checks(flush, rows=(), row_scale_m=(DP_M,))
    rec["err"]["row_scale"] = 0.0  # bit-equal, or precompute_checks raised
    rec["kernels"] = [r for r in records if r["kernel"] == "fused_lut_mpgemm"
                      ] + pre
    rec["kernels_s"] = time.perf_counter() - ta
    print(dp_kernels_line(rec), flush=True)

    # (a) the per-rank build
    ta = time.perf_counter()
    rec["build"], f = dp_build(cfg)
    fails += f
    rec["build"]["seconds"] = time.perf_counter() - ta
    print(dp_build_line(rec["build"]), flush=True)

    # one device: its weights, streams, logits and decode tok/s, at (b)'s
    # depth
    cfg = cfg.replace(n_layers=MESH_LAYERS)
    fcfg = cfg.with_quant(table_quant=None)
    params, _ = made(cfg)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 128)), device="cuda")
    logit_cfgs = {"per_row": cfg, "float": fcfg}
    want_logits = {n: api.forward(params, {"tokens": toks}, c)[0].cpu()
                   for n, c in logit_cfgs.items()}
    want, one_tok_s = {}, {}
    for name, (c, kw, reqs) in dp_serves(cfg, fcfg, 2, 1).items():
        out, beams, st = engine_streams(c, params, kw, reqs)
        want[name] = (out, beams)
        one_tok_s[name] = st["decode_tok_s"]
        if name == "paged":
            rec["one_device_reused"] = st["prefill_tokens_reused"]
    rec["one_device_decode_tok_s"] = one_tok_s

    # (c)'s one-device layer inputs, keep masks and outputs, streams and
    # logits, and its control's
    mparams, _ = made(mcfg)
    mtoks = torch.as_tensor(np.random.default_rng(3).integers(
        0, mcfg.vocab_size, (2, 64)), device="cuda")
    layer_io = []
    apply = moe.moe_mlp_apply

    def record(p, x, *a, **kw):
        y, losses = apply(p, x, *a, with_keep=True, **kw)
        layer_io.append((x.cpu(), y.cpu(), losses.pop("keep").cpu()))
        return y, losses

    moe.moe_mlp_apply = record
    try:
        mlogits = api.forward(mparams, {"tokens": mtoks}, mcfg)[0].cpu()
    finally:
        moe.moe_mlp_apply = apply
    mreqs = dp_requests(mcfg.vocab_size)
    mwant = engine_streams(mcfg, mparams, SERVE_KW, mreqs)[0]
    ctl = one_device_control(mparams, dp_plan(*DP_MOE_MESH), mcfg)
    mctl = (engine_streams(mcfg, ctl, SERVE_KW, mreqs)[0],
            api.forward(ctl, {"tokens": mtoks}, mcfg)[0].cpu())
    del ctl, mparams
    gc_cuda()
    moe_job = dict(cfg=mcfg, build=True,
                   forwards={"greedy": (mcfg, mtoks.cpu())},
                   serves={"greedy": (mcfg, SERVE_KW, mreqs)},
                   probes={"moe": (dp_moe_probe, (mcfg, [
                       x for x, _, _ in layer_io])),
                       "step": (tp_step_probe, ("greedy",))})

    for d, m in DP_MESHES:
        tag, tb = f"dp {d}x{m}", time.perf_counter()
        serves = dp_serves(cfg, fcfg, d, m)
        jobs = [dict(cfg=cfg, build=True, serves=serves,
                     forwards={n: (c, toks.cpu())
                               for n, c in logit_cfgs.items()},
                     probes={"step": (tp_step_probe, ("per_row",))})]
        if (d, m) == DP_MOE_MESH:
            jobs.append(moe_job)
        res = rank_pool(d * m).run(mesh_job.run, (jobs, d))
        spawn_s = time.perf_counter() - tb
        leg = dp_leg_record(tag, [r[0] for r in res], serves, {
            "float": ("fused_lut_mpgemm", "lut_mpgemm")}, fails)
        leg["spawn_s"] = spawn_s
        ctl = one_device_control(params, dp_plan(d, m), cfg)
        got0 = res[0][0]
        for name, (c, kw, reqs) in serves.items():
            got = got0["serves"][name]["outputs"]
            ctl_out, ctl_beams, ctl_st = engine_streams(c, ctl, kw, reqs)
            ctl_logits = None
            if name in logit_cfgs:
                ctl_logits = api.forward(ctl, {"tokens": toks},
                                         c)[0].cpu()
            leg[name] = dp_against(
                f"{tag} {name}", got, got0["forwards"].get(name),
                want[name][0], want_logits.get(name), ctl_out, ctl_logits,
                fails)
            if name == "float" and got != want[name][0]:
                fails.append(f"{tag} float: the streams differ from one "
                             "device's")
            if name == "per_row":
                try:
                    leg[name]["near_ties"] = near_ties(
                        f"{tag} {name}", c, params,
                        [r["prompt"] for r in reqs], got, want[name][0])
                except AssertionError as e:
                    fails.append(str(e))
            if name == "beam":
                gb = got0["serves"][name]["beams"]
                leg[name]["beams_equal_control"] = [
                    [t for t, _ in a] for a in gb] == [
                    [t for t, _ in b] for b in ctl_beams]
                if not leg[name]["beams_equal_control"]:
                    fails.append(f"{tag} beam: the hypotheses differ from "
                                 "the control's")
            if name == "paged":
                reused = got0["serves"][name]["stats"][
                    "prefill_tokens_reused"]
                leg[name]["prefill_tokens_reused"] = reused
                if not reused == rec["one_device_reused"] == \
                        ctl_st["prefill_tokens_reused"] == 5 * 144 + 159:
                    fails.append(f"{tag} paged: {reused} prompt tokens "
                                 f"reused; one device "
                                 f"{rec['one_device_reused']}, the control "
                                 f"{ctl_st['prefill_tokens_reused']}, the "
                                 f"rule {5 * 144 + 159}")
        del ctl
        gc_cuda()
        leg["seconds"] = time.perf_counter() - tb
        print(dp_leg_line(tag, leg, rec["one_device_decode_tok_s"]),
              flush=True)
        rec[f"{d}x{m}"] = leg
        if (d, m) != DP_MOE_MESH:
            continue
        # (c) olmoe-1b-7b at 2x2, the ranks' second job
        tag = f"dp olmoe {d}x{m}"
        mres = [r[1] for r in res]
        leg = dp_leg_record(tag, mres, moe_job["serves"], {"greedy": (
            "fused_lut_mpgemm_batched", "row_scale", "fused_lut_mpgemm")},
            fails)
        leg["moe_layers"] = []
        for j, (x, y, keep) in enumerate(layer_io):
            out = {"keep_equal": True, "max_abs_diff": 0.0}
            for r in mres:
                gy, gkeep = r["probes"]["moe"][j]
                rows = slice(r["coords"][0], r["coords"][0] + 1)
                out["keep_equal"] &= torch.equal(gkeep, keep)
                out["max_abs_diff"] = max(out["max_abs_diff"], (
                    gy - y[rows]).abs().max().item())
            out["dropped"] = int((~keep).sum())
            leg["moe_layers"].append(out)
            if not out["keep_equal"]:
                fails.append(f"{tag}: MoE layer {j}'s keep mask differs "
                             "from one device's on the whole batch")
        leg["greedy"] = dp_against(
            tag, mres[0]["serves"]["greedy"]["outputs"],
            mres[0]["forwards"]["greedy"], mwant, mlogits, *mctl, fails)
        leg["seconds"] = mres[0]["seconds"]  # the ranks' job alone
        print(dp_leg_line(tag, leg, None), flush=True)
        rec[f"olmoe_{d}x{m}"] = leg
    del params, want_logits
    gc_cuda()
    rec["seconds"] = time.perf_counter() - t0
    print(f"dp: phase 20 in {rec['seconds']:.1f} s ((e) "
          f"{rec['kernels_s']:.1f} s, (a) {rec['build']['seconds']:.1f} s, "
          + ", ".join(f"{d}x{m} {rec[f'{d}x{m}']['seconds']:.1f} s"
                      for d, m in DP_MESHES) + ")", flush=True)
    if fails:
        raise AssertionError("dp: " + "; ".join(fails))
    return rec


def dp_against(tag, got, logits, want, want_logits, ctl, ctl_logits, fails):
    """The mesh's streams (and logits, where the leg has them) against the
    one-device control's, which they must equal bit for bit, and one
    device's (agreement, the logit gap: recorded)."""
    out = stream_agreement(got, want)
    out["control_equal"] = {"streams": got == ctl}
    if logits is not None:
        out["logits"] = logit_gap(logits, want_logits)
        out["control_equal"]["logits"] = torch.equal(logits, ctl_logits)
    if not all(out["control_equal"].values()):
        out["control_streams"] = stream_agreement(got, ctl)
        if logits is not None:
            out["control_gap"] = logit_gap(logits, ctl_logits)
        fails.append(f"{tag}: the ranks' streams or logits differ from the "
                     f"one-device control's ({out['control_equal']})")
    return out


def dp_kernels_line(rec):
    return ("dp (e): the per-shard kernels at a data rank's decode rows (M = "
            f"{DP_M}), per_row, bit-exact to the plain versions, in "
            f"{rec['kernels_s']:.1f} s: " + "; ".join(
                record_line(r) if r["kernel"] == "fused_lut_mpgemm"
                else precompute_line(r) for r in rec["kernels"]))


def dp_build_line(b):
    gb = lambda x: f"{x / 1e9:.3f} GB"
    return ("dp (a): per-rank build at 1x2 (launch/serve.py build_params), "
            f"{b['seconds']:.1f} s: " + "; ".join(
                f"rank {r['rank']} peak {gb(r['peak_bytes'])} from the "
                f"params' making on, shard {gb(r['shard_bytes'])} (held "
                f"once built {gb(r['resident_bytes'])}), the per-rank bound "
                f"{gb(r['bound_bytes'])} ("
                + ("within" if r["within_bound"] else "above") + "; with "
                f"the packing's working memory {gb(r['limit_bytes'])}), "
                "blocks "
                + ("bit-equal" if r["digest_equal"] else "UNEQUAL")
                + " to the whole build's" for r in b["ranks"])
            + f"; the one-device build's peak "
            f"{gb(b['one_device_peak_bytes'])} (tree "
            f"{gb(b['one_device_bytes'])}); float subtrees "
            + ", ".join(f"{k} {gb(v)}" for k, v in
                        b["float_leaf_bytes"].items())
            + f"; packing the head takes {gb(b['quantize_working_bytes'])} "
            "beside its float weight")


def dp_leg_line(tag, leg, one_tok_s):
    """One phase 20 leg's record as text."""
    parts = []
    for name in ("per_row", "float", "sample", "paged", "beam", "greedy"):
        if name not in leg:
            continue
        a = leg[name]
        g = a.get("logits")
        parts.append(
            f"{name}: equal to the one-device control's {a['control_equal']}"
            f"; streams {a['equal_tokens']}/{a['tokens']} tokens equal to "
            f"one device, agreeing prefixes {a['agreeing_prefix']}"
            + (f", divergences at near ties {a['near_ties']}"
               if a.get("near_ties") else "")
            + (f", {a['prefill_tokens_reused']} prompt tokens reused"
               if "prefill_tokens_reused" in a else "")
            + ("" if g is None else
               f"; 128-token logits vs one device max |diff| "
               f"{g['max_abs_diff']:.4g}, corrcoef {g['corrcoef']:.6f}, "
               f"greedy token equal at {g['argmax_agreement']:.3f}"))
    if "moe_layers" in leg:
        parts.append("MoE layers on the data ranks' rows: keep masks equal "
                     "to one device's on the whole batch "
                     f"{[x['keep_equal'] for x in leg['moe_layers']]}, "
                     f"dropped {[x['dropped'] for x in leg['moe_layers']]}, "
                     "outputs vs one device max |diff| "
                     f"{[x['max_abs_diff'] for x in leg['moe_layers']]}")
    for r in leg["ranks"]:
        step = r["step"]
        parts.append(
            f"rank {r['rank']} {r['coords']} ({r['backend']}): one decode "
            f"step wall {step['wall_ms']:.1f} ms, busy "
            + ("not measured" if step["busy_ms"] is None else
               f"{step['busy_ms']:.2f} ms")
            + f", {step['collective_calls']:g} collectives "
            f"{step['collective_s'] * 1e3:.1f} ms a step; " + "; ".join(
                f"{name} {sv['wall_s']:.2f} s, decode "
                f"{sv['decode_tok_s']:.1f} tok/s (all slots), host syncs a "
                f"token {sv['host_syncs_per_token']:.4f}, launches "
                f"{ {k: v for k, v in sv['launches'].items() if v} }, "
                f"collectives " + ", ".join(
                    f"{ax} {c['calls']} calls {c['bytes']} B "
                    f"{c['seconds']:.2f} s"
                    for ax, c in sv["collectives"]["by_axis"].items())
                for name, sv in r["serves"].items()))
    if one_tok_s is not None:
        parts.append(f"one device in this phase: decode tok/s {one_tok_s}")
    parts.append("peaks " + ", ".join(
        f"rank {r['rank']} {r['peak_bytes'] / 1e9:.2f} GB"
        for r in leg["ranks"]) + f"; leg {leg['seconds']:.1f} s")
    return f"{tag}: " + "; ".join(parts)


def dp_summary(rec, name):
    """Kernel ``name`` in phase 20: rank (0, 0)'s launches in each leg's
    main serve, and where (e) timed it, its records at M = 2 summed."""
    out = {"launches": dp_launches(rec, name)}
    rs = [r for r in rec["kernels"] if r["kernel"] == name]
    if rs:
        out.update(max_abs_err=rec["err"][name], **{
            o: float(sum(r[key] for r in rs)) for o, key in (
                ("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                ("bound_ms", "bound_ms"), ("library_ms", "library_ms"))},
            bound_by=max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in rs if r["bound_by"] == by)),
            shapes=[[r["m"], r.get("n"), r["k"]] for r in rs])
    return out


def dp_launches(rec, name):
    """Rank (0, 0)'s launches of kernel ``name`` in phase 20's main serves:
    {leg: launches} (tinyllama's per_row serve, olmoe's greedy)."""
    out = {f"{d}x{m}": rec[f"{d}x{m}"]["ranks"][0]["serves"]["per_row"][
        "launches"][name] for d, m in DP_MESHES}
    d, m = DP_MOE_MESH
    out[f"olmoe_{d}x{m}"] = rec[f"olmoe_{d}x{m}"]["ranks"][0]["serves"][
        "greedy"]["launches"][name]
    return out


# phase 21: training under a (data, model) mesh, ranks sharing the card
TM_STEPS = 4               # AdamW steps of (a)-(c) and (e)
TM_STEPS_D = 2             # (d)'s steps: int8 and Adafactor legs
# depth: 2 of 22 layers (phases 19 and 20 run MESH_LAYERS = 4): ranks on
# one card move a step's gradients over gloo (at 4 layers a 2x1 step took
# 1.76 s for its 1.23 GB, and the phase 240 s of the script's budget:
# PERF.md §6, training under a mesh)
TM_LAYERS = 2
TM_BATCH, TM_SEQ = 8, 128
TM_CKPT = 3                # (e): the 2x2 FSDP run's checkpoint
TM_LR = 3e-4               # launch/train.py's schedule: 20 warmup steps
TM_HELD = 0.55             # a 2x1 FSDP rank's held state / one device's
# the legs of each spawn: (optimizer, compression, fsdp); a no-FSDP leg
# runs before its FSDP twin, which must equal it bit for bit
TM_LEGS = {1: (("adamw", None, False), ("adamw", None, True),
               ("adamw", "int8", False), ("adamw", "int8", True),
               ("adafactor", None, False), ("adafactor", None, True)),
           2: (("adamw", None, False), ("adamw", None, True))}


def train_mesh_config():
    """Phase 21's model: full-width tinyllama-1.1b at ``TM_LAYERS`` of its
    22 layers, W2 symmetric QAT, f32 activations."""
    return train_config().replace(n_layers=TM_LAYERS)


def tm_key(model, opt, comp, fsdp):
    return (f"2x{model} {opt}" + (f" {comp}" if comp else "")
            + (" fsdp" if fsdp else ""))


def tm_optimizer(name):
    """``name`` at ``launch/train.py``'s schedule (``lr_schedule(3e-4,
    warmup=20)``): at a constant 3e-4 from step 1 AdamW moves every
    weight by ~lr whatever its gradient, so a near-zero gradient summed
    in another order (a mesh's) flips its step, and the 2x1 loss had
    parted from one device's by 3.5e-3 at step 5 (PERF.md §6, training
    under a mesh)."""
    from repro_torch.training import optimizer as opt_mod
    return opt_mod.make_optimizer(name, lr=opt_mod.lr_schedule(
        TM_LR, warmup=20, total=TM_STEPS))


def tm_steps(comp, opt_name):
    """A leg's steps: (d)'s int8 and Adafactor legs take fewer."""
    return TM_STEPS if comp is None and opt_name == "adamw" else TM_STEPS_D


def tm_batches(cfg):
    from repro_torch.training.data import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, TM_BATCH, TM_SEQ, seed=0)
    return [data.batch_at(s) for s in range(TM_STEPS)]


def tm_bytes(tree):
    from repro_torch.core.tree import tree_leaves
    out = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, dict):
            out += sum(t.numel() * t.element_size() for t in leaf.values())
        elif torch.is_tensor(leaf):
            out += leaf.numel() * leaf.element_size()
    return out


def tm_checksum(t) -> int:
    """A 64-bit checksum of a tensor's bits on its device: the sum of its
    words (as int64) times odd weights, mod 2^64. Two tensors whose bits
    differ in one word never share it."""
    v = t.detach().contiguous().reshape(-1)
    if v.numel() == 0:
        return 0
    v = v.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                1: torch.int8}[v.element_size()]).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) * 2 + 1
    return int((v * w * 0x9E3779B1).sum())


def tm_state_leaves(state, specs):
    """(name, leaf, spec) of every tensor of a train state: params, each
    optimizer leaf (its param's spec where it mirrors it, else
    replicated), ef, step."""
    from repro_torch.core.tree import tree_map_with_path, tree_paths
    out = [(f"params{p}", t, s) for (p, t), s in zip(
        tree_paths(state["params"]), specs)]
    for k, sub in state["opt"].items():
        if k == "step":
            out.append(("opt.step", sub, ()))
            continue
        objs = []  # the state of each param leaf (a tensor, or a dict)
        tree_map_with_path(lambda p, _, x: objs.append((p, x)),
                           state["params"], sub)
        for (p, leaf), s in zip(objs, specs):
            if isinstance(leaf, dict):
                out += [(f"opt.{k}{p}.{c}", t, ()) for c, t in leaf.items()]
            else:
                out.append((f"opt.{k}{p}", leaf,
                            s if leaf.dim() == len(s) else ()))
    if "ef" in state:
        out += [(f"ef{p}", t, s) for (p, t), s in zip(
            tree_paths(state["ef"]), specs)]
    out.append(("step", state["step"], ()))
    return out


def tm_grad_check(step, state, batch, cfg, plan, specs, device, rank):
    """Step 0's gradients of the mesh (this rank's blocks gathered whole)
    against one device's, on rank 0: each leaf's max |diff| over its own
    max |g|, the largest and its leaf; the mesh's and one device's
    loss."""
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.distributed import sharding as SH
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    g, met = step.grads(state, batch)
    whole = [SH.whole_of(t, s, plan) for t, s in zip(tree_leaves(g), specs)]
    del g
    if rank != 0:
        return None
    opt = tm_optimizer("adamw")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    one = init_train_state(gen, cfg, opt, device)
    g1, met1 = make_train_step(cfg, opt).grads(one, batch)
    worst, where = 0.0, None
    for (path, a), b in zip(tree_paths(g1), whole):
        r = ((a - b).abs().max() / a.abs().max().clamp_min(1e-30)).item()
        if r > worst:
            worst, where = r, path
    return {"max_rel_to_leaf_max": worst, "leaf": where,
            "loss": float(met["loss"]), "one_device_loss": float(
                met1["loss"])}


def tm_ef_want(step, state, batch, plan, specs):
    """This rank's blocks of the int8 compression of the whole step-0
    gradient (its blocks gathered whole, compressed from a zero ef)."""
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.distributed import compression
    from repro_torch.distributed import sharding as SH
    g, _ = step.grads(state, batch)
    whole = [SH.whole_of(t, s, plan) for t, s in zip(tree_leaves(g), specs)]
    _, ef = compression.compress_decompress_tree(tree_unflatten(g, whole))
    return [SH.block_of(e, s, plan) for e, s in zip(tree_leaves(ef), specs)]


def tm_serve(cfg, params, device):
    """(f): the mesh-trained params packed (W2 per_row) and run
    teacher-forced through lut_pallas and lut_xla: 128 tokens of one row
    (the staged path) and one token of 4 rows (the fused path); the
    pallas logits must equal lut_xla's bit for bit; the per_row path's
    launches, counted from 0 over the two lut_pallas forwards."""
    from repro_torch.launch import mesh_job
    from repro_torch.models import api, quantized
    scfg = main_config().replace(n_layers=TM_LAYERS)
    t0 = time.perf_counter()
    packed = quantized.quantize_params(params, scfg.quant)
    torch.cuda.synchronize(device)
    out = {"quantize_s": time.perf_counter() - t0}
    rng = np.random.default_rng(3)
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                            device=device) for shape in ((1, 128), (4, 1))]
    pallas = scfg.with_quant(mpgemm_mode="lut_pallas", table_quant="per_row")
    xla = scfg.with_quant(mpgemm_mode="lut_xla", table_quant="per_row")
    with torch.no_grad():
        torch.cuda.synchronize(device)
        mesh_job.reset_kernel_counts()
        got = [api.forward(packed, {"tokens": t}, pallas)[0] for t in toks]
        torch.cuda.synchronize(device)
        out["launches"] = mesh_job.kernel_counts()
        want = [api.forward(packed, {"tokens": t}, xla)[0] for t in toks]
    out["bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
    out["max_abs_diff"] = max((a - b).abs().max().item()
                              for a, b in zip(got, want))
    out["finite"] = all(bool(torch.isfinite(a).all()) for a in got)
    return out


def tm_rank(rank, device, model, legs, ckpt_dir):
    """One rank of phase 21's 2 x ``model`` spawn: each leg of ``legs`` in
    turn (``train_mesh_phase``); returns its records."""
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step,
                                                 param_specs)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_enter = time.time()
    cfg = train_mesh_config()
    mesh = mesh_mod.make_serving_mesh(data=2, model=model, device=device)
    batches = tm_batches(cfg)
    out = {"rank": rank, "coords": mesh.coords, "backend": mesh.backend,
           "legs": {}, "t_enter": t_enter, "mesh_s": time.time() - t_enter}
    kept = {}
    for opt_name, comp, fsdp in legs:
        key = tm_key(model, opt_name, comp, fsdp)
        rec = out["legs"][key] = {}
        t_leg = time.perf_counter()
        plan = mesh_mod.make_plan(mesh, fsdp=fsdp)
        gc_cuda()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        opt = tm_optimizer(opt_name)
        step = make_train_step(cfg, opt, plan=plan, grad_compression=comp)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        t0 = time.perf_counter()
        state = init_train_state(gen, cfg, opt, device,
                                 grad_compression=comp, plan=plan)
        torch.cuda.synchronize(device)
        rec["init_s"] = time.perf_counter() - t0
        specs = param_specs(state["params"], plan, cfg)
        rec["held_bytes"] = (tm_bytes(state["params"])
                             + tm_bytes(state["opt"]))
        if fsdp and opt_name == "adamw" and comp is None:
            rec["grads"] = tm_grad_check(step, state, batches[0], cfg, plan,
                                         specs, device, rank)
        ef_want = (tm_ef_want(step, state, batches[0], plan, specs)
                   if fsdp and comp == "int8" else None)
        rm = None
        if fsdp and model == 2:  # (e): the 2x2 FSDP run checkpoints
            if rank == 0:
                shutil_rm(ckpt_dir)
            torch.distributed.barrier()
            rm = ckpt_mod.RestartManager(ckpt_dir, every=TM_CKPT, keep=1,
                                         plan=plan, cfg=cfg)
        losses, gnorms, ms, colls = [], [], [], []
        for s in range(tm_steps(comp, opt_name)):
            collectives.reset_counters()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, met = step(state, batches[s])
            losses.append(float(met["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            gnorms.append(float(met["grad_norm"]))
            colls.append(collectives.counters())
            if ef_want is not None:
                rec["ef_bit_equal"] = all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(state["ef"]), ef_want))
                ef_want = None
            if rm is not None:
                rm.maybe_save(s + 1, state)
                if s + 1 == TM_CKPT:
                    rec["ckpt_sums"] = [tm_checksum(t) for _, t, _ in
                                        tm_state_leaves(state, specs)]
        rec.update(losses=losses, grad_norms=gnorms, step_ms=ms,
                   collectives=colls,
                   peak_bytes=torch.cuda.max_memory_allocated(device))
        rec["replicated_sums"] = [
            tm_checksum(t) for _, t, s in tm_state_leaves(state, specs)
            if plan.resolve("batch") not in s]
        if not fsdp:
            kept[(opt_name, comp)] = state
        else:
            ref = kept.pop((opt_name, comp), None)
            if ref is not None:  # its data blocks of the no-FSDP state
                diff = [name for (name, a, s), (_, b, _) in zip(
                    tm_state_leaves(state, specs),
                    tm_state_leaves(ref, specs))
                    if not torch.equal(a, SH.block_of(b, tuple(
                        x if x == "data" else None for x in s), plan))]
                rec["equal_to_no_fsdp"] = not diff
                rec["first_difference"] = diff[:3]
            del ref
        if rm is not None:
            t0 = time.perf_counter()
            rm.wait()
            gen = torch.Generator(device=device)
            gen.manual_seed(1)
            st, start = rm.restore_or_none(
                init_train_state(gen, cfg, opt, device, plan=plan))
            r_losses, r_gnorms = [], []
            for s in range(start, TM_STEPS):
                st, met = step(st, batches[s])
                r_losses.append(float(met["loss"]))
                r_gnorms.append(float(met["grad_norm"]))
            rec["restart"] = {
                "start": start, "losses": r_losses, "grad_norms": r_gnorms,
                "params_equal": all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(st["params"]),
                    tree_leaves(state["params"])))}
            del st
            rec["restart_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            whole = [SH.whole_of(t, s, plan) for t, s in zip(
                tree_leaves(state["params"]), specs)]
            if rank == 0:
                rec["serve"] = tm_serve(cfg, tree_unflatten(
                    state["params"], whole), device)
            del whole
            torch.distributed.barrier()
            rec["serve_s"] = time.perf_counter() - t0
        del state
        rec["leg_s"] = time.perf_counter() - t_leg
    out["t_exit"] = time.time()
    return out


def shutil_rm(path):
    import shutil
    shutil.rmtree(path, ignore_errors=True)


def train_mesh_phase():
    """Phase 21: training under a (data, model) mesh. Full-width
    tinyllama-1.1b (``TM_LAYERS`` of 22 layers), W2 symmetric QAT, f32
    activations, float params from seed 0 made on the card,
    ``SyntheticLM(seed=0)`` batches of 8 x 128, 4 steps (2 in (d)) at
    ``launch/train.py``'s schedule (``tm_optimizer``), under
    ``torch.use_deterministic_algorithms(True)``. (a) one device
    (``make_train_step``): AdamW, AdamW with int8 compression, Adafactor.
    Ranks on the card (``rank_pool``, ``launch.mesh.spawn``'s ranks kept
    up from phases 19 and 20; they share the card over gloo, or each has
    a card of its own over NCCL), every leg of a world size in one run
    on its ranks: (b) 2x1 (data) AdamW with
    and without FSDP; (c) 2x2, the model split by KV heads, with and
    without FSDP; (d) at 2x1 int8 compression and Adafactor, with and
    without FSDP; (e) the 2x2 FSDP run checkpoints at step 3
    (``RestartManager(plan=)``: the whole state, rank 0 writing): a fresh
    state restored on the same mesh reruns step 4, and the checkpoint
    restored on one device here holds every rank's step-3 blocks; (f) the
    2x2 run's gathered params packed (W2 per_row) and run teacher-forced
    through lut_pallas and lut_xla on its rank 0 (``tm_serve``).

    Checks (each fails the phase at its end): an FSDP run's state equals
    its no-FSDP twin's bit for bit (every param, m, v, ef and Adafactor
    leaf: each rank's blocks against the same data blocks of the twin);
    each leaf a rank holds whole equal on every data rank of its model
    coordinate (a 64-bit checksum, ``tm_checksum``); against one device:
    step 0's loss within 1e-5 relative, step 0's gathered gradients (the
    AdamW FSDP legs) within 1e-4 of each leaf's max |g|, the 4 losses
    within 1e-3 relative (largest gaps recorded); int8: each rank's ef
    after step 1 equal to its blocks of the compression of the whole
    step-0 gradient; restart: bit-equal losses, grad norms and final
    params, the one-device restore equal to the ranks' step-3 blocks
    (64-bit checksums);
    (f): lut_pallas = lut_xla bit for bit, every per_row kernel launched;
    memory: each rank's held state (params + optimizer state) at 2x1 FSDP
    at most 0.55 of one device's. Recorded: ms a step (median of steps
    2-4, host clock, the loss read), tokens a second, collective calls and
    bytes by axis in a step, each rank's peak device memory beside one
    device's."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step,
                                                 param_specs)
    t_phase = time.perf_counter()
    fails = []
    card = torch.device("cuda", 0)
    cfg = train_mesh_config()
    rec = {"arch": cfg.arch_id, "layers": cfg.n_layers, "batch": TM_BATCH,
           "seq": TM_SEQ, "steps": TM_STEPS, "lr": TM_LR,
           "card": device_line(),
           "backends": {f"2x{m}": mesh_mod.choose_backend(2 * m, card)
                        for m in TM_LEGS}}
    print(f"train_mesh: backends {rec['backends']} "
          f"({torch.cuda.device_count()} card(s)), card {rec['card']}",
          flush=True)
    batches = tm_batches(cfg)
    ckpt_dir = str(_build.BUILD_DIR / "train_mesh_ckpt")

    # (a) one device
    rec["one_device"] = {}
    torch.use_deterministic_algorithms(True)
    try:
        for opt_name, comp in (("adamw", None), ("adamw", "int8"),
                               ("adafactor", None)):
            gc_cuda()
            torch.cuda.reset_peak_memory_stats()
            opt = tm_optimizer(opt_name)
            step = make_train_step(cfg, opt, grad_compression=comp)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            state = init_train_state(gen, cfg, opt, "cuda",
                                     grad_compression=comp)
            one = {"held_bytes": tm_bytes(state["params"])
                   + tm_bytes(state["opt"]),
                   "params": sum(t.numel() for t in
                                 tree_leaves(state["params"]))}
            losses, gnorms, ms = [], [], []
            for s in range(TM_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, batches[s])
                losses.append(float(met["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                gnorms.append(float(met["grad_norm"]))
            one.update(losses=losses, grad_norms=gnorms, step_ms=ms,
                       peak_bytes=torch.cuda.max_memory_allocated())
            rec["one_device"][opt_name + (f" {comp}" if comp else "")] = one
            del state
    finally:
        torch.use_deterministic_algorithms(False)
    gc_cuda()
    for line in tm_one_device_lines(rec):
        print(line, flush=True)

    # (b)-(f) the ranks' runs
    for model, legs in TM_LEGS.items():
        started = 2 * model not in _POOLS
        t0 = time.time()
        res = rank_pool(2 * model).run(tm_rank, (model, legs, ckpt_dir))
        rec[f"2x{model}"] = {
            "run_s": time.time() - t0, "ranks": res,
            "pool_started": started,
            "legs_s": (max(r["t_exit"] for r in res)
                       - min(r["t_enter"] for r in res))}
        for opt_name, comp, fsdp in legs:  # rank 0's gaps to one device
            leg = res[0]["legs"][tm_key(model, opt_name, comp, fsdp)]
            one = rec["one_device"][opt_name + (f" {comp}" if comp else "")]
            leg["loss_gaps"] = [abs(a - b) / abs(b) for a, b in zip(
                leg["losses"], one["losses"])]
        for line in tm_world_lines(rec, model):
            print(line, flush=True)
        gc_cuda()

    # (e) the checkpoint restored on one device: every rank's step-3 blocks
    ranks = rec["2x2"]["ranks"]
    try:
        opt = tm_optimizer("adamw")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        t0 = time.perf_counter()
        restored, start = ckpt_mod.RestartManager(ckpt_dir).restore_or_none(
            init_train_state(gen, cfg, opt, "cuda"))
        rec["one_device_restore_s"] = time.perf_counter() - t0
        rec["one_device_restore_step"] = start
        ok = start == TM_CKPT and int(restored["step"]) == TM_CKPT
        for r in ranks:
            plan = SH.AxisPlan(SH.Mesh(("data", "model"), (2, 2),
                                       r["coords"], {}), fsdp="data")
            blocks = SH.shard_train_state(restored, plan, cfg)
            specs = param_specs(blocks["params"], plan, cfg)
            sums = [tm_checksum(t) for _, t, _ in
                    tm_state_leaves(blocks, specs)]
            ok &= sums == r["legs"][tm_key(2, "adamw", None, True)][
                "ckpt_sums"]
            del blocks
        rec["one_device_restore_equal"] = ok
        del restored
    finally:
        shutil_rm(ckpt_dir)
    gc_cuda()
    if not rec["one_device_restore_equal"]:
        fails.append("train_mesh (e): the one-device restore differs from "
                     "the ranks' step-3 blocks")

    # the checks
    for model, legs in TM_LEGS.items():
        ranks = rec[f"2x{model}"]["ranks"]
        for opt_name, comp, fsdp in legs:
            key = tm_key(model, opt_name, comp, fsdp)
            r0 = ranks[0]["legs"][key]
            gaps = r0["loss_gaps"]
            if gaps[0] > 1e-5 or max(gaps) > 1e-3:
                fails.append(f"train_mesh {key}: losses part from one "
                             f"device's: gaps {gaps}")
            for r in ranks:
                leg = r["legs"][key]
                if leg["losses"] != r0["losses"] or \
                        leg["grad_norms"] != r0["grad_norms"]:
                    fails.append(f"train_mesh {key}: rank {r['rank']}'s "
                                 "metrics differ from rank 0's")
                if not all(np.isfinite(leg["losses"] + leg["grad_norms"])):
                    fails.append(f"train_mesh {key}: a loss or grad norm is "
                                 "not finite")
                if fsdp and leg.get("equal_to_no_fsdp") is not True:
                    fails.append(f"train_mesh {key}: rank {r['rank']}'s "
                                 "state differs from the no-FSDP run's: "
                                 f"{leg.get('first_difference')}")
                if comp == "int8" and fsdp and not leg.get("ef_bit_equal"):
                    fails.append(f"train_mesh {key}: rank {r['rank']}'s ef "
                                 "is not its blocks of the whole gradient's "
                                 "compression")
            for c in range(model):  # the data ranks of a model coordinate
                sums = [r["legs"][key]["replicated_sums"] for r in ranks
                        if r["coords"][1] == c]
                if any(s != sums[0] for s in sums):
                    fails.append(f"train_mesh {key}: the replicated leaves "
                                 f"of model coordinate {c} differ between "
                                 "data ranks")
            g = r0.get("grads")
            if g is not None:
                if g["max_rel_to_leaf_max"] > 1e-4 or abs(
                        g["loss"] - g["one_device_loss"]) > 1e-5 * abs(
                            g["one_device_loss"]):
                    fails.append(f"train_mesh {key}: step 0's gradients "
                                 f"against one device: {g}")
        held = [r["legs"][tm_key(1, "adamw", None, True)]["held_bytes"]
                for r in ranks] if model == 1 else []
        if held and max(held) > TM_HELD * rec["one_device"]["adamw"][
                "held_bytes"]:
            fails.append(f"train_mesh 2x1 fsdp: held bytes {held} above "
                         f"{TM_HELD} of one device's "
                         f"{rec['one_device']['adamw']['held_bytes']}")
    leg = rec["2x2"]["ranks"][0]["legs"][tm_key(2, "adamw", None, True)]
    for r in rec["2x2"]["ranks"]:
        rs = r["legs"][tm_key(2, "adamw", None, True)]["restart"]
        if not (rs["start"] == TM_CKPT and rs["params_equal"]
                and rs["losses"] == leg["losses"][TM_CKPT:]
                and rs["grad_norms"] == leg["grad_norms"][TM_CKPT:]):
            fails.append(f"train_mesh (e): rank {r['rank']}'s restart is not "
                         f"bit-equal: {rs}")
    sv = leg["serve"]
    rec["launches"] = sv["launches"]
    if not (sv["bit_equal"] and sv["finite"]):
        fails.append(f"train_mesh (f): lut_pallas logits differ from "
                     f"lut_xla's ({sv['max_abs_diff']})")
    if min(sv["launches"][n] for n in PER_ROW_PATH) <= 0:
        fails.append(f"train_mesh (f): a per_row kernel never launched: "
                     f"{sv['launches']}")
    rec["seconds"] = time.perf_counter() - t_phase
    for line in train_mesh_lines(rec):
        print(line, flush=True)
    if fails:
        raise AssertionError("train_mesh: " + "; ".join(fails))
    return rec


def tm_median(ms):
    rest = sorted(ms[1:])
    return rest[len(rest) // 2]


def tm_one_device_lines(rec):
    """Phase 21 (a)'s lines."""
    tok = TM_BATCH * TM_SEQ
    lines = []
    for name, one in rec["one_device"].items():
        med = tm_median(one["step_ms"])
        lines.append(
            f"train_mesh (a) one device, {name}: losses "
            f"{[round(x, 5) for x in one['losses']]}, {med:.1f} ms a step "
            f"(median of steps 2-{TM_STEPS}), {tok / med * 1e3:.0f} tok/s, held "
            f"{one['held_bytes'] / 1e9:.3f} GB, peak "
            f"{one['peak_bytes'] / 1e9:.3f} GB")
    return lines


def train_mesh_lines(rec):
    """Phase 21's last lines ((e), (f), its seconds), after (a)'s
    (``tm_one_device_lines``) and the legs' (``tm_world_lines``)."""
    lines = []
    leg = rec["2x2"]["ranks"][0]["legs"][tm_key(2, "adamw", None, True)]
    rs, sv = leg["restart"], leg["serve"]
    lines.append(
        f"train_mesh (e): restored on 2x2 at step {rs['start']}, steps "
        f"{rs['start'] + 1}-{TM_STEPS} "
        f"bit-equal on every rank: {rs['params_equal']}; restored on one "
        f"device in {rec['one_device_restore_s']:.1f} s, equal to every "
        f"rank's step-3 blocks: {rec['one_device_restore_equal']}")
    lines.append(
        f"train_mesh (f): the 2x2 run's params packed W2 per_row in "
        f"{sv['quantize_s']:.1f} s; lut_pallas = lut_xla bit for bit: "
        f"{sv['bit_equal']}; launches {sv['launches']}")
    lines.append(f"train_mesh: phase 21 in {rec['seconds']:.1f} s, card "
                 f"{rec['card']}")
    return lines


def tm_world_lines(rec, model):
    """The lines of phase 21's 2 x ``model`` legs."""
    tok = TM_BATCH * TM_SEQ
    lines = []
    w = rec[f"2x{model}"]
    for opt_name, comp, fsdp in TM_LEGS[model]:
        key = tm_key(model, opt_name, comp, fsdp)
        r0 = w["ranks"][0]["legs"][key]
        med = tm_median(r0["step_ms"])
        c = r0["collectives"][-1]["by_axis"]
        extra = ""
        if "grads" in r0 and r0["grads"] is not None:
            extra += (f"; step 0's gradients within "
                      f"{r0['grads']['max_rel_to_leaf_max']:.3g} of "
                      f"each leaf's max |g| ({r0['grads']['leaf']})")
        if "equal_to_no_fsdp" in r0:
            extra += ("; = no FSDP bit for bit" if
                      r0["equal_to_no_fsdp"] else "; != no FSDP")
        if "ef_bit_equal" in r0:
            extra += f"; ef = whole compression: {r0['ef_bit_equal']}"
        lines.append(
            f"train_mesh {key}: {med:.1f} ms a step, "
            f"{tok / med * 1e3:.0f} tok/s; largest loss gap to one "
            f"device {max(r0['loss_gaps']):.3g} (step 0 "
            f"{r0['loss_gaps'][0]:.3g}); a step's collectives: model "
            f"{c['model']['calls']} calls / {c['model']['bytes'] / 1e6:.1f}"
            f" MB, data {c['data']['calls']} calls / "
            f"{c['data']['bytes'] / 1e6:.1f} MB; held "
            + ", ".join(f"{r['legs'][key]['held_bytes'] / 1e9:.3f}"
                        for r in w["ranks"])
            + " GB, peak " + ", ".join(
                f"{r['legs'][key]['peak_bytes'] / 1e9:.3f}"
                for r in w["ranks"]) + " GB by rank" + extra)
    r0 = w["ranks"][0]
    legs = r0["legs"].values()
    extra = "".join(f", {k} {v[k]:.1f} s" for v in legs
                    for k in ("restart_s", "serve_s") if k in v)
    where = ("its ranks started for it" if w["pool_started"] else
             "its ranks up from an earlier phase")
    lines.append(f"train_mesh 2x{model}: legs in {w['legs_s']:.1f} s of "
                 f"a {w['run_s']:.1f} s run ({where}); the mesh made in "
                 f"{max(r['mesh_s'] for r in w['ranks']):.1f} s, rank 0's "
                 f"legs " + ", ".join(f"{v['leg_s']:.1f}" for v in legs)
                 + f" s{extra}; backend {r0['backend']}, losses "
                 f"{[round(x, 5) for x in r0['legs'][key]['losses']]}")
    return lines


def roofline_record(cfg, params, eng, step):
    """Phase 4's profiled decode step as a ``Roofline``: ``step_cost``'s
    useful operations and least bytes at the engine's slots and their
    cached positions (f32 K/V), against the step's wall and busy time."""
    from repro_torch.roofline import analysis, cost
    c = cost.step_cost(cfg, params, eng.max_batch,
                       [int(p) for p in eng.pos.tolist()], "decode",
                       table_quant="per_row")
    r = analysis.analyze(c["ops"], c["min_bytes"], min_bytes=c["min_bytes"])
    out = {"cost": c, "roofline": r.to_dict(), "t_memory_ms":
           r.t_memory * 1e3, "t_compute_ms": r.t_compute * 1e3,
           "fraction_of_wall": r.fraction_of(step["wall_ms"] / 1e3)}
    out["fraction_of_busy"] = (None if step["busy_ms"] is None else
                               r.fraction_of(step["busy_ms"] / 1e3))
    return out


def roofline_line(rec):
    c = rec["cost"]
    busy = ("not measured" if rec["fraction_of_busy"] is None else
            f"{rec['fraction_of_busy']:.4f}")
    return (f"serve: roofline of the profiled decode step (step_cost, "
            f"{c['tokens']} tokens): least bytes {c['min_bytes']:.0f} (params "
            f"{c['param_bytes']:.0f}, K/V read {c['kv_read_bytes']:.0f}, "
            f"written {c['kv_write_bytes']:.0f}), t_memory "
            f"{rec['t_memory_ms']:.4f} ms, t_compute "
            f"{rec['t_compute_ms']:.4f} ms ({rec['roofline']['dominant']}); "
            f"roofline_fraction against the wall "
            f"{rec['fraction_of_wall']:.4f}, against the busy time {busy}")


def main_config():
    from repro_torch.configs import registry
    return registry.get_config("tinyllama-1.1b").replace(
        activation_dtype=torch.float32).with_quant(mpgemm_mode="lut_pallas",
                                                   fusion="auto")


def decode_profile(eng):
    """``--decode-profile``: on a per_row engine, one decode step and one
    128-token prefill chunk profiled (``step_and_chunk``), then the per_row
    precompute timed at M ∈ {4, 128}, K ∈ {2048, 5632} (``time_ms``): the op
    ``ops.table_precompute`` (rowsum's sum included), the kernel with a
    given row scale, the closed-form row scale's torch kernels and, where
    the checkout has them, the one-launch precompute and ``row_scale``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import table_precompute as tk
    eng._decode_chunk(sampling=False)  # warm-up: lazy CUDA/cuBLAS state
    torch.cuda.synchronize()
    out = step_and_chunk(eng)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    out["precompute_ms"] = []
    for m in ROWS:
        for k in PRECOMPUTE_K:
            g = k // KG
            x = torch.randn(m, k, generator=gen, device="cuda")
            rs = ops._closed_form_row_scale(x, g, KG).contiguous()
            calls = {
                "op": lambda: ops.table_precompute(x, KG, "per_row"),
                "kernel_given_scale": lambda: tk.table_precompute(
                    x, KG, "per_row", rs),
                "closed_form_row_scale": lambda: ops._closed_form_row_scale(
                    x, g, KG)}
            if hasattr(tk, "row_scale"):
                calls["one_launch"] = lambda: tk.table_precompute(
                    x, KG, "per_row")
                calls["row_scale"] = lambda: tk.row_scale(x, KG)
            out["precompute_ms"].append(dict(
                m=m, k=k, **{name: time_ms(fn, 10, flush)
                             for name, fn in calls.items()}))
    out["launch_floor_ms"] = launch_floor_ms(flush)
    out["output_hashes"] = output_hashes()
    return out


def decode_profile_line(rec):
    step, chunk = rec["decode_step"], rec["prefill_chunk"]
    busy = ("device busy not measured" if step["busy_ms"] is None else
            f"device busy {step['busy_ms']:.2f} ms (idle share "
            f"{step['idle_share']:.3f}) in {step['kernels']:g} CUDA kernels")
    times = "; ".join(
        f"M={t['m']} K={t['k']}: " + ", ".join(
            f"{name} {v:.4f} ms" for name, v in t.items()
            if name not in ("m", "k")) for t in rec["precompute_ms"])
    return (f"one decode step: wall {step['wall_ms']:.2f} ms, {busy}, "
            f"launches {step['launches']}; one 128-token prefill chunk: "
            + prefill_line(chunk) + f", launches {chunk['launches']}; "
            f"per_row precompute: {times}; a 4-byte torch kernel "
            f"{rec['launch_floor_ms']:.4f} ms; output hashes "
            f"{rec['output_hashes']}")


def profile_only(card, flag) -> int:
    """``--prefill-profile``: phase 4's model and engine, then only the
    profile of one prefill chunk; ``--float-profile``: the same with float
    tables, then only ``float_profile`` (no bound is checked);
    ``--decode-profile``: per_row tables, then only ``decode_profile``. One
    line of JSON. They use no entry point newer than the port's first
    slices (``decode_profile`` looks the newer ones up first), so they also
    run on an older checkout of the port."""
    from repro_torch.models import api
    from repro_torch.serving.engine import ServingEngine
    cfg = main_config()
    if flag == "--float-profile":
        cfg = cfg.with_quant(table_quant=None)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = api.init_params(gen, cfg, "cuda")
    eng = ServingEngine(cfg, params, max_batch=4, max_seq=256,
                        decode_chunk=8, prefill_chunk=128)
    if flag == "--float-profile":
        rec = float_profile(cfg, params, eng)
        print("float tables: " + float_line(rec), flush=True)
        print(json.dumps({"float_tables": rec, "card": card}))
    elif flag == "--decode-profile":
        rec = decode_profile(eng)
        print("per_row tables: " + decode_profile_line(rec), flush=True)
        print(json.dumps({"decode_profile": rec, "card": card}))
    else:
        rec = prefill_chunk_profile(eng)
        print("prefill chunk: " + prefill_line(rec), flush=True)
        print(json.dumps({"prefill_chunk": rec, "card": card}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import scheme_name
    from repro_torch.models import api

    t_start = time.perf_counter()
    card = device_line()
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    paths = _build.build_all()
    ptxas = {n: [ln.strip() for ln in (_build.BUILD_DIR / f"{n}.ptxas.txt")
                 .read_text().splitlines() if "registers" in ln]
             for n in paths if (_build.BUILD_DIR / f"{n}.ptxas.txt").exists()}
    print(f"build: {len(paths)} kernels in {_build.build_seconds:.1f} s "
          f"(nvcc {_build.nvcc_path()})", flush=True)
    if len(sys.argv) > 1 and sys.argv[1] in (
            "--prefill-profile", "--float-profile", "--decode-profile"):
        return profile_only(card, sys.argv[1])
    if len(sys.argv) > 1 and sys.argv[1] == "--decoding":
        cfg = main_config()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = api.init_params(gen, cfg, "cuda")
        rec = decoding_phase(cfg, params)
        for line in decoding_lines(rec):
            print(line, flush=True)
        print(json.dumps({"decoding": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--bound-seeds":
        return bound_seeds(card)
    if len(sys.argv) > 1 and sys.argv[1] == "--telemetry":
        cfg = main_config()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = api.init_params(gen, cfg, "cuda")
        serve(cfg, params, seed=1)  # warm-up: lazy CUDA/cuBLAS state
        rec = telemetry_phase(cfg, params)
        for line in telemetry_lines(rec):
            print(line, flush=True)
        print(json.dumps({"telemetry": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--moe":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                            device="cuda")
        cfg, eng, rec = moe_phase(flush)
        for line in moe_lines(cfg, eng, rec):
            print(line, flush=True)
        print(json.dumps({"moe": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--ssm":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                            device="cuda")
        engines, rec = ssm_phase(flush)
        for line in ssm_lines(engines, rec):
            print(line, flush=True)
        print(json.dumps({"ssm": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--xattn":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                            device="cuda")
        ssm_models = {}
        for arch in SSM_ARCHS:  # (e)'s models, made as phase 12 makes them
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            cfg = full_config(arch)
            ssm_models[arch] = (cfg, api.init_params(gen, cfg, "cuda"))
        engines, rec = xattn_phase(flush, ssm_models)
        for line in xattn_lines(engines, rec):
            print(line, flush=True)
        print(json.dumps({"xattn": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--train":
        tcfg, teng, rec = train_phase()
        for line in train_lines(tcfg, teng, rec):
            print(line, flush=True)
        print(json.dumps({"train": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--kvint8":
        rec = kvint8_phase()
        for line in kvint8_lines(rec):
            print(line, flush=True)
        print(json.dumps({"kvint8": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--train-families":
        rec = train_families_phase(*map(float, sys.argv[2:3]))
        for line in train_families_lines(rec):
            print(line, flush=True)
        print(json.dumps({"train_families": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--window":
        rec = window_phase()
        for line in window_lines(rec):
            print(line, flush=True)
        print(json.dumps({"window": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--tp":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                            device="cuda")
        rec = tp_phase(flush)
        for line in tp_lines(rec):
            print(line, flush=True)
        print(json.dumps({"tp": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--dp":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                            device="cuda")
        rec = dp_phase(flush)
        print(json.dumps({"dp": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--train-mesh":
        rec = train_mesh_phase()
        print(json.dumps({"train_mesh": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--cw":
        rec = cw_phase()
        for line in cw_lines(rec):
            print(line, flush=True)
        print(json.dumps({"cw": rec, "card": card}))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--bitnet":
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                            device="cuda")
        cfg, eng, rec = bitnet(flush)
        for line in bitnet_lines(cfg, eng, rec):
            print(line, flush=True)
        print(json.dumps({"bitnet": rec, "card": card}))
        return 0
    mma_report = {lib: kernel_report(
        (_build.BUILD_DIR / f"{lib}.ptxas.txt").read_text())
        for lib, _, _ in MMA_CHECKS}
    mma = {}
    for lib, kernel, op in MMA_CHECKS:
        counts = mma_counts(paths[lib], _build.nvcc_path(), op)
        mma[f"{kernel} {op}"] = counts
        print(f"build: {kernel} (ptxas -v): " + "; ".join(
            f"{k}: {', '.join(v)}" for k, v in mma_report[lib].items()
            if k.startswith(kernel)) + f"; {op} instructions in SASS: " + (
                "not counted (no cuobjdump)" if counts is None else
                ", ".join(f"{k} {v}" for k, v in counts.items()
                          if v and k.startswith(kernel))), flush=True)
        found = [v for k, v in (counts or {}).items() if k.startswith(kernel)]
        if counts is not None and not (found and all(found)):
            raise AssertionError(f"build: {lib}'s {kernel} has no {op} in "
                                 f"some instance: {counts}")

    tp_report = kernel_report((_build.BUILD_DIR / "table_precompute.ptxas.txt")
                              .read_text(), PRECOMPUTE_KERNELS)
    print("build: table_precompute (ptxas -v): " + "; ".join(
        f"{k}: {', '.join(v)}" for k, v in tp_report.items()), flush=True)

    t0 = time.perf_counter()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    records, err = check_kernels(flush)
    pre_records = precompute_checks(flush)
    err["row_scale"] = 0.0  # bit-equal, or precompute_checks raised
    floor_ms = launch_floor_ms(flush)
    print("kernels: table_precompute and row_scale, bit-equal to the plain "
          "versions: " + "; ".join(precompute_line(r) for r in pre_records)
          + f"; a 4-byte torch kernel {floor_ms:.4f} ms under the same "
          f"timer", flush=True)
    print("kernels: " + "; ".join(record_line(r) for r in records),
          flush=True)
    print("kernels vs plain: max |diff| " + ", ".join(
        f"{k} {v:.3g}" for k, v in err.items())
        + " (table_precompute and row_scale bit-exact in every mode; the "
        "mpGEMMs per_row bit-exact, None / per_group and dequant within rtol "
        "= atol = 1e-4 of each output, two calls bit-equal)", flush=True)
    dq_launches, dq_err = dequant_op_path()
    err["dequant_mpgemm"] = max(err["dequant_mpgemm"], dq_err)
    print(f"kernels: dequant op path (ops.dequant_mpgemm, 10 shapes): "
          f"{dq_launches} launches, max |diff| {dq_err:.3g} vs the f32 "
          f"dequantized product (<= 1e-4 relative); phase 3 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 4: the main path, at full width
    t0 = time.perf_counter()
    cfg = main_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = api.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    print(f"serve: {cfg.arch_id} {scheme_name(cfg.quant)} params made on "
          f"the card in {time.perf_counter() - t0:.1f} s", flush=True)
    # phases 4 and 5: serve, then kernels vs plain LUT path through the
    # whole model
    eng, main_rec = serve_and_parity("serve", cfg, params)
    main_rec["roofline"] = roofline_record(cfg, params, eng,
                                           main_rec["decode_step"])
    for line in serve_lines("serve", cfg, eng, main_rec):
        print(line, flush=True)
    print(roofline_line(main_rec["roofline"]), flush=True)
    print(f"serve: phases 4 and 5 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = main_rec["launches"]

    # phase 6: the block-paged pool with prefix sharing, at full width
    t0 = time.perf_counter()
    pst, paged_launches, paged_rec = paged(cfg, params)
    kv, div = paged_rec["first_kv_divergence"], paged_rec["divergences"]
    print(f"paged: 8 requests (6 share a 144-token prompt, 2 equal 160-token "
          f"prompts), 16 tokens each, in {time.perf_counter() - t0:.1f} s; "
          f"streams equal to the dense engine's without sharing, and with "
          f"sharing " + ("too" if not div else f"up to near ties {div}")
          + f"; {pst['prefill_tokens_reused']} prompt tokens reused "
          f"(rule: 5*144 + 159), {pst['prefill_tokens']} prefilled (dense "
          f"{paged_rec['dense_prefill_tokens']}); decode tok/s "
          f"{paged_rec['decode_tok_s']}; a paged decode chunk under "
          f"torch's sync check: no hidden sync; launches {paged_launches}; "
          f"suffix prefill at offset 144 vs dense prefill: "
          + ("K/V equal in every layer" if kv is None else
             f"K/V first differ at layer {kv[0]}, position {kv[1]} (max "
             f"|diff| {kv[2]:.3g})"), flush=True)
    print("paged stats: " + json.dumps(pst), flush=True)
    pstep = paged_rec["paged_decode_step"]
    print("paged: decode step wall ms in turns (dense, paged, paged, "
          f"dense): {paged_rec['decode_step_wall_ms']}; a profiled paged "
          f"step: wall {pstep['wall_ms']:.2f} ms, " + (
              "device busy not measured" if pstep["busy_ms"] is None else
              f"device busy {pstep['busy_ms']:.2f} ms (idle share "
              f"{pstep['idle_share']:.3f}); device time by kernel: "
              + ", ".join(f"{n} {t:.2f} ms" for n, t in pstep["top"])),
          flush=True)

    # phase 7: float tables, at full width
    t0 = time.perf_counter()
    fst, float_launches, float_rec = float_tables(cfg, params)
    print(f"float: table_quant=None serve, 4 requests, "
          f"{fst['decode_tokens']} tokens in {time.perf_counter() - t0:.1f} "
          f"s with the profiles; decode {fst['decode_tok_s']:.1f} tok/s, "
          f"host syncs/token {fst['host_syncs_per_token']:.4f}; launches "
          f"{float_launches}", flush=True)
    print("float: " + float_line(float_rec), flush=True)

    # phase 8: the paper's own model, paper-bitnet-3b, at full width
    t0 = time.perf_counter()
    bcfg, beng, bitnet_rec = bitnet(flush)
    for line in bitnet_lines(bcfg, beng, bitnet_rec):
        print(line, flush=True)
    print(f"bitnet: phase 8 in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 9: decoding modes on phase 4's model and prompts
    decoding_rec = decoding_phase(cfg, params, main_rec["outputs"])
    for line in decoding_lines(decoding_rec):
        print(line, flush=True)

    # phase 10: telemetry and the measured autotuner on phase 4's model
    telemetry_rec = telemetry_phase(cfg, params, (
        main_rec["outputs"], main_rec["serve"]["decode_syncs"]))
    for line in telemetry_lines(telemetry_rec):
        print(line, flush=True)

    # phase 11: the MoE family, full-width olmoe-1b-7b
    t0 = time.perf_counter()
    mcfg, meng, moe_rec = moe_phase(flush)
    for line in moe_lines(mcfg, meng, moe_rec):
        print(line, flush=True)
    print(f"moe: phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 12: the SSM and hybrid families, full-width falcon-mamba-7b and
    # zamba2-7b
    t0 = time.perf_counter()
    ssm_engines, ssm_rec = ssm_phase(flush)
    for line in ssm_lines(ssm_engines, ssm_rec):
        print(line, flush=True)
    print(f"ssm: phase 12 in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 13: the VLM and audio families, full-width llama-3.2-vision-11b
    # and whisper-tiny; its (e) runs beam search on phase 12's models, whose
    # weights it then frees
    t0 = time.perf_counter()
    ssm_cfgs = {arch: cfg for arch, (cfg, _) in ssm_engines.items()}
    ssm_models = {arch: (cfg, e.params)
                  for arch, (cfg, e) in ssm_engines.items()}
    del ssm_engines
    xattn_engines, xattn_rec = xattn_phase(flush, ssm_models)
    for line in xattn_lines(xattn_engines, xattn_rec):
        print(line, flush=True)
    print(f"xattn: phase 13 in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 14: training full-width tinyllama-1.1b, then serving the trained
    # weights; the earlier phases' models are freed first
    xattn_cfgs = {arch: cfg for arch, (cfg, _) in xattn_engines.items()}
    del xattn_engines, eng, beng, meng, params
    gc_cuda()
    t0 = time.perf_counter()
    tcfg, teng, train_rec = train_phase()
    for line in train_lines(tcfg, teng, train_rec):
        print(line, flush=True)
    del teng
    print(f"train: phase 14 in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 15: the int8 KV cache on tinyllama-1.1b, olmoe-1b-7b (with its
    # beam and speculation), whisper-tiny and zamba2-7b, each made anew
    gc_cuda()
    kv_rec = kvint8_phase()
    for line in kvint8_lines(kv_rec):
        print(line, flush=True)

    # phase 16: QAT training on the SSM, hybrid, VLM and audio families,
    # each model made anew and freed after its leg
    gc_cuda()
    tf_rec = train_families_phase()
    for line in train_families_lines(tf_rec):
        print(line, flush=True)

    # phase 17: sliding-window attention on the rolling KV cache, zamba2-7b
    gc_cuda()
    win_rec = window_phase()
    for line in window_lines(win_rec):
        print(line, flush=True)

    # phase 18: the offline-CW weight store, tinyllama-1.1b under lut_xla
    cw_rec = cw_phase()
    for line in cw_lines(cw_rec):
        print(line, flush=True)

    # phase 19: serving across a model-axis mesh, ranks sharing the card
    gc_cuda()
    tp_rec = tp_phase(flush)
    for line in tp_lines(tp_rec):
        print(line, flush=True)

    # phase 20: the data axis, per-rank builds and data-parallel serving
    gc_cuda()
    dp_rec = dp_phase(flush)

    # phase 21: training under a (data, model) mesh, ranks sharing the card
    gc_cuda()
    tm_rec = train_mesh_phase()
    close_pools()

    def on_path(r):
        """The records at the shapes the main path gives each kernel:
        dequant_mpgemm's op path at all ten; the per_row precompute, row
        scale computed, at M = 128 (the staged prefill); the row scale at
        M = 4 (the fused decode); the LUT mpGEMMs per_row at their M."""
        if r["kernel"] == "dequant_mpgemm":
            return True
        if r["kernel"] == "table_precompute":
            return r["m"] == 128 and r["row_scale"] == "computed"
        if r["kernel"] == "row_scale":
            return r["m"] == 4
        return r["m"] == MAIN_M[r["kernel"]] and r["table_quant"] == "per_row"

    main_recs = [r for r in records + pre_records if on_path(r)]
    sources = {"table_precompute": ("src/repro_torch/csrc/table_precompute.cu",
                                    "src/repro/kernels/table_precompute.py:62"),
               "row_scale": ("src/repro_torch/csrc/table_precompute.cu",
                             "src/repro/kernels/ops.py:58"),
               "lut_mpgemm": ("src/repro_torch/csrc/lut_mpgemm.cu",
                              "src/repro/kernels/lut_mpgemm.py:119"),
               "fused_lut_mpgemm": ("src/repro_torch/csrc/fused_lut_mpgemm.cu",
                                    "src/repro/kernels/fused_lut_mpgemm.py:126"),
               "dequant_mpgemm": ("src/repro_torch/csrc/dequant_mpgemm.cu",
                                  "src/repro/kernels/dequant_mpgemm.py:76")}
    # dequant_mpgemm's path is its op entry (phase 3's op run); a serve
    # step launches it 0 times, as in the reference
    path_launches = dict(launches, dequant_mpgemm=dq_launches)
    def at_shapes(name, records, err, launches, shapes=None):
        """A kernel's launches in a phase's serve and, where the phase
        timed it, its on-path records at that model's shapes summed."""
        rs = [r for r in records if r["kernel"] == name and on_path(r)
              and (shapes is None or (r.get("n"), r["k"]) in shapes
                   or r["kernel"] in ("table_precompute", "row_scale")
                   and r["k"] in {k for _, k in shapes})]
        out = {"launches": launches[name]}
        if rs:
            out.update(max_abs_err=err[name], **{
                o: float(sum(r[key] for r in rs)) for o, key in (
                    ("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                    ("bound_ms", "bound_ms"), ("library_ms", "library_ms"))},
                bound_by=max(("bytes", "operations"), key=lambda by: sum(
                    r["bound_ms"] for r in rs if r["bound_by"] == by)),
                shapes=[[r["m"], r.get("n"), r["k"]] for r in rs])
        return out

    ssm_records = ssm_rec["records"] + ssm_rec["precompute_records"]
    xattn_records = xattn_rec["records"] + xattn_rec["precompute_records"]
    summary = []
    for name, (src, replaces) in sources.items():
        rs = [r for r in main_recs if r["kernel"] == name]
        tot = lambda key, rs=rs: float(sum(r[key] for r in rs))
        # phase 8's serve, its kernel times at paper-bitnet-3b's shapes
        bit = at_shapes(name, bitnet_rec["records"]
                        + bitnet_rec["precompute_records"],
                        bitnet_rec["err"], bitnet_rec["launches"])
        # phase 12's serves, the kernel times at each model's shapes
        ssm_models = {arch: at_shapes(
            name, ssm_records, ssm_rec["err"], ssm_rec[arch]["launches"],
            set(packed_shapes(cfg).values()))
            for arch, cfg in ssm_cfgs.items()}
        # phase 13's serves, the kernel times at each model's shapes
        xattn_models = {arch: at_shapes(
            name, xattn_records, xattn_rec["err"],
            xattn_rec[arch]["launches"], set(packed_shapes(cfg).values()))
            for arch, cfg in xattn_cfgs.items()}
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": path_launches[name], "max_abs_err": err[name],
            "serve_launches": launches[name],
            "paged_launches": paged_launches[name],
            "float_launches": float_launches[name],
            "decoding_launches": decoding_rec["launches"][name],
            "tuned_serve_launches": telemetry_rec["tuned_serve"][
                "launches"][name],
            "ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in rs if r["bound_by"] == by)),
            "library_ms": tot("library_ms"),
            "shapes": [[r["m"], r["n"], r["k"]] for r in rs],
            "bitnet": bit, "moe_launches": moe_rec["launches"][name],
            "moe_staged_launches": moe_rec["staged_launches"][name],
            "train_serve_launches": train_rec["launches"][name],
            # phase 15's int8-cache serves, by model
            "kvint8_launches": {arch: kv_rec[arch]["launches"][name]
                                for arch in KV_ARCHS},
            # phase 16's trained weights: each model's teacher-forced
            # forward, and falcon-mamba-7b's engine serve
            # phase 17's windowed zamba2-7b: the float-table stream on the
            # rolling cache and the per_row step past the wrap
            "window_launches": win_rec["launches"][name],
            # phase 19: rank 0's launches in each mesh leg's main serve
            # (per_row; olmoe's greedy), and the kernel at the per-shard
            # shapes
            "tp_launches": tp_launches(tp_rec, name),
            "tp": at_shapes(name, tp_rec["kernels"], tp_rec["err"],
                            tp_launches(tp_rec, name, "1x2")),
            # phase 20: rank (0, 0)'s launches in each data-axis leg's main
            # serve, and the kernel at a data rank's decode rows (M = 2)
            "dp": dp_summary(dp_rec, name),
            # phase 21 (f): the 2x2 mesh-trained weights' teacher-forced
            # lut_pallas forwards
            "train_mesh_launches": tm_rec["launches"][name],
            "train_families_launches": {
                arch: dict({"forward": tf_rec[arch]["forward"][
                    "launches"][name]}, **({"engine": tf_rec[arch][
                        "engine"]["launches"][name]}
                        if "engine" in tf_rec[arch] else {}))
                for arch in FAMILY_LEGS},
            **ssm_models, **xattn_models})
    # the expert-batched wrappers, per_row at the expert shapes (decode
    # C = 8 and prefill C = 24, gate/up and down), each with the launches
    # of the phase 11 serve whose path runs it
    for name in BATCHED:
        rs = [r for r in moe_rec["records"]
              if r["kernel"] == name and r["table_quant"] == "per_row"]
        tot = lambda key, rs=rs: float(sum(r[key] for r in rs))
        src, replaces = sources[name[:-len("_batched")]]
        path = next(p for p, (ran, _) in MOE_PATHS.items() if name in ran)
        counts = moe_rec["launches" if path == "auto" else "staged_launches"]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "path": f"phase 11, olmoe-1b-7b served with fusion={path}",
            "kvint8_launches": kv_rec[MOE]["launches"][name],
            "tp_launches": tp_launches(tp_rec, name),
            "dp_launches": dp_launches(dp_rec, name),
            "max_abs_err": moe_rec["err"][name],
            "ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": max(("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in rs if r["bound_by"] == by)),
            "library_ms": tot("library_ms"),
            "two_d_loop_ms": tot("two_d_loop_ms"),
            "shapes": [[r["experts"], r["c"], r["n"], r["k"]] for r in rs]})
    with open(_build.BUILD_DIR / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "records": records,
                   "precompute_records": pre_records,
                   "launch_floor_ms": floor_ms, "summary": summary,
                   "serve": main_rec,
                   "dequant_op_launches": dq_launches, "paged": pst,
                   "paged_launches": paged_launches, "paged_check": paged_rec,
                   "float_serve": fst, "float_launches": float_launches,
                   "float_tables": float_rec, "bitnet": bitnet_rec,
                   "decoding": decoding_rec, "telemetry": telemetry_rec,
                   "moe": moe_rec, "ssm": ssm_rec, "xattn": xattn_rec,
                   "train": train_rec, "kvint8": kv_rec,
                   "train_families": tf_rec,
                   "window": win_rec, "cw": cw_rec, "tp": tp_rec,
                   "dp": dp_rec, "train_mesh": tm_rec,
                   "ptxas": ptxas,
                   "mma_ptxas": mma_report,
                   "mma_instructions": mma,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(f"chip_smoke: every phase in {time.perf_counter() - t_start:.1f} s, "
          "the kernels' build included", flush=True)
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        close_pools()
    sys.exit(rc)
