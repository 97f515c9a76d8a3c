#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's inference path on the card at the full width of the
serving flagship (TransformerLM vocab 32000, embed 512, 8 heads, 2 kv
heads, 8 layers, RoPE, flash on; random weights from a seed) and its
training path at the full width of the training flagship (vocab 32000,
embed 512, 8 heads, 8 layers, learned positions, batch 32 x 1024
tokens, bf16 compute over f32 masters, SGD, flash on), and fails, with
a non-zero exit, at the first phase that does not hold:

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions, TF32;
2. build: the CUDA kernel library compiled from every ``.cu`` under
   ``bigdl_tpu_torch/ops/csrc`` (the flash forward and its backward) by
   one ``nvcc`` call for sm_90a, with the compiler's register/spill
   report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes of the main path and its edge cases, out and lse, with the
   stated tolerances (shown, at the flagship shape, to reject an output
   that dropped one kv tile), at the edges of its tiling, and timed beside
   its bound and a PyTorch library call: ``kernel_ms`` / ``library_ms``
   by CUDA events around eager calls, ``device_ms`` /
   ``library_device_ms`` by CUDA-graph replay (the card's time alone);
   then a sweep of t = tk from 512 to 8192 at the flagship width (kernel,
   library and bound ms, share of the bound);
4. scoring: the flagship forward in bf16 over 4 x 2048 tokens launches
   the flash kernel once per layer and agrees with the dense path;
5. generate: greedy generation of 64 tokens for 8 prompts of 256 tokens,
   checked by teacher forcing through the flash forward;
6. server: ``GenerationService`` answers 8 concurrent mixed-length
   requests, each row equal to a lone ``generate`` in f32 with TF32 off;
   then the continuous-batching engine, whose chunked prefill and decode
   use the masked dense attention (no flash launch, checked):

   - engine_gate (f32, TF32 off): the same 8 requests at once through
     ``ContinuousBatchingEngine(max_slots=4, prefill_chunk=64,
     prefill_rows=2)``, each row equal to a lone ``generate`` or, at its
     first difference, a near tie of the lone run (top two logits within
     1e-4); a 192-token prefix hit whose row equals the cache-off
     engine's; a cancellation mid-decode; the flow counters;
   - engine_serving (bf16): a Poisson workload of 16 requests at 20/s
     (prompts 64-512, 16-128 new tokens) through the engine
     (``max_slots=8, prefill_chunk=64, prefill_rows=4``) and through
     ``GenerationService(max_batch=8)``: latency, TTFT, inter-token gap,
     tokens/s, the p99 speedup, and a ``torch.profiler`` window over 16
     loop iterations of steady decode (launches an iteration, device
     busy share, top kernels);
   - engine_prefix (f32, TF32 off): ``run_shared_prefix_comparison`` at
     16 requests over 4 templates of 512 tokens, cache on against off:
     TTFT speedups, hit rate, rows equal (or near ties);
   - paged_gate (f32, TF32 off): engine_gate's 8 requests through the
     paged engine (``page_size=16``), each row equal to a lone
     ``generate`` or a near tie; the 192-token prefix hit takes its 12
     head pages by refcount (no page copied) and its row equals the
     cache-off engine's; after drain the pool holds exactly the prefix
     index's pages, and none after stop; a 21-page pool over a
     320-token window serves the 8 rows, each waiting for pages;
   - spec_gate (f32, TF32 off): the 8 requests through the speculative
     engine (``spec_gamma=4``), dense and paged, with draft (a) (an
     unrelated 2-layer, 256-wide model from its own seed: rejections)
     and with the target as its own draft (every proposal accepted,
     acceptance >= 0.99: the bonus and full-burst paths); rows as
     above; a lone ``speculative_generate`` with draft (a) for two
     prompts;
   - paged_serving (bf16): ``run_paged_comparison`` (16 requests at
     200/s, 2 dense slots against 8 paged slots at equal KV bytes):
     admitted-concurrency ratio, TTFT speedups, the byte budget, rows
     equal between the legs; then the profile window over 16 steady
     paged-decode iterations;
   - spec_serving (bf16): ``run_speculative_comparison`` with draft (a)
     (8 requests at 30/s, 8 slots, gamma 4): inter-token and TTFT
     speedups, acceptance rate, token parity; then the profile window
     over 16 steady speculative iterations;
   - quant_gate (f32, TF32 off): ``quantize_kv`` on the card gives the
     CPU's bytes at a flagship cache shape; the int8 Linear's int32
     products and f32 outputs equal the CPU's bit for bit at the
     flagship widths and at 4, 8, 24 and 256 rows; the int8
     convolution's f32 sums of codes against the CPU's int32 ones (equal
     at K = 576, under the 2**24 bound; reported at K = 4608); the int8
     engine (KV and weights) serves a template workload one request at
     a time with the same rows plain and with the prefix cache and its
     host tier (a one-row pool: every demotion and promotion held to
     the bytes the row had on the device), and paged with and without
     page pressure (30 pages over a 256-token window, held the same
     way); dense against paged and the int8-draft speculative rows
     against the plain ones (int8 weights, and int8 KV over float
     weights) are reported; ``quantized_quality_report``;
   - quant_serving (bf16): ``run_quantized_comparison`` (8 requests at
     30/s, 8 slots; int8 against float, int8 KV only, the int8 draft
     over float and int8 KV): latencies, row bytes (ratio 0.5312 at
     head_dim 64), quality, acceptance, parity within each regime; then
     the profile window of the int8 engine beside the dense one;
   - tier_serving (bf16): ``run_working_set_sweep`` (2 and 8 templates of
     256 tokens against a 2-row prefix pool): hit rate and TTFT with the
     host tier against device only, demotions and promotions;
   - qos_gate (f32, TF32 off, one slot, ``preempt_slack_s=0.002``): the
     preemption drill (a low-class victim decoding in the only slot, a
     high-class arrival) dense, paged, with a prefix host tier and
     speculative with draft (a), both rows held to a lone ``generate``
     and the paged pool holding only the prefix index's pages after
     drain; the chaos shed drill (low shed on a burn, normal served;
     normal shed on a severe burn; high always served); a scripted
     dispatch fault on a prefill round and on a decode (the loop stops,
     every handle fails within 10 s); a frozen slot that stalls while
     the other streams and resumes equal to a lone ``generate``; a
     tenant bucket refusing with a retry hint; the usage ledger's
     conservation within 1e-9;
   - qos_serving (bf16): ``run_qos_storm`` at the JAX defaults (24
     requests at 20/s into 2 slots, 3 greedy-tenant requests, then the
     high class alone): high-class TTFT p50 / p99 ratios, the shed,
     preempted and rate-limited counts (each > 0), the outcomes and
     their conservation, the tenants' device-seconds, the goodput block;
   - quant_scoring (bf16): the int8 clone's ``forward`` over 4 x 2048
     tokens launches the flash kernel once a layer; its tokens/s beside
     the float forward's, the max |logit| difference;
   - beam_serving (bf16): ``beam_search`` of 4 prompts of 128 tokens, 4
     beams, 64 new tokens, with eos and without (ms, tokens/s); one beam
     equal to greedy ``generate`` (or a near tie); a best beam below the
     greedy row only where the greedy prefix left the beams; the best
     beam's score against an f32 teacher-forced rescoring of its tokens
     within 2e-2; a run filling the 2048-token window; no flash launch;
   - predict_serving (bf16): ``PredictionService`` over the flash
     forward, 16 clients sending 32 requests of 512 tokens, half as
     bytes (``max_batch`` 8, ``sample_ndim`` 1): each answer held to a
     lone ``forward`` by phase 3's row-RMS rule, a malformed request and
     payload answered with the error tensor, 8 launches a forward
     dispatch, requests a dispatch and latency p50/p99; then
     ``LocalPredictor.predict_class`` over a ResNet-50 f32 eval batch of
     256 against 1 + the argmax of a lone forward;
   - noncausal_scoring (bf16): the ``causal=False`` flagship's forward
     over 4 x 2048 tokens, 8 launches, against ``use_flash=False`` by
     phase 4's rule;
7. flash_backward: the differentiable flash attention (the forward
   kernel, the backward kernels ``flash_bwd_prep``, ``flash_bwd_dkdv``
   and ``flash_bwd_dq``) against the plain forward (out and lse), its
   dq / dk / dv against autograd through the plain forward and against
   the plain backward on the same saved tensors and cotangents (out's,
   both, lse's alone, the stride-0 cotangent of ``out.sum()``), at the
   training shape (on views of a fused qkv projection, as the model
   passes them) and its edge cases (``BWD_CASES``,
   ``BWD_KERNEL_CASES``); two backward calls bit-equal; the backward
   kernels timed beside the plain backward, SDPA's backward and their
   bound, eagerly and by CUDA-graph replay (the card's time alone), with
   their registers and spills;
8. train: ``transformer_perf`` at the training flagship (ms/step,
   tokens/s, analytic MFU, the loss of every step, 8 kernel launches and
   8 backward-kernel calls a step; a remat step launches the forward 16
   times), a ``torch.profiler`` pass over one step (the backward
   kernels' device ms by name), and at batch 4 in f32 with TF32 off the
   flash path's gradients against the dense path's, then f32 SGD steps
   that lower the loss. Every training phase (these, checkpoint_train,
   distri_train, ring_gate, longcontext_train, obs_serving's train
   family, perf_cli's transformer) counts its backward-kernel calls
   (``fa.backward_launches``) from 0 and asserts them, and asserts that
   no CUDA tensor reached the plain backward
   (``fa.plain_backward_cuda_calls`` 0);
   then checkpoint_train: the training flagship through the
   ``LocalOptimizer`` (bf16 over f32 masters, ``RMSprop``, a
   ``TrainSummary``, async checkpoints after iterations 1, 3 and 5 of
   8; 8 launches a step), ``load_latest_checkpoint`` into a fresh model
   and method (parameters, slots and state bit-equal to device copies
   taken at the checkpoint) and iterations 6 and 7 again (losses within
   1e-3 of the uninterrupted run's), with the checkpoint bytes, write
   seconds, the loop's stall and the step time with and without a write
   in flight; and optim_criterion_gate (f32, TF32 off): each new optim
   method five steps of a small model and its flat ``optimize``, LBFGS,
   and every criterion's value and input gradient, card against CPU;
9. the kernels line: one JSON object with each kernel's launches on the
   main paths (phases 4-6, and the timed bf16 training run of phase 8,
   each counted from 0 just before it and read just after; the engine
   phases, the remat run and the f32 gate are counted on their own
   lines; ``launches_engine`` is the sum of the twelve engine phases'
   counts, each asserted 0; ``launches_quant`` is quant_scoring's;
   ``launches_beam``, ``launches_predict``, ``launches_noncausal`` and
   ``launches_checkpoint_train`` are slice 9's phases'; ``launches_text``
   is text_train's and text_lm's; ``launches_distri``,
   ``launches_ring`` and ``launches_longcontext`` are slice 13's, the
   spawned ranks' own counts summed), error, times and bound; then the
   backward kernels' entry (``flash_attention_bwd``): their calls by
   training phase and in total, the training-shape record's error
   against the plain backward, times and bound.

Before the kernels line, the vision path (ResNet-50 at full width and
depth, LeNet-5, the LocalOptimizer), which launches no kernel of the
port: its convolutions, BatchNorm and pooling are XLA ops in the JAX
package and torch ops here.

- vision_gate: f32 with TF32 off for matmul and cuDNN, ResNet-50 NHWC
  and NCHW on shared weights with random BN affine and statistics; the
  eval logits at batch 2 agree with each other and with the port's CPU
  forward, and one training ``TrainStep`` at batch 4 on the card (NHWC)
  agrees with the same step on the CPU (NCHW): parameter updates and
  new running statistics, which must have moved;
- vision_train: ``run_perf("resnet50")`` at batch 256, NHWC, bf16 over
  f32 masters, as ``bench.py`` sets it up: ms/step, images/s, peak
  memory, analytic MFU, the loss of every step; then a
  ``torch.profiler`` pass over one step (vision_profile);
- vision_eval: the ``entry()`` twin, ResNet-50 eval forward in f32 at
  batch 8 NCHW, and in bf16 NHWC at batch 256 (checked at its first 8
  images against the f32 model), images/s;
- local_optimizer: ``LocalOptimizer`` trains LeNet-5 for one epoch over
  4096 synthetic samples at batch 128 with a Top1Accuracy validation at
  the end of the epoch (the loss falls), then a bf16 ResNet-50 NHWC
  (f32 BN statistics) for 8 iterations at batch 64 from 224 x 224
  samples staged through the prefetch thread (the records/s the loop
  logs; the parameters and statistics it writes back must have moved);
  beside it, where a loop step's time goes: the host side of the data
  path per batch, the same step without the loop, and ``run_perf`` at
  batch 64 with one profiled step.

After it, the image zoo (slice 10), which launches no kernel of the
port either (each phase counts the flash launches from 0 and asserts 0):

- zoo_gate: f32 with TF32 off, VGG CIFAR (batch 32), VGG-16, both
  Inception v1 forms (batch 2), MobileNetV1 NCHW and NHWC (batch 8) and
  the autoencoder (batch 8) at full width, each on the card against
  the same weights and random BN state on the CPU in f64: eval outputs
  (InceptionV1's three heads each) and one SGD step's update;
  MobileNet NHWC against NCHW on the card;
- zoo_train: ``run_perf`` for VGG-16 (batch 64, NCHW), Inception v1
  (128) and MobileNetV1 (256, NHWC), bf16 over f32 masters: ms/step,
  images/s, peak memory, analytic MFU (the built model's convolution
  and linear MACs against the published ones), and one profiled step
  each (zoo_profile);
- zoo_mains: vgg.train / vgg.test and resnet.train on CIFAR binary
  files, lenet.train / lenet.test on MNIST idx files, imagenet_gen over
  a folder of 128 .npy images of 256 x 256, inception.train at batch 32
  on its records, each train main one epoch with a checkpoint and then
  resumed (the resumed model equal bit for bit);
- input_pipeline: the port's C++ runtime (``native/*.cc`` built by
  ``g++`` into ``build/bigdl_tpu_torch/``; the phase fails where it does
  not build), the fused transform calling its kernel for every image
  with the numpy path's bytes, then ``run_input_pipeline_perf`` (512
  records of 256 x 256, batch 64, crop 224, prefetch depths 0 / 2 / 4:
  the composed augment read by the C++ reader and by the Python pool,
  the fused augment through the C++ kernel and its numpy twin, the
  kernel on 4 workers; each row must have run what it asked for),
  records/s beside zoo_train's Inception images/s.

Then the perf CLI and the layer variants (slice 11):

- perf_cli: ``bigdl_tpu_torch.models.perf.main(argv)`` with the bench
  history pointed at a temporary file: the training flagship (``--model
  transformer --dtype bfloat16 --master-f32 --iterations 5``; its flash
  launches counted from 0 equal 8 layers x (3 warm-up + 5 timed
  steps)), ``bench.py``'s ResNet-50 (batch 256, NHWC, bf16 over f32
  masters, 10 iterations) with ``--profile`` (the Chrome trace must hold
  CUDA kernel events) and without, the decode runs at the JAX defaults
  but 32 new tokens (plain, ``--int8``, ``--speculative 2``,
  ``--speculative-int8``: rates
  finite and positive, accept rates in [0, 1]), ``--input-pipeline
  --records 128 --batch-size 32``, and the raw-torch ResNet-50 step
  (``models/torch_resnet_ref.py``) at batch 256 beside the CLI's:
  ``vs_ref = ours / (0.70 x ref)``, printed, not asserted;
- variants_gate (f32, TF32 off): the ten conv and five pooling variants
  and the new ``nn`` options on the card against the same modules on
  the CPU: forward, input and parameter gradients within 1e-5 of the
  largest |value|, the pooling indices equal.

Then the table and shape layers and the text path (slice 12):

- table_gate (f32, TF32 off): the 58 table, shape, linear and container
  layers at the JAX sweep's arguments and inputs, parameters drawn from
  a seed, on the card against the CPU: the forward and every input and
  parameter gradient within 1e-5 of the largest |value|;
- text_train: the text-classification main
  (``bigdl_tpu_torch.example.textclassification.train``) on the card at
  the JAX test's sizes (validation accuracy above its 0.85 bar) and at
  news20's width (20 classes, 100-dim vectors, 2000 synthetic
  documents): ms a step, records/s, accuracy;
- text_lm (bf16): a BPE tokenizer trained on the synthetic news20 text;
  16 encoded documents of 128 tokens scored by the serving flagship's
  forward (8 flash launches) and continued by ``generate``, whose rows
  decode back to text beginning with their prompts'.

Then data- and sequence-parallel training (slice 13):

- distri_train: over a world-of-one NCCL group made with a FileStore,
  the training flagship (32 x 1024, bf16 over f32 masters, SGD with
  momentum) through ``Optimizer`` on a ``ShardedDataSet`` (the factory
  gives the ``DistriOptimizer``), 4 iterations in each mode ("sharded"
  on the f32 wire and on the bf16 wire, "allreduce") against the
  ``LocalOptimizer`` on the same weights and batch: parameters within
  ``DISTRI_F32_RTOL`` of the largest update (f32 wire) or, element by
  element, a bf16 rounding of the weight and of its update (bf16 wire),
  the unchanged weights shown to fail each allowance, ms a step against
  the local loop, peak memory, the NCCL
  calls, 8 flash launches an iteration; ring_one: the flash ring over
  that world of one (one causal launch, equal to the kernel's output);
  distri_main: ``lenet.train --distributed`` over it;
- ring_gate: four ranks on the one card through the launcher
  (``chip_smoke.py --ring-rank`` under ``tools.launch --procs 4
  --backend gloo``: NCCL refuses two ranks on one device; CUDA tensors
  staged through the host), each one 512-position block of the serving
  flagship's attention (B 4, H 8, H_kv 2, T 2048, d 64): the flash ring,
  the dense ring and Ulysses in bf16 and the flash ring in f32 (the
  long-context main's dtype), causal and not, forward and backward, held
  to one kernel call over all 2048 positions and to the plain version by
  phase 3's and phase 7's rules; flash launches by rank as reckoned
  (causal r + 1, total 10; non-causal 4 each, total 16; in each dtype);
- longcontext_train: ``python -m bigdl_tpu_torch.tools.launch --procs 4
  --backend gloo -m bigdl_tpu_torch.example.longcontext.train
  --seq-parallel 4`` at the serving flagship's widths (4 x 2048 tokens,
  f32, remat): its loss and gradient norm within ``LONGCONTEXT_RTOL`` of
  the same main in one process at every step and of a plain-attention
  step 1 computed here, and a ring blind to its past blocks (that step 1
  on rows cut into the 4 blocks) shown to fail that tolerance; then with
  ``--experts 4`` (losses finite and falling, the routing stats
  printed): s a step, tokens/s, peak memory by rank, the transport;
  flash launches 2 x 8 layers x 10 a step.

Then tensor-parallel serving (slice 14):

- tp_one: in the world of one over NCCL, the flagship sharded over a
  one-rank model mesh (``parallel/tp.py::shard_model``): its scoring
  forward equal to the whole model's (8 flash launches) and the engine
  on that mesh, rows equal to the unsharded engine's;
- tp_gate: two ranks on the one card through the launcher
  (``chip_smoke.py --tp-rank`` under ``tools.launch --procs 2 --backend
  gloo``), the serving flagship split on its heads (4 query heads and 1
  KV head a rank): the f32 sharded scoring forward (2 x 1024) through the
  flash kernel within ``TP_RTOL`` of the unsharded forward and within
  phase 3's f32 tolerance of the shard's plain attention, 8 launches a
  rank a forward; the bf16 forward (4 x 2048) at tp 2 timed against
  the whole model's; the engine at tp 2 (f32) dense, paged, int8 KV,
  int8 weights, speculative (the int8 clone as draft), with a host tier
  and through one preemption: rows equal to the lone ``generate``'s up
  to near ties and, under int8, to the unsharded engine's exactly; its
  ``stats()["mesh"]`` and ledger conservation;
- tp_serving: ``run_tp_comparison`` at tp 2 on a Poisson workload, in
  bf16 and in f32: TTFT and inter-token p50/p99 sharded and unsharded,
  the transport, messages an iteration, ``token_parity`` (asserted in
  f32; in bf16 each row that parts must part at a near tie of the
  unsharded model, ``BF16_NEAR_TIE``);
- sharded_ckpt: a two-rank ``DistriOptimizer`` with
  ``slots_backend="orbax"`` (each rank writes its slice of the slots)
  killed after a checkpoint and retried, its parameters equal to the
  uninterrupted run's bit for bit.

After obs_serving, the serving fleet (slice 16; workers are spawned
processes, each with its own CUDA context: this file's top level
touches no CUDA, since a spawned child re-imports it):

- fleet_gate (f32, TF32 off): two workers of the serving flagship from
  seed 0 behind a ``ReplicaSupervisor`` and a ``FleetFrontDoor`` on
  127.0.0.1:0; the server phase's 8 requests as SSE, each row held to a
  lone in-process engine (or a near tie of the lone ``generate``); an
  operator drain of r0 mid-flight (nothing lost, new traffic to r1, the
  ring restored by ``rejoin``); the merged ``/debug/fleet/trace`` (the
  processes front-door, r0, r1; no negative duration; hops summing to
  each total, which ``hop_breakdown`` makes so by taking the stream hop
  as the residual); a worker from seed 1 rejected by the parity rule;
- fleet_serving (bf16): ``run_fleet_comparison`` on the flagship through
  the door, an affinity and a round-robin leg of two workers each under
  a shared-prefix storm: client TTFT and inter-token p50/p99, the fleet
  hit rate, routing tallies, per-hop means, start-up seconds, clock
  offsets, a control round trip, each worker's peak memory (the replicas
  share the card: routing and prefix reuse, not scaling), every row held
  to a lone bf16 engine's replay (a row that parts does so at a near
  tie, ``BF16_NEAR_TIE``); then ``run_fleet_comparison(n_replicas=2)`` at
  JAX's recipe: token parity and a drain drill losing nothing;
- serve_example: ``example.serving.serve.main`` with its default steps
  and with ``--fleet 2`` on the card, rows held as the JAX test holds
  them and to the lone ``generate``.

After the tp phases, the graph container and the recurrent family
(slice 17; no kernel of the port: each phase counts the flash launches
from 0 and asserts 0, their sum is the kernels line's
``launches_sequence``):

- sequence_gate (f32, TF32 off): every class of the slice at the JAX
  sweep's widths and the mains' sequence lengths, card against CPU:
  forward and every input and parameter gradient within
  ``VARIANTS_RTOL`` of the largest |value|;
- graph_train: LeNet-5's and the autoencoder's graph forms equal to
  their Sequential forms (forward and one SGD step, deterministic
  cuDNN), the NCF main at its defaults above the majority baseline +
  0.1, NCF at MovieLens-1M's tables through the ``LocalOptimizer``;
- rnn_train: the SimpleRNN main at its default widths on a written
  corpus of 4500 words, the language model at PTB "small" widths (one
  epoch as given, then five: the loss must fall), each with a
  ``torch.profiler`` window over its train step;
- tree_train: the tree-LSTM sentiment main at the JAX test's sizes
  (root accuracy >= 0.7) and at the reference's widths (10 of its 30
  epochs), with a profiler window over one step of 4 trees.

Then the sparse stack and the detection heads (slice 18; no kernel of
the port, as in JAX: each phase counts the flash launches from 0 and
asserts 0, their sum is the kernels line's ``launches_sparse_detection``):

- sparse_gate (f32, TF32 off): every sparse class and a
  ``SparseMiniBatch`` on the card against the port on the CPU at the JAX
  tests' sizes, with padding, duplicates, an entry out of bounds and
  ``backward_start``: indices equal, forward and gradients within
  ``VARIANTS_RTOL`` of the largest |value|;
- sparse_train: a wide-and-deep ``Graph`` at the Criteo layout's widths
  (``SPARSE_TRAIN``) through the ``LocalOptimizer`` from sparse Samples:
  its first 3 losses within 1e-5 of the port's CPU run on the same
  weights, the loss falling, ms a step, records/s and a profiler window;
- detection_infer: SSD300's VOC head over its 8732 priors and Faster
  R-CNN VGG16's test-time Proposal, RoiPooling and output head, each
  held to the port on the CPU (equal kept sets, boxes within 1e-5, or a
  near tie under 1e-5 of the IoU threshold), with ms, launches and host
  syncs a call and RoiPooling's peak memory (under 2 GB).

Then the TF op set, its control flow and the wide-and-deep example
(slice 19; no kernel of the port, as in JAX: each phase counts the flash
launches from 0 and asserts 0, their sum is the kernels line's
``launches_ops_widedeep``):

- ops_gate (f32, TF32 off): every class of ``nn.ops`` and ``nn.tf_ops``
  on the card against the port on the CPU at the JAX tests' sizes, with
  ties, ids out of range, NaN and -0.0, saturating casts and values on a
  boundary: indices, masks, hash buckets, strings and specials equal,
  floats within ``VARIANTS_RTOL`` of the largest |value|; the random ops
  by range, truncation and moments; the CUDA state checked at the end;
  then BatchMatMul, DepthwiseConv2D, ResizeBilinearOp, TopK, SegmentSum
  and Dilation2D timed at ``OPS_TIMED`` (ms a call beside a bound);
- control_flow: a ``WhileLoop`` of 256 iterations whose body is a
  ``Graph`` (Linear 512 -> 512, Tanh over a 64 x 512 state) writing a
  ``TensorArray``, stacked states against the CPU run, host syncs (one a
  condition read) and ms an iteration; ``If``, ``Switch`` / ``Merge``
  (no sync) and ``Assign`` into a ``Variable`` an SGD step then updates;
- widedeep_train: the wide-and-deep main at its defaults (held-out
  accuracy above the majority baseline + 0.08), its first 3 losses
  against the CPU's on the same weights, a profiler window over one
  step, and the rows serialized as tf.Example records through
  ``ParseExample`` into the model on the card (the same predictions as
  the direct features; records/s of the parse).

Then the structured serializer and model interop (slice 20; the flagship
scores through the flash kernel after its round trip, the other phases
count 0; their sum is the kernels line's ``launches_serialize``):

- serialize_gate: the serving flagship (bf16, full width) through
  ``save_module`` from the card and ``load_module(device="cuda")``:
  logits over 4 x 2048 tokens equal to the original's, 8 flash launches
  a forward; ResNet-50 as ``bench.py`` builds it (NHWC, random BN state)
  through the same round trip, its eval forward at batch 32 equal;
  archive bytes, save and load seconds;
- interop_gate (f32, TF32 off): VGG-16's body at ImageNet widths through
  ``save_caffe`` from the card and ``load_caffe`` onto it (forward within
  ``INTEROP_RTOL``, the caffemodel the bytes of a CPU copy's export),
  the same body as a Lua Torch tree through the .t7 writer and
  ``load_torch``, an NHWC convolutional net's GraphDef equal to its CPU
  copy's;
- imageclass_predict: ``VggForCifar10``'s body exported to Caffe and the
  image-classification main over 64 seeded 32 x 32 images with
  ``--model-type caffe`` on the card: classes equal to the original
  body's ``predict_class`` but at near ties, which are printed.

Then TF import, the keras API and profiler hosting (slice 21; only the
generation requests of profiler_hosting may launch the flash kernel,
the other phases count 0; their sum is the kernels line's
``launches_tf_keras``):

- tf_import_gate (f32, TF32 off): VGG-16's body at ImageNet widths
  rebuilt NHWC with the zoo's weights, through ``save_tf`` from the card
  and ``load_tf(device="cuda")``: forward on 8 x 224 x 224 x 3 within
  ``INTEROP_RTOL``, GraphDef bytes and save / load seconds, the imported
  graph captured in a CUDA graph whose replay equals eager; each
  committed fixture of ``tests/data/torch_tf`` against TF's stored
  outputs, the TF1 while frame's host syncs an iteration;
- tf_predict_main: ``convert_model --from tf --to bigdl`` of
  tf_import_gate's VGG-16 GraphDef (an NCHW input Transpose added), then
  the image-classification main over 64 seeded 224 x 224 images with
  ``--model-type tf`` and ``bigdl``: equal classes, and equal to the
  original body's but at near ties, which are printed;
- tf_session_train: ``Session.train`` over the committed unfrozen TF1
  linear graph: mse < 0.01, ``w`` within 0.15 of the target;
- keras_train: Keras 1.2.2's mnist_cnn and imdb_lstm at their published
  widths on seeded synthetic data: ms a step, records/s, held-out
  accuracy against chance, ``predict_classes``; the mnist topology
  reloaded through ``DefinitionLoader`` predicts equal classes;
- profiler_hosting: 1 s captures asked for on another thread while a
  ``GenerationService`` at phase 6's server settings (a 500 ms window;
  one capture inside a window, one inside a batch) and a
  ``LocalOptimizer`` launch: CUDA kernel events in each trace, the
  session started on the launching thread.

Then the last modules (slice 22; the ``slice22_phases`` line, no flash
launch in any, ``launches_slice22``):

- dlframes_train: the reference's DLClassifierLeNet example, a
  ``DLClassifier`` over LeNet-5 fitted on rendered 28 x 28 digits in a
  pandas DataFrame: its first losses within ``DLFRAMES_LOSS_RTOL``
  of the same fit on the CPU, held-out accuracy from ``transform``, then
  ``make_udf`` (micro-batched) over the test rows from threads, classes
  equal to ``transform``'s but at near ties;
- bucket_io: the file layer's ``_epath`` seam over a local directory
  (a ``pathlib`` path; the card has no etils): sync
  and async checkpoint triggers of a LocalOptimizer on the card, the
  flagship's module, a sharded checkpoint (meta last), each loaded back
  equal to the bit, the sharded one also to the same checkpoint written
  locally;
- inside the --tp-rank launch (two ranks over gloo, the records printed
  here): seq_decode, the flagship (f32) decoding 32 tokens after a
  1100-token prompt with its 2048-position caches split over a
  ``("seq", 2)`` mesh, tokens held to the unsplit caches' by the near-tie
  rule; int8_2d, the int8 clone under 2-D rules on a ``("data", 2) x
  ("model", 1)`` mesh, forward and tokens equal to the unsharded clone's;
  moe_mesh, the flagship with 4 experts on the model mesh, forward within
  ``TP_RTOL`` and tokens held; convergence, the JAX package's LeNet-5
  (MNIST idx round trip, 360 sharded steps, held-out >= 0.97) and
  ResNet-20 (40 sharded steps, accuracy > 0.85, loss < 0.8) cases
  through the ``DistriOptimizer`` with ``parameter_sync="sharded"``.

Earlier lines are one JSON object each; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
CUDA is not available or the port cannot be imported.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 on
# CUDA cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(vocab_size=32000, embed_dim=512, num_heads=8,
                num_kv_heads=2, num_layers=8, max_len=2048, use_rope=True,
                use_flash=True)

# kernel vs plain version: an element may be off by rtol times the sum of
# its own |ref| and the RMS of its reference row. The row term scales the
# absolute allowance to what that row holds: a row averaging n keys has an
# output RMS of about sqrt(e/n), 0.036 at n = 2048, so a fixed atol would
# hide errors of that size in late rows. bf16 outputs round to 8 bits of
# mantissa and the kernel rounds P to bf16 for the tensor cores; f32 as the
# JAX flash test; lse is f32 math on both sides
RTOL = {"bfloat16": 2e-2, "float32": 2e-4}
LSE_ATOL = 1e-4
# model-level bf16 agreement (flash vs dense path, decode vs teacher-forced
# forward): max |diff| relative to the largest |logit|
LOGIT_RTOL = 5e-2
# the training flagship of the JAX package (models/perf.py:79-149)
TRAIN = dict(vocab=32000, embed_dim=512, layers=8, heads=8, seq_len=1024)
TRAIN_BATCH = 32
# the flash gradient against autograd through the plain forward: each
# gradient row (over the head dim) may be off, in L2 norm, by rtol times
# the sum of its reference row's norm and the RMS of all the reference's
# row norms. Rows, not elements: the backward forms D = rowsum(dO * O)
# from the bf16 output the kernel normalized with f32 sums of unrounded
# P, as every flash backward does, where autograd differentiates the
# unrounded function; in rows that see few keys dP - D cancels and that
# rounding leaves an error of the size of a typical gradient entry in a
# row near 0, whose largest element over millions of rows is an extreme
# value (an element-wise form, rtol * (|ref| + RMS of the row + RMS of
# the gradient), read 1.34 at B = 32 on the card where B = 4 passed).
# Shown, at the training shape, to reject a gradient whose reference
# dropped one 64-key V tile
BWD_RTOL = {"bfloat16": 5e-2, "float32": 2e-4}
# f32 flash vs dense model gradients, TF32 off: per leaf, max |diff| over
# the leaf's max |dense grad| (the kernel's f32 sums run in another order)
GRAD_RTOL = 1e-3
# flash backward edge cases beside the training shape: (B, H, H_kv, t, tk,
# d), causal, dtype: GQA, t < tk, dead rows (t > tk), a ragged length,
# non-causal with t != tk, f32
BWD_CASES = [
    ((4, 8, 2, 512, 512, 64), True, "bfloat16"),
    ((2, 8, 2, 256, 1024, 64), True, "bfloat16"),
    ((2, 8, 2, 512, 256, 64), True, "bfloat16"),
    ((2, 8, 2, 1000, 1000, 64), True, "bfloat16"),
    ((2, 8, 2, 300, 700, 64), False, "bfloat16"),
    ((2, 8, 8, 512, 512, 64), True, "float32"),
]
# the backward kernels' edges beside BWD_CASES: (B, H, H_kv, t, tk, d),
# causal, dtype, cotangent ("out", "out_lse", "lse" alone, or "sum": the
# stride-0 cotangent of out.sum()): d 40 and d 128 (zero-padded to 64 and
# 128), GQA 4 without the mask, the stride-0 cotangent, the lse cotangent
# alone, one query row against 300 keys, and f32 at d 40 and d 128
BWD_KERNEL_CASES = [
    ((2, 8, 2, 300, 300, 40), True, "bfloat16", "out_lse"),
    ((2, 4, 2, 512, 512, 128), True, "bfloat16", "out_lse"),
    ((2, 8, 2, 1024, 1024, 64), False, "bfloat16", "out"),
    ((2, 8, 8, 1024, 1024, 64), True, "bfloat16", "sum"),
    ((2, 8, 2, 512, 512, 64), True, "bfloat16", "lse"),
    ((2, 8, 2, 1, 300, 64), True, "bfloat16", "out_lse"),
    ((2, 4, 1, 300, 300, 40), True, "float32", "out_lse"),
    ((2, 4, 2, 200, 200, 128), False, "float32", "lse"),
]
# the vision path's f32 gate (TF32 off): logits of the card's NHWC and
# NCHW forwards and of the CPU's may differ by this much of the largest
# |logit| (cuDNN picks its own f32 algorithms and sum orders; H100 runs
# read 2.2e-7 to 3.3e-7), and the loss of a training step by this much
# of its value
VISION_RTOL = 1e-5
# the update of one f32 training step at batch 4 (all parameters as one
# vector): ||d_card - d_cpu|| / ||d_cpu||. The step is ill-conditioned:
# 53 training-mode BNs over 4 images amplify rounding, so the same step
# in the NCHW and NHWC layouts, both on the CPU, differs by about 1.4e-2
# in this norm; a wrong layer gives an error of order 1
UPDATE_RTOL = 5e-2
# new running statistics: max |diff| over the leaf's largest |value|
# (H100 runs read 1.13e-6)
STATS_RTOL = 1e-5
# ResNet-50 at 224 x 224: forward FLOPs per image (bench.py:25), x 3 for
# a training step (bench.py:26)
RESNET50_TRAIN_FLOPS = 4.09e9 * 3.0
VISION_BATCH = 256
# the bf16 eval forward against the f32 one on the same weights
EVAL_BF16_RTOL = 5e-2

# the flash kernel's flagship kernel_ms before its redesign for Hopper
# (the WMMA version, H100 80GB HBM3 at 700 W): a constant from PERF.md,
# printed for comparison and never measured here
PRIOR_MS = 0.381

# a served greedy row may differ from a lone ``generate`` only where the
# lone run's top two logits are this close at the first difference (f32
# GEMMs of another batch shape can flip such an argmax; nothing else can)
NEAR_TIE = 1e-4
# the server phase's 8 requests: prompt lengths and new tokens
SERVER_LENGTHS = [100, 128, 193, 200, 224, 241, 250, 256]
SERVER_NEWS = [32, 24, 32, 16, 32, 32, 20, 32]
# the engine_serving phase: a Poisson workload through the engine and
# through GenerationService (bf16 flagship)
ENGINE_SERVING = dict(n_requests=16, rate_hz=20.0, max_slots=8,
                      prefill_chunk=64, prefill_rows=4, max_batch=8,
                      prompt_lens=(64, 512), decode_lens=(16, 128), seed=0)
# loop iterations in the engine's steady-decode profile windows
PROFILE_ITERATIONS = 16
# the paged and speculative phases: 16-token pages, 4 proposals a round
PAGE_SIZE = 16
SPEC_GAMMA = 4
# draft (a): an unrelated small model over the flagship's vocabulary, from
# its own seed (its proposals are mostly rejected)
DRAFT = dict(vocab_size=32000, embed_dim=256, num_heads=4, num_kv_heads=2,
             num_layers=2, max_len=2048, use_rope=True)
# paged_serving: paged against dense KV at equal bytes (bf16 flagship)
PAGED_SERVING = dict(n_requests=16, rate_hz=200.0, dense_slots=2,
                     paged_slots=8, page_size=PAGE_SIZE, prefill_chunk=64,
                     prefill_rows=4)
# spec_serving: draft (a) proposing against plain decode (bf16 flagship)
SPEC_SERVING = dict(n_requests=8, rate_hz=30.0, max_slots=8,
                    prefill_chunk=64, prefill_rows=4, gamma=SPEC_GAMMA)
# the self-draft's proposals equal the target's argmax but for f32 GEMMs
# of another shape flipping a near tie
SELF_ACCEPT_MIN = 0.99
# quant_gate: the int8 Linear at the flagship widths (in, out: the fused
# qkv, the output projection, fc1, fc2), at a decode step's rows (4, 8),
# past _int_mm's 16-row floor (24) and at a prefill round's (256)
QUANT_LINEAR_SHAPES = [(512, 768), (512, 512), (512, 2048), (2048, 512)]
QUANT_ROWS = (4, 8, 24, 256)
# the int8 convolution (B, C_in, H = W, C_out, k), 3x3, SAME: K = C_in * 9
# = 576 keeps every f32 partial sum of codes exact (127^2 * 576 < 2^24);
# K = 4608 (ResNet-50's last stage) does not, and is reported
QUANT_CONV_SHAPES = [(2, 64, 56, 64, 3), (2, 512, 7, 512, 3)]
# quant_serving: int8 against full precision, with the int8 draft (bf16)
QUANT_SERVING = dict(n_requests=8, rate_hz=30.0, max_slots=8,
                     prefill_chunk=64, prefill_rows=4, gamma=SPEC_GAMMA)
# tier_serving: a 2-row prefix pool under 2 and 8 round-robin templates of
# 256 tokens, host tier against device only (bf16)
TIER_SERVING = dict(working_sets=(2, 8), device_rows=2,
                    requests_per_template=3, rate_hz=40.0, max_slots=4,
                    prefill_chunk=64, prefill_rows=2, template_len=256)
# qos_gate: the preempted victim's new tokens (it must still be decoding
# when the urgent request arrives), the bound on a crashed engine's
# handles failing, the frozen iterations, and the ledger's conservation
# (tenants' device-seconds against the busy total, unrounded sums: they
# differ only by float summation order)
QOS_VICTIM_NEW = 96
FAULT_WAIT_S = 10.0
FREEZE_ITERATIONS = 8
CONSERVATION_RTOL = 1e-9
# qos_serving: run_qos_storm at the JAX package's defaults (bf16)
QOS_SERVING = dict(n_requests=24, rate_hz=20.0, max_slots=2,
                   prefill_chunk=8, prefill_rows=2, n_greedy=3, seed=0)

# beam_serving: the serving flagship's beam search (bf16)
BEAM = dict(prompts=4, prompt_len=128, new=64, beams=4)
# the best beam's summed log-prob (bf16 logits of the KV-cache decode)
# against an f32 teacher-forced rescoring of its tokens on the same
# weights, relative: bf16 rounds each logit to 8 bits of mantissa and
# the 64 terms' errors add up
BEAM_SCORE_RTOL = 2e-2
# a best beam's normalized score and the greedy row's come from runs of
# other batch shapes (16 rows, 4 rows): equal sequences may differ by
# their bf16 rounding, far below this
BEAM_RANK_ATOL = 1e-3
# predict_serving: PredictionService over the serving flagship (bf16),
# and LocalPredictor over a ResNet-50 eval batch (f32)
PREDICT_SERVING = dict(clients=16, per_client=2, tokens=512, max_batch=8,
                       timeout_ms=20.0, resnet_batch=256)
# checkpoint_train: the training flagship through the LocalOptimizer,
# async checkpoints after iterations 1, 3 and 5 of 8
CHECKPOINT_TRAIN = dict(iterations=8, last_ckpt=6, lr=1e-3)
# a resumed iteration's loss against the uninterrupted run's: the same
# inputs, weights, slots and state on the same card give the same loss
# but for a reduction whose order the card does not fix
RESUME_RTOL = 1e-3
# optim_criterion_gate (f32, TF32 off): card against CPU, max |diff| over
# max |reference| per tensor; five steps of a small model, or one
# criterion's value and input gradient
OPTIM_TOL = 1e-4
CRITERION_TOL = 1e-5

# slice 10, the image zoo. zoo_gate (f32, TF32 off) holds each model on
# the card to the port on the CPU in f64: eval outputs within
# ZOO_EVAL_RTOL of the largest |output|, one SGD step's update within
# ZOO_UPDATE_RTOL in L2 over all parameters: VGG-16's f32 step itself
# reads 8.3e-4 (the CPU) and 8.8e-4 (the card, H100 80GB HBM3 at 700 W)
# from the f64 step in this norm, where a wrong layer reads order 1.
# MobileNet's training-mode
# step is ill-conditioned (27 BNs, each normalizing over 8 images): the
# port's own f32 step on the CPU reads 6.5e-3 (NCHW) and 6.2e-3 (NHWC)
# from its f64 step, where VGG CIFAR's (14 BNs at batch 32) reads
# 1.0e-3, so MobileNet is held to vision_gate's UPDATE_RTOL; the CPU's
# f32 reading is printed beside the card's for every model
ZOO_GATE = dict(batch=2, vgg_cifar_batch=32, mobilenet_batch=8,
                autoencoder_batch=8)
ZOO_EVAL_RTOL = 1e-4
ZOO_UPDATE_RTOL = 2e-3
# zoo_train: run_perf at full width, bf16 over f32 masters (model, batch,
# format), warm-up and timed steps; the published multiply-accumulates of
# one 224 x 224 image's forward (VGG-16 ~15.5 G, GoogLeNet ~1.5 G,
# MobileNetV1 ~569 M), which the analytic count must match within
# MACS_RTOL
ZOO_TRAIN = [("vgg16", 64, "NCHW"), ("inception_v1", 128, "NCHW"),
             ("mobilenet", 256, "NHWC")]
ZOO_TRAIN_STEPS = (3, 10)
PUBLISHED_MACS = {"vgg16": 15.5e9, "inception_v1": 1.5e9,
                  "mobilenet": 569e6}
MACS_RTOL = 0.1
# zoo_mains: the data each main reads (one epoch each at these sizes)
ZOO_MAINS = dict(cifar_images=512, mnist_images=1024, batch=64,
                 folder_per_class=64, folder_side=256, inception_batch=32)
# input_pipeline: run_input_pipeline_perf's JAX defaults
PIPELINE = dict(batch_size=64, n_records=512, image=256, crop=224)

# slice 13. distri_train: the training flagship through the
# DistriOptimizer at a world of one (NCCL), each mode against the
# LocalOptimizer on the same weights and batch, bf16 compute over f32
# masters. The f32 wire does the local step's arithmetic (a reduce-scatter
# and an all-gather over one rank copy), so its parameters may differ only
# by the run-to-run order of the card's gradient sums: DISTRI_F32_RTOL of
# the largest update. The bf16 wire rounds each gradient to bf16 (to
# nearest: 2^-8 of it at most, so 2^-8 of the update while the gradients
# keep their signs) and the updated f32 masters to bf16 on the all-gather
# (2^-8 of the weight): element by element, 2^-8 |w| + 2^-7 |dw| of the
# local run's weight w and update dw. Each mode also shows that the
# unchanged weights would fail its allowance
DISTRI_TRAIN = dict(iterations=4, lr=1e-3, momentum=0.9)
DISTRI_MODES = [("sharded_f32_wire", "sharded", None),
                ("sharded_bf16_wire", "sharded", "bfloat16"),
                ("allreduce", "allreduce", None)]
DISTRI_F32_RTOL = 1e-3
# distri_main: lenet.train --distributed at the world of one
DISTRI_MAIN = dict(images=1024, batch=128, iterations=8)
# ring_gate: the serving flagship's attention over 4 ranks on the card,
# in bf16 and in f32 (the long-context main's dtype)
RING = dict(b=4, h=8, h_kv=2, t=2048, d=64, ranks=4)
RING_TIMEOUT_S = 600
# longcontext_train: the long-context main at the serving flagship's
# widths, 4 sequence-parallel ranks against one process; f32, so the two
# runs differ only by the order of their sums (the ring's lse merge, the
# all-reduce over the ranks). Held at every step: the loss and the L2 norm
# of the averaged gradient, each within LONGCONTEXT_RTOL of the one-process
# run's, and at step 1 of a plain-attention run in this process. The
# tolerance sits between that reading and a broken ring's: the same step
# with every block blind to the blocks before it (the ring without its
# past-block launches), which the script computes and must see rejected
LONGCONTEXT = dict(ranks=4, steps=3, vocab=32000, embed=512, heads=8,
                   kv_heads=2, layers=8, batch=4, seq_len=2048,
                   timeout_s=900)
LONGCONTEXT_RTOL = 1e-5

# tensor-parallel serving (slice 14): two ranks sharing the card over
# gloo, the serving flagship split on its heads (4 query heads and 1 KV
# head a rank), f32 for the checks and bf16 for the Poisson comparison
TP = dict(ranks=2, gate_batch=2, gate_seq=1024, score_batch=4,
          score_seq=2048, slots=4, chunk=64, page=16, gamma=4)
TP_REQS = [(96, 12), (160, 8), (200, 12), (64, 16)]  # (prompt, new)
TP_SERVING = dict(n_requests=8, rate_hz=20.0, max_slots=8,
                  prefill_chunk=64, prefill_rows=2, seed=0)
TP_CKPT = dict(iterations=10, every=3, fault_at=8)
TP_TIMEOUT_S = 900
# the sharded scoring forward against the unsharded one (f32: only the
# row-parallel sums' order differs)
TP_RTOL = 1e-5
# obs_serving (slice 15): the flagship engine with every observability
# hook on, 16 Poisson requests at 20/s from two tenants, the HTTP routes
# held to the engine's numbers, a 1 s /debug/profile taken under load, a
# chaos crash; then the overhead A/B (on, off, off, on) on one seeded
# workload, PredictionService scoring and a 3-step LocalOptimizer run
OBS_SERVING = dict(n_requests=16, rate_hz=20.0, max_slots=8,
                   prefill_chunk=64, prefill_rows=4, prompt_lens=(64, 512),
                   decode_lens=(16, 128), seed=5, interval_s=0.25,
                   profile_s=1.0, tenants=("alpha", "beta"))
OBS_PREDICT = dict(clients=8, tokens=1024, max_batch=4, timeout_ms=20.0)
# the fleet (slice 16): spawned flagship workers behind the front door;
# the affinity key is the engine's 64-token prefill chunk
FLEET = dict(chunk=64, rpc_timeout=60.0,
             engine=dict(max_slots=4, prefill_chunk=64, prefill_rows=2))
# fleet_serving's shared-prefix storm (bf16): 4 templates of 512 tokens
# over 2 s, so most requests arrive after one of their template finished
# (a flagship request lives 0.3-1 s); each replica's prefix pool holds
# its affinity share of the templates + 1 (run_fleet_comparison's rule)
FLEET_SERVING = dict(n_requests=16, rate_hz=8.0, n_templates=4,
                     template_len=512, tail_lens=(4, 32),
                     decode_lens=(8, 32), seed=3, max_slots=8,
                     prefill_chunk=64, prefill_rows=4)
# the training flagship's widths (vocab, embed, heads, seq, batch) at a
# reduced depth of 2 layers
OBS_TRAIN = dict(layers=2, iterations=3, lr=1e-3)
# the loop-phase fractions are six figures rounded to 1e-6 each
LOOP_FRACTION_TOL = 6 * 0.5e-6
# bf16 rows may part where the unsharded model's two candidate tokens
# sit within this of each other (4 bf16 ulps of a logit in [1, 2)): a
# row-parallel sum rounds to bf16 differently from the whole GEMM in
# about 1e-3 of its elements (scripts/torch_tp_rounding.py), which can
# tip such a tie; f32 rows must be equal
BF16_NEAR_TIE = 2 ** -5

# the last modules (slice 22): dlframes_train fits the reference's
# DLClassifierLeNet example (LeNet-5 through a DLClassifier over a
# DataFrame) on rendered 28 x 28 digits, its first losses held to the
# same fit on the CPU; bucket_io writes checkpoints to an object-store
# path (the file layer's seam on a local directory); the --tp-rank
# launch adds the convergence cases, the sequence-sharded decode of the
# serving flagship and the 2-D int8 and MoE shards
# 257 test rows at batch 64: transform's tail chunk is a lone row
DLFRAMES = dict(train=1536, test=257, batch=64, epochs=15, lr=0.05,
                first_iters=4, udf_threads=8)
DLFRAMES_LOSS_RTOL = 1e-4
# a near tie of the udf's micro-batched logits against transform's
DLFRAMES_NEAR_TIE = 1e-3
SEQ_DECODE = dict(batch=2, prompt=1100, new=32, max_len=2048)
# the split caches' logits against the unsplit caches', up to each row's
# first parted token: the merge only reorders f32 sums (2.03e-6 measured
# on the H100), where a wrongly weighted block moves them by far more
SEQ_DECODE_LOGIT_ATOL = 2e-5
SLICE22_CHECK = dict(batch=2, seq=512, new=16, experts=4)
CONVERGENCE = dict(lenet_train=1536, lenet_test=256, lenet_steps=360,
                   lenet_batch=64, resnet_per_class=24, resnet_steps=40,
                   resnet_batch=80)
BUCKET = dict(iterations=5, every=2)


#: the script's start, for each phase line's ``t_s`` (its timeline)
_T0 = time.monotonic()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.monotonic() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` in ms, called eagerly with an event
    recorded before and after each call (events and stream fetched before
    the loop): where the host takes longer to issue a call than the card
    to run it, this is the host's time."""
    for _ in range(warmup):
        fn()
    stream = torch.cuda.current_stream()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in pairs:
        s.record(stream)
        fn()
        e.record(stream)
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def graph_ms(torch, fn, calls: int = 20, replays: int = 5,
             stream=None) -> float:
    """The card's time for one call of ``fn`` in ms: ``calls`` calls
    captured in one CUDA graph (on ``stream``, where given), the median
    replay time over ``calls``, so no host time between launches is
    counted."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    g.replay()
    times = []
    for _ in range(replays):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / calls)
    del g
    return statistics.median(times)


def flash_bound(b, h, h_kv, t, tk, d, dtype: str, causal: bool):
    """(least ms on an H100, "operations" or "bytes"): the two products
    over the (row, key) pairs this mask keeps, against each input read
    once and each output written once."""
    off = tk - t
    pairs = (sum(max(0, min(tk, r + off + 1)) for r in range(t))
             if causal else t * tk)
    flops = 4 * d * pairs * b * h
    esz = 2 if dtype == "bfloat16" else 4
    nbytes = esz * (2 * b * h * t * d + 2 * b * h_kv * tk * d) + 4 * b * h * t
    ms_ops = flops / PEAK_FLOPS[dtype] * 1e3
    ms_bytes = nbytes / PEAK_BYTES * 1e3
    return max(ms_ops, ms_bytes), ("operations" if ms_ops >= ms_bytes
                                   else "bytes")


def tol_excess(torch, out, ref, rtol: float) -> float:
    """The largest |out - ref| / (rtol * (|ref| + RMS of ref's row)) over
    the elements: the check passes below 1. A row of zeros (a dead row)
    allows no error at all."""
    o, r = out.float(), ref.float()
    allow = rtol * (r.abs() + r.pow(2).mean(-1, keepdim=True).sqrt())
    err = (o - r).abs()
    ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
    return ratio.max().item()


def grad_excess(torch, grad, ref, rtol: float) -> float:
    """The largest ||grad row - ref row|| / (rtol * (||ref row|| + RMS of
    ref's row norms)) over the rows (the last dim): the check passes
    below 1."""
    ref_norm = ref.float().norm(dim=-1)
    err = (grad.float() - ref.float()).norm(dim=-1)
    allow = rtol * (ref_norm + ref_norm.pow(2).mean().sqrt())
    ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
    return ratio.max().item()


#: the backward kernels, by the names the profiler gives them
BWD_KERNEL_NAMES = ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq")
#: the backward kernels' calls on the training paths by phase, for the
#: kernels line; each phase counts from 0 and asserts its reckoning
BWD_LAUNCHES: dict = {}


def bwd_start(fa) -> None:
    """Count a phase's backward-kernel calls, and its calls of the plain
    backward on CUDA tensors, from 0."""
    fa.backward_launches = 0
    fa.plain_backward_cuda_calls = 0


def bwd_end(fa, phase: str, want: int) -> int:
    """The phase's backward-kernel calls, asserted to be ``want`` with no
    plain backward on a CUDA tensor, kept for the kernels line."""
    got, plain = fa.backward_launches, fa.plain_backward_cuda_calls
    assert plain == 0, (phase, "the plain backward ran on the card", plain)
    assert got == want, (phase, "flash backward launches", got, want)
    BWD_LAUNCHES[phase] = got
    return got


def check_flash(torch, fa, shape, causal, dtype, with_library,
                mutant=False):
    """The kernel against its plain version at one shape, timed. With
    ``mutant``, also shows that the tolerance rejects an output whose
    64-key V tile at tk/2 was dropped (the plain version run on V with
    that tile zeroed)."""
    b, h, h_kv, t, tk, d = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = (torch.randn(sz, device="cuda", generator=g).to(dtype)
               for sz in ((b, h, t, d), (b, h_kv, tk, d), (b, h_kv, tk, d)))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal)
    name = str(dtype).replace("torch.", "")
    rtol = RTOL[name]
    err = (out.float() - ref_out.float()).abs()
    excess = tol_excess(torch, out, ref_out, rtol)
    dead = ref_lse <= fa.NEG_INF / 2
    lse_err = (lse - ref_lse)[~dead].abs().max().item() if (~dead).any() \
        else 0.0
    assert excess <= 1.0, (shape, name, causal, err.max().item(), excess)
    assert torch.equal(lse <= fa.NEG_INF / 2, dead), "dead rows differ"
    assert (out.float()[dead.unsqueeze(-1).expand_as(out)] == 0).all()
    assert lse_err <= LSE_ATOL, (shape, lse_err)
    mutant_excess = None
    if mutant:
        v_bad = v.clone()
        v_bad[:, :, tk // 2:tk // 2 + fa.BLOCK_K] = 0
        bad_out, _ = fa.flash_attention_reference(q, k, v_bad, causal)
        mutant_excess = tol_excess(torch, bad_out, ref_out, rtol)
        assert mutant_excess > 1.0, ("the tolerance passes an output that "
                                     "dropped a kv tile", mutant_excess)
        del v_bad, bad_out
    def kernel():
        return fa.flash_attention_with_lse(q, k, v, causal)

    ms, device_ms = time_ms(torch, kernel), graph_ms(torch, kernel)
    plain_ms = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, causal), warmup=1, iters=5)
    library_ms = library_device_ms = None
    if with_library:
        import torch.nn.functional as F

        # top-left causal alignment equals the port's last-query alignment
        # only at t == tk; timed as a yardstick, never called by the port
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)

        library_ms = time_ms(torch, library)
        library_device_ms = graph_ms(torch, library)
    bound_ms, bound_by = flash_bound(b, h, h_kv, t, tk, d, name, causal)
    rec = {"phase": "kernel", "kernel": "flash_attention_fwd",
           "shape": {"B": b, "H": h, "H_kv": h_kv, "t": t, "tk": tk,
                     "d": d},
           "dtype": name, "causal": causal,
           "max_abs_err": err.max().item(),
           "median_abs_ref": ref_out.float().abs().median().item(),
           "tol": {"rtol": rtol, "allowance": "rtol*(|ref|+rms(ref row))"},
           "max_err_over_tol": excess,
           "dropped_tile_err_over_tol": mutant_excess,
           "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL,
           "dead_rows": int(dead.sum()), "kernel_ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_device_ms": library_device_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    return rec


def flash_bwd_bound(b, h, h_kv, t, tk, d, dtype: str, causal: bool):
    """(least ms on an H100, "operations" or "bytes") of the backward:
    five products (S again, dP, dQ, dK, dV) over the kept (row, key)
    pairs, against q, k, v, out, dout and lse read once and dq, dk, dv
    written once."""
    off = tk - t
    pairs = (sum(max(0, min(tk, r + off + 1)) for r in range(t))
             if causal else t * tk)
    flops = 10 * d * pairs * b * h
    esz = 2 if dtype == "bfloat16" else 4
    nbytes = (esz * (4 * b * h * t * d + 4 * b * h_kv * tk * d)
              + 4 * b * h * t)
    ms_ops = flops / PEAK_FLOPS[dtype] * 1e3
    ms_bytes = nbytes / PEAK_BYTES * 1e3
    return max(ms_ops, ms_bytes), ("operations" if ms_ops >= ms_bytes
                                   else "bytes"), flops


def check_flash_backward(torch, fa, shape, causal, dtype, cotangent="out_lse",
                         timed=False, fused=False):
    """The Function's forward (out and lse, against the plain forward)
    and its gradients (kernel forward, backward kernels) for dq, dk, dv,
    held two ways: against autograd through the plain forward, and
    against the plain backward ``flash_attention_backward_reference`` on
    the same saved (q, k, v, out, lse) and cotangents. ``cotangent``: "out"
    (out's only), "out_lse" (both), "lse" (lse's only: the Function gets
    None for out) or "sum" (the cotangent of ``out.sum()``: one expanded
    scalar, every stride 0); with ``fused``, q, k and v are strided views
    of one (B, t, (H + 2·H_kv)·d) projection, as ``MultiHeadAttention``
    passes them; with ``timed``, the dropped-tile mutant, the bit-equality
    of two backward calls, and the backward's times beside the plain
    backward's, SDPA's and its bound. Returns the phase's record."""
    import torch.nn.functional as F

    b, h, h_kv, t, tk, d = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + 1)
    if fused:
        assert t == tk, shape
        qkv = torch.randn((b, t, (h + 2 * h_kv) * d), device="cuda",
                          generator=g).to(dtype).requires_grad_(True)
        cuts = (0, h * d, (h + h_kv) * d, (h + 2 * h_kv) * d)
        q, k, v = (qkv[..., lo:hi].unflatten(-1, (-1, d)).transpose(1, 2)
                   for lo, hi in zip(cuts, cuts[1:]))
        assert not q.is_contiguous()
    else:
        q, k, v = (torch.randn(sz, device="cuda", generator=g).to(dtype)
                   .requires_grad_(True)
                   for sz in ((b, h, t, d), (b, h_kv, tk, d),
                              (b, h_kv, tk, d)))
    d_out = torch.randn((b, h, t, d), device="cuda", generator=g).to(dtype)
    d_lse = torch.randn((b, h, t), device="cuda", generator=g)
    if cotangent == "sum":
        d_out = torch.ones((), device="cuda", dtype=dtype).expand(b, h, t, d)
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    assert fa.launches == before + 1 and out.grad_fn is not None
    outs, cots = {"out": ((out,), (d_out,)), "sum": ((out,), (d_out,)),
                  "out_lse": ((out, lse), (d_out, d_lse)),
                  "lse": ((lse,), (d_lse,))}[cotangent]
    before = fa.backward_launches, fa.plain_backward_cuda_calls
    grads = torch.autograd.grad(outs, (q, k, v), cots)
    assert (fa.backward_launches, fa.plain_backward_cuda_calls) == (
        before[0] + 1, before[1]), "the backward did not run the kernels"
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    ref_out, ref_lse = fa.flash_attention_reference(qr, kr, vr, causal)
    ref_outs = {"out": (ref_out,), "sum": (ref_out,),
                "out_lse": (ref_out, ref_lse), "lse": (ref_lse,)}[cotangent]
    # lse does not depend on v: its gradient through lse alone is zero
    ref = torch.autograd.grad(ref_outs, (qr, kr, vr), cots,
                              allow_unused=True, materialize_grads=True)
    name = str(dtype).replace("torch.", "")
    # the forward the backward starts from, held as phase 3 holds it
    out_excess = tol_excess(torch, out.detach(), ref_out.detach(),
                            RTOL[name])
    dead = ref_lse <= fa.NEG_INF / 2
    lse_err = ((lse - ref_lse).detach()[~dead].abs().max().item()
               if (~dead).any() else 0.0)
    assert out_excess <= 1.0, (shape, name, "out", out_excess)
    assert torch.equal(lse <= fa.NEG_INF / 2, dead), "dead rows differ"
    assert lse_err <= LSE_ATOL, (shape, name, "lse", lse_err)
    rtol = BWD_RTOL[name]
    excess = {f"d{n}": grad_excess(torch, a, r, rtol)
              for n, a, r in zip("qkv", grads, ref)}
    errs = {f"d{n}": (a.float() - r.float()).abs().max().item()
            for n, a, r in zip("qkv", grads, ref)}
    assert all(a.dtype == x.dtype and a.shape == x.shape
               for a, x in zip(grads, (q, k, v)))
    assert max(excess.values()) <= 1.0, (shape, name, errs, excess)
    # the kernels against their plain version on the same saved tensors
    scale = 1.0 / d ** 0.5
    q0, k0, v0 = q.detach(), k.detach(), v.detach()
    o0, l0 = out.detach(), lse.detach()
    g_out = None if cotangent == "lse" else d_out
    g_lse = d_lse if cotangent in ("lse", "out_lse") else None
    plain = fa.flash_attention_backward_reference(
        q0, k0, v0, o0, l0, torch.zeros_like(o0) if g_out is None else g_out,
        causal, scale, g_lse)
    plain_excess = {f"d{n}": grad_excess(torch, a, r, rtol)
                    for n, a, r in zip("qkv", grads, plain)}
    plain_errs = {f"d{n}": (a.float() - r.float()).abs().max().item()
                  for n, a, r in zip("qkv", grads, plain)}
    assert max(plain_excess.values()) <= 1.0, (shape, name, plain_errs,
                                               plain_excess)
    assert (grads[0].float()[dead.unsqueeze(-1).expand_as(grads[0])]
            == 0).all(), "a dead row got a gradient"
    mutant = None
    if timed:
        # the reference with one 64-key V tile zeroed must fail the check
        v_bad = vr.detach().clone()
        v_bad[:, :, tk // 2:tk // 2 + fa.BLOCK_K] = 0
        qb, kb, vb = (x.detach().clone().requires_grad_(True)
                      for x in (qr, kr, v_bad))
        bad_outs = fa.flash_attention_reference(qb, kb, vb, causal)
        bad = torch.autograd.grad(
            {"out": bad_outs[:1], "sum": bad_outs[:1], "out_lse": bad_outs,
             "lse": bad_outs[1:]}[cotangent], (qb, kb, vb), cots)
        mutant = {f"d{n}": grad_excess(torch, a, r, rtol)
                  for n, a, r in zip("qk", bad, ref)}
        assert min(mutant.values()) > 1.0, ("the tolerance passes a "
                                            "gradient that dropped a kv "
                                            "tile", mutant)
        del v_bad, qb, kb, vb, bad, bad_outs
    del ref, qr, kr, vr, ref_out, ref_lse, plain
    rec = {"phase": "flash_backward",
           "shape": {"B": b, "H": h, "H_kv": h_kv, "t": t, "tk": tk,
                     "d": d}, "dtype": name, "causal": causal,
           "inputs": ("views of a fused qkv projection" if fused
                      else "contiguous"),
           "cotangent": cotangent, "lse_cotangent": g_lse is not None,
           "out_err_over_tol": out_excess, "out_rtol": RTOL[name],
           "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL,
           "max_abs_err": errs, "max_err_over_tol": excess,
           "vs_plain_backward_max_abs_err": plain_errs,
           "vs_plain_backward_err_over_tol": plain_excess,
           "dead_rows": int(dead.sum()),
           "tol": {"rtol": rtol, "allowance": "per row: ||err|| <= rtol*("
                   "||ref row||+rms of ref row norms)",
                   "reference": "autograd through flash_attention_reference"
                                "; and flash_attention_backward_reference "
                                "on the same saved tensors"},
           "dropped_tile_err_over_tol": mutant}
    if timed:
        def kernel_backward():
            return fa._launch_backward(q0, k0, v0, o0, l0, g_out, g_lse,
                                       causal, scale)

        def plain_backward():
            return fa.flash_attention_backward_reference(
                q0, k0, v0, o0, l0, g_out, causal, scale, g_lse)

        once, again = kernel_backward(), kernel_backward()
        rec["bit_equal_repeat"] = all(torch.equal(a, b)
                                      for a, b in zip(once, again))
        assert rec["bit_equal_repeat"], "two backward calls differ"
        del once, again
        rec["backward_ms"] = time_ms(torch, kernel_backward)
        rec["backward_device_ms"] = graph_ms(torch, kernel_backward)
        rec["plain_backward_ms"] = time_ms(torch, plain_backward, 1, 5)
        rec["plain_backward_device_ms"] = graph_ms(torch, plain_backward,
                                                   5, 3)
        # leaves over the same (strided) storage, so that every timed
        # graph starts at its inputs
        qkv_in = tuple(x.detach().requires_grad_(True) for x in (q, k, v))
        rec["fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            fa.flash_attention(*qkv_in, causal), qkv_in, d_out), 1, 5)
        so = F.scaled_dot_product_attention(*qkv_in, is_causal=causal,
                                            enable_gqa=True)
        rec["sdpa_backward_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            so, qkv_in, d_out, retain_graph=True))
        rec["sdpa_fwd_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*qkv_in, is_causal=causal,
                                           enable_gqa=True), qkv_in,
            d_out))
        # autograd runs a backward on the streams of its forward and of
        # its leaves, so fresh leaves and the SDPA forward are made on
        # the stream the graph captures
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            leaves = tuple(x.detach().requires_grad_(True) for x in (q, k, v))
            so_side = F.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=True)
        torch.cuda.current_stream().wait_stream(side)
        rec["sdpa_backward_device_ms"] = graph_ms(
            torch, lambda: torch.autograd.grad(so_side, leaves, d_out,
                                               retain_graph=True), 5, 3,
            stream=side)
        bound, by, flops = flash_bwd_bound(b, h, h_kv, t, tk, d, name,
                                           causal)
        rec.update(backward_bound_ms=bound, backward_bound_by=by,
                   backward_flops=flops,
                   backward_share_of_bound=bound / rec["backward_ms"],
                   backward_device_share_of_bound=(
                       bound / rec["backward_device_ms"]),
                   timing="*_ms: median CUDA-event interval around eager "
                          "calls; *_device_ms: CUDA-graph replay, the "
                          "card's time alone; backward_ms: the kernels' "
                          "wrapper (prep, dkdv, dq); plain_backward_ms with "
                          "TF32 off, as every f32 product of this run; "
                          "library calls timed only")
    emit(rec)
    return rec


def flash_backward_phase(torch, fa, smi) -> dict:
    """Phase 7: the Function against autograd through the plain forward
    and its backward kernels against the plain backward, at the training
    shape (timed, on the main path's inputs and cotangent: views of the
    fused projection, out only; then contiguous, with the lse cotangent),
    at ``BWD_CASES`` and at ``BWD_KERNEL_CASES``. Returns the timed
    record, with the backward kernels' registers and spills from the build
    log."""
    from bigdl_tpu_torch.ops import build

    b, h, t = TRAIN_BATCH, TRAIN["heads"], TRAIN["seq_len"]
    shape = (b, h, h, t, t, TRAIN["embed_dim"] // h)
    timed = check_flash_backward(torch, fa, shape, True, torch.bfloat16,
                                 "out", timed=True, fused=True)
    check_flash_backward(torch, fa, shape, True, torch.bfloat16)
    for shape, causal, dtype in BWD_CASES:
        check_flash_backward(torch, fa, shape, causal, getattr(torch, dtype))
    for shape, causal, dtype, cotangent in BWD_KERNEL_CASES:
        check_flash_backward(torch, fa, shape, causal, getattr(torch, dtype),
                             cotangent)
    with open(build.build_log()) as f:
        timed["ptxas"] = bwd_ptxas(f.read())
    emit({"phase": "flash_backward_kernels", "nvidia_smi": smi,
          "ptxas": timed["ptxas"],
          "cases": 2 + len(BWD_CASES) + len(BWD_KERNEL_CASES)})
    return timed


def bwd_ptxas(text: str) -> dict:
    """Registers, spill stores and spill loads (bytes) of each backward
    kernel in an ``nvcc -Xptxas -v`` log, by a readable name such as
    ``flash_bwd_dq_bf16<64>``."""
    rows, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(flash_bwd_\w+?)I(?:Li(\d+)|(f)|13__nv_bfloat16)E",
                          line)
            name = None
            if m:
                arg = m.group(2) or ("float32" if m.group(3) else "bfloat16")
                name = f"{m.group(1)}<{arg}>"
                rows[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[name].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[name]["registers"] = int(m.group(1))
    return rows


def train_phase(torch, fa, smi) -> int:
    """Phase 8: the training flagship through ``transformer_perf``, a
    remat step, a profile of one step, and the f32 gate at batch 4;
    returns the bf16 kernel launches of the timed flagship run (warm-up,
    timed and profiled steps), counted from 0 just before it."""
    from bigdl_tpu_torch.models.perf import LMLoss, transformer_perf
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.optim import SGD, make_train_step
    from bigdl_tpu_torch.utils.profiling import device_profile

    bf16, f32 = torch.bfloat16, torch.float32
    # bf16 compute over f32 masters, through the train step: every step
    # launches the kernel once per layer
    warm, steps = 2, 5
    fa.launches = 0
    bwd_start(fa)
    perf = transformer_perf(TRAIN_BATCH, steps, warm, bf16,
                            log=lambda *_: None, device="cuda",
                            profile=lambda fn: device_profile(
                                fn, top=20, named=BWD_KERNEL_NAMES),
                            **TRAIN)
    train_launches = fa.launches
    per_step = TRAIN["layers"]
    assert train_launches == per_step * (warm + steps + 1), train_launches
    # one backward a layer a step (the profiled step too)
    train_bwd = bwd_end(fa, "train", per_step * (warm + steps + 1))
    assert all(map(math.isfinite, perf["losses"])), perf["losses"]
    prof = perf.pop("profile")
    mfu = perf["flops_per_iter"] / (perf["ms_per_iter"] / 1e3) \
        / PEAK_FLOPS["bfloat16"]
    # a remat run (one warm-up, one timed step): the recompute launches
    # the kernel again, counted on its own
    fa.launches = 0
    bwd_start(fa)
    remat = transformer_perf(TRAIN_BATCH, 1, 1, bf16, log=lambda *_: None,
                             remat=True, device="cuda", **TRAIN)
    remat_launches = fa.launches
    remat_per_step = remat_launches // 2
    assert remat_per_step == 2 * per_step, remat_per_step
    # the recompute's forward has the backward; the first forward, under
    # no_grad, has none
    remat_bwd = bwd_end(fa, "train_remat", 2 * per_step)
    assert all(map(math.isfinite, remat["losses"])), remat["losses"]
    emit({"phase": "train", "config": {**TRAIN, "batch": TRAIN_BATCH,
                                       "compute_dtype": "bfloat16",
                                       "masters": "float32",
                                       "optimizer": "SGD(0.01)",
                                       "use_flash": True},
          "nvidia_smi": smi, "warmup_steps": warm, "timed_steps": steps,
          "ms_per_step": perf["ms_per_iter"],
          "tokens_per_s": perf["records_per_sec"],
          "losses": perf["losses"],
          "analytic_flops_per_step": perf["flops_per_iter"],
          "analytic_mfu": mfu, "mfu_peak": "989 TFLOP/s bf16 (H100 SXM)",
          "flash_launches": train_launches,
          "flash_launches_per_step": per_step,
          "flash_backward_launches": train_bwd,
          "remat_ms_per_step": remat["ms_per_iter"],
          "remat_flash_launches": remat_launches,
          "remat_flash_launches_per_step": remat_per_step,
          "remat_flash_backward_launches": remat_bwd,
          "timer": perf["timer"]})
    emit({"phase": "train_profile", "window": "one flagship train step",
          "backward_kernels_device_ms": prof["named_kernels_ms"],
          "backward_kernels_share_of_kernel_ms": {
              n: ms / prof["device_kernel_ms"]
              for n, ms in prof["named_kernels_ms"].items()},
          **prof})

    # the gate: f32, TF32 off, at batch 4 on the same weights and batch,
    # the flash path's gradients equal the dense path's; then f32 SGD
    # steps of the flash path lower the loss
    model = TransformerLM(TRAIN["vocab"], TRAIN["embed_dim"],
                          TRAIN["heads"], TRAIN["layers"], TRAIN["seq_len"],
                          use_flash=True, seed=0, device="cuda", dtype=f32)
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, TRAIN["vocab"], (4, TRAIN["seq_len"]),
                        device="cuda", generator=g)
    crit = LMLoss(TRAIN["vocab"])

    def model_grads(flash: bool):
        for blk in model.blocks():
            blk.attn.use_flash = flash
        model.zero_grad(set_to_none=True)
        loss = crit.forward(model(ids), ids)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}

    # the f32 kernel (the CUDA-core loop, not the bf16 wgmma kernel of the
    # timed path), counted on its own
    fa.launches = 0
    bwd_start(fa)
    loss_flash, g_flash = model_grads(True)
    assert fa.launches == TRAIN["layers"], fa.launches
    assert fa.backward_launches == TRAIN["layers"], fa.backward_launches
    loss_dense, g_dense = model_grads(False)
    model.zero_grad(set_to_none=True)
    leaf_rel = {n: ((g_flash[n] - g_dense[n]).abs().max()
                    / g_dense[n].abs().max()).item() for n in g_dense}
    worst = max(leaf_rel, key=leaf_rel.get)
    del g_flash, g_dense
    for blk in model.blocks():
        blk.attn.use_flash = True
    ts = make_train_step(model, crit, SGD(learning_rate=0.01))
    params, slots = model.params_dict(), ts.init_slots(model.params_dict())
    f32_losses = []
    for _ in range(4):
        loss, params, _, slots = ts.step(params, {}, slots, ids, ids,
                                         ts.current_lrs(), None)
        f32_losses.append(loss.item())
    gate_launches = fa.launches
    emit({"phase": "train_gate", "batch": 4, "dtype": "float32",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "loss_flash": loss_flash, "loss_dense": loss_dense,
          "grad_max_rel_diff": leaf_rel[worst], "worst_leaf": worst,
          "grad_rtol": GRAD_RTOL,
          "tol": "per leaf: max|g_flash - g_dense| / max|g_dense|",
          "sgd_f32_losses": f32_losses,
          "f32_flash_launches": gate_launches,
          "f32_flash_backward_launches": fa.backward_launches})
    assert leaf_rel[worst] <= GRAD_RTOL, (worst, leaf_rel[worst])
    assert abs(loss_flash - loss_dense) <= 1e-4 * abs(loss_dense)
    assert all(b < a for a, b in zip(f32_losses, f32_losses[1:])), \
        f32_losses
    assert gate_launches == TRAIN["layers"] * (1 + len(f32_losses)), \
        gate_launches
    bwd_end(fa, "train_gate", TRAIN["layers"] * (1 + len(f32_losses)))
    return train_launches


_LONE: dict = {}
#: steady-decode profile windows by engine kind, for side-by-side lines
_WINDOWS: dict = {}


def lone_mismatch(model, prompt, n, row):
    """None when ``row`` equals a lone greedy ``generate`` of ``prompt``
    (``n`` new tokens); else the first difference, asserted to be a near
    tie (the lone run's top two logits there within ``NEAR_TIE``). Each
    lone run is made once and kept for the later phases."""
    import numpy as np

    key = (id(model), np.asarray(prompt).tobytes(), n)
    if key not in _LONE:
        ids, seen = model.generate(prompt, n, return_logits=True)
        _LONE[key] = (ids[0].cpu().numpy(), seen[0].cpu())
    lone, lone_logits = _LONE[key]
    assert row.shape == lone.shape, (row.shape, lone.shape)
    if (row == lone).all():
        return None
    j = int((row != lone).nonzero()[0][0]) - len(prompt)
    top2 = lone_logits[j].topk(2).values
    rec = {"position": j, "margin": (top2[0] - top2[1]).item()}
    assert rec["margin"] < NEAR_TIE, rec
    return rec


def shared_head_pair():
    """Two prompts sharing a new 192-token head, then differing: the
    second reuses the head whole."""
    import numpy as np

    g = np.random.RandomState(5)
    head = g.randint(0, FLAGSHIP["vocab_size"], 192)
    tail_a = g.randint(0, FLAGSHIP["vocab_size"], 40)
    tail_b = g.randint(0, FLAGSHIP["vocab_size"], 30)
    tail_b[0] = (tail_a[0] + 1) % FLAGSHIP["vocab_size"]
    return tuple(np.concatenate([head, t]).astype(np.int32)
                 for t in (tail_a, tail_b))


def engine_gate(torch, fa, smi, model32, reqs) -> int:
    """engine_gate (f32, TF32 off): the server phase's 8 requests through
    ``ContinuousBatchingEngine(max_slots=4, prefill_chunk=64,
    prefill_rows=2)`` at once, so slots and staging rows recycle, each
    row held to a lone ``generate``; a warm prefix hit of 192 tokens
    against the same request through an engine with the cache off; a
    cancellation mid-decode; the flow counters. Returns the flash
    kernel's launches in the phase's engine runs."""
    import numpy as np

    from bigdl_tpu_torch.serving import (ContinuousBatchingEngine,
                                         RequestCancelled)

    fa.launches = 0
    t0 = time.monotonic()
    eng = ContinuousBatchingEngine(model32, max_slots=4, prefill_chunk=64,
                                   prefill_rows=2)
    with eng:
        handles = [eng.submit(p, n) for p, n in reqs]
        rows = [h.result(timeout=120) for h in handles]
        serve_s = time.monotonic() - t0
        pa, pb = shared_head_pair()
        eng.submit(pa, 16).result(timeout=120)
        hb = eng.submit(pb, 24)
        row_b = hb.result(timeout=120)
        # cancelled mid-decode: after its first streamed token
        hc = eng.submit(reqs[0][0], 200)
        it = hc.tokens()
        next(it)
        hc.cancel()
        cancelled = False
        try:
            for _ in it:
                pass
        except RequestCancelled:
            cancelled = True
        stats = eng.stats()
    with ContinuousBatchingEngine(model32, max_slots=4, prefill_chunk=64,
                                  prefill_rows=2,
                                  prefix_cache_bytes=0) as cold:
        row_b_cold = cold.submit(pb, 24).result(timeout=120)
    launches = fa.launches
    near_ties = held_to_lone(model32, reqs, rows)
    warm_equals_cold = bool((row_b == row_b_cold).all())
    warm_tie = None if warm_equals_cold else \
        lone_mismatch(model32, pb, 24, row_b)
    rec = {"phase": "engine_gate", "dtype": "float32",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "nvidia_smi": smi,
           "engine": {"max_slots": 4, "prefill_chunk": 64,
                      "prefill_rows": 2},
           "requests": len(reqs), "seconds": serve_s,
           "rows_equal_lone_generate": len(reqs) - len(near_ties),
           "near_ties": near_ties, "near_tie_limit": NEAR_TIE,
           "prefix_tokens": hb.prefix_tokens,
           "warm_row_equals_cache_off": warm_equals_cold,
           "warm_near_tie": warm_tie,
           "cancelled_raised": cancelled,
           "cancelled_tokens": int(hc.tokens_so_far().shape[0]),
           "stats": {k: stats[k] for k in ("admitted", "finished",
                                           "evicted", "cancelled",
                                           "timed_out", "iterations",
                                           "prefill_rounds",
                                           "decode_steps")},
           "prefix_cache": {k: stats["prefix_cache"][k]
                            for k in ("hits", "misses", "reused_tokens",
                                      "hit_rate")},
           "flash_launches": launches}
    emit(rec)
    assert launches == 0, launches
    assert hb.prefix_tokens == 192, hb.prefix_tokens
    assert cancelled and isinstance(hc.error(), RequestCancelled)
    n_req = len(reqs) + 3
    assert (stats["admitted"], stats["finished"], stats["cancelled"],
            stats["evicted"], stats["timed_out"]) == \
        (n_req, n_req - 1, 1, n_req, 0), stats
    return launches


def steady_decode_profile(torch, model, **engine_kw) -> dict:
    """A ``torch.profiler`` window over ``PROFILE_ITERATIONS`` iterations
    of the engine's loop in steady decode, every slot busy (the engine
    config of ``ENGINE_SERVING`` plus ``engine_kw``, 8 requests of 256
    prompt tokens and 128 new). The profiler records the thread that
    starts it, so the window runs the loop's iteration (``_iterate``) on
    this thread: the engine's own thread is never started."""
    import numpy as np

    from bigdl_tpu_torch.serving import (ContinuousBatchingEngine,
                                         RequestHandle)
    from bigdl_tpu_torch.utils.profiling import device_profile

    cfg = ENGINE_SERVING
    eng = ContinuousBatchingEngine(model, max_slots=cfg["max_slots"],
                                   prefill_chunk=cfg["prefill_chunk"],
                                   prefill_rows=cfg["prefill_rows"],
                                   **engine_kw)
    g = np.random.RandomState(7)
    handles = [RequestHandle(g.randint(0, FLAGSHIP["vocab_size"], 256), 128)
               for _ in range(eng.max_slots)]
    for h in handles:
        eng._queue.put(h)
    with torch.inference_mode():
        while eng.stats()["active_slots"] < eng.max_slots:
            eng._iterate()
        s0 = eng.stats()
        tok0 = sum(len(h.tokens_so_far()) for h in handles)
        prof = device_profile(
            lambda: [eng._iterate() for _ in range(PROFILE_ITERATIONS)],
            top=10)
        s1 = eng.stats()
        tok1 = sum(len(h.tokens_so_far()) for h in handles)
    eng.stop(drain=False)
    n = PROFILE_ITERATIONS
    return dict(
        iterations=n,
        decode_steps=s1["decode_steps"] - s0["decode_steps"],
        prefill_rounds=s1["prefill_rounds"] - s0["prefill_rounds"],
        active_slots=s1["active_slots"],
        tokens_per_iteration=(tok1 - tok0) / n,
        kernel_launches=prof["kernel_launches"],
        launches_per_iteration=prof["kernel_launches"] / n,
        wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
        device_busy_share=1.0 - prof["device_idle_share"],
        ms_per_iteration=prof["wall_ms"] / n,
        top_kernels_ms=prof["top_kernels_ms"],
        top_ops_ms=prof["top_ops_ms"][:6])


def engine_serving(torch, fa, smi, model) -> int:
    """engine_serving (bf16): one Poisson workload (``ENGINE_SERVING``)
    through the engine and through ``GenerationService`` by the port's
    ``run_poisson_comparison``: latency both ways, the engine's TTFT and
    inter-token gap, delivered tokens/s both ways, the p99 speedup, the
    loop's iterations; then the steady-decode profile window. Returns
    the flash kernel's launches in the phase."""
    from bigdl_tpu_torch.serving import run_poisson_comparison

    fa.launches = 0
    res = run_poisson_comparison(model, **ENGINE_SERVING)
    window = steady_decode_profile(torch, model)
    _WINDOWS["dense"] = window
    launches = fa.launches
    eng, svc = res["engine"], res["generation_service"]
    stats = eng["stats"]
    vocab = FLAGSHIP["vocab_size"]
    same = 0
    for req, row, srow in zip(res["requests"], eng["rows"], svc["rows"]):
        assert row.shape == (len(req["prompt"]) + req["n"],), row.shape
        assert (row[:len(req["prompt"])] == req["prompt"]).all()
        assert ((row >= 0) & (row < vocab)).all()
        same += bool((row == srow).all())
    emit({"phase": "engine_serving", "dtype": "bfloat16",
          "nvidia_smi": smi, "workload": res["workload"],
          "engine": {"latency_s": eng["latency"], "ttft_s": eng["ttft"],
                     "inter_token_s": eng["inter_token"],
                     "tokens_per_s": eng["tokens_per_sec"],
                     "wall_s": eng["wall_s"],
                     "loop": {k: stats[k] for k in ("iterations",
                                                    "prefill_rounds",
                                                    "decode_steps")},
                     "latency_phases_s": {
                         k: {q: v[q] for q in ("p50", "p99")}
                         for k, v in stats["latency"].items()}},
          "generation_service": {"latency_s": svc["latency"],
                                 "tokens_per_s": svc["tokens_per_sec"],
                                 "wall_s": svc["wall_s"]},
          "p99_speedup": res["p99_speedup"],
          "rows_equal_generation_service": same,
          "steady_decode_profile": window,
          "flash_launches": launches,
          "timer": "host monotonic clock around each request; profile "
                   "window by torch.profiler (CUPTI kernels, busy = union "
                   "of kernel intervals over the window's wall)"})
    assert launches == 0, launches
    n_req = ENGINE_SERVING["n_requests"]
    assert (stats["admitted"], stats["finished"]) == (n_req, n_req), stats
    assert window["prefill_rounds"] == 0, window
    assert window["decode_steps"] == window["iterations"], window
    assert window["active_slots"] == ENGINE_SERVING["max_slots"], window
    assert window["kernel_launches"] > 0, window
    return launches


def engine_prefix(torch, fa, smi, model32) -> int:
    """engine_prefix (f32, TF32 off): ``run_shared_prefix_comparison`` at
    16 requests over 4 templates of 512 tokens, the prefix cache on
    against off: TTFT speedups, hit rate, and every row of the cached
    leg held to a lone ``generate`` (the uncached leg's too where the
    two legs differ), each mismatch a near tie. Returns the flash
    kernel's launches in the two engine legs."""
    from bigdl_tpu_torch.serving import run_shared_prefix_comparison

    fa.launches = 0
    res = run_shared_prefix_comparison(
        model32, n_requests=16, max_slots=4, prefill_chunk=64,
        prefill_rows=2, n_templates=4, template_len=512)
    launches = fa.launches
    near_ties = []
    for i, (req, a, b) in enumerate(zip(res["requests"],
                                        res["cached"]["rows"],
                                        res["uncached"]["rows"])):
        legs = (("cached", a),) if (a == b).all() else \
            (("cached", a), ("uncached", b))
        for leg, row in legs:
            tie = lone_mismatch(model32, req["prompt"], req["n"], row)
            if tie is not None:
                near_ties.append({"request": i, "leg": leg, **tie})
    pc = res["cached"]["prefix_cache"]
    emit({"phase": "engine_prefix", "dtype": "float32",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "nvidia_smi": smi, "workload": res["workload"],
          "ttft_p50_speedup": res["ttft_p50_speedup"],
          "ttft_p99_speedup": res["ttft_p99_speedup"],
          "cached": {"ttft_s": res["cached"]["ttft"],
                     "latency_s": res["cached"]["latency"],
                     "tokens_per_s": res["cached"]["tokens_per_sec"]},
          "uncached": {"ttft_s": res["uncached"]["ttft"],
                       "latency_s": res["uncached"]["latency"],
                       "tokens_per_s": res["uncached"]["tokens_per_sec"]},
          "hit_rate": pc["hit_rate"], "hits": pc["hits"],
          "reused_tokens": pc["reused_tokens"],
          "reused_fraction": pc["reused_fraction"],
          "token_parity": res["token_parity"],
          "rows_held_to_lone_generate": len(res["requests"]),
          "near_ties": near_ties,
          "flash_launches": launches})
    assert launches == 0, launches
    assert pc["hits"] >= 1, pc
    return launches


def held_to_lone(model, reqs, rows, label=None) -> list:
    """Each row against a lone ``generate``: the near ties (each asserted
    a near tie by ``lone_mismatch``), tagged with ``label``."""
    ties = []
    for i, ((p, n), row) in enumerate(zip(reqs, rows)):
        tie = lone_mismatch(model, p, n, row)
        if tie is not None:
            ties.append({"request": i, **({"run": label} if label else {}),
                         **tie})
    return ties


def paged_gate(torch, fa, smi, model32, reqs) -> int:
    """paged_gate (f32, TF32 off): engine_gate's 8 requests through the
    paged engine (``page_size=16``), each row held to a lone
    ``generate``; the 192-token prefix hit takes its 12 head pages by
    refcount (the admission's table holds the entry's pages, one
    reference more each, no page copied) and its row equals the
    cache-off paged engine's; after drain the pool holds exactly the
    prefix index's pages; a pool that fits one reservation at a time
    (a 320-token window, 21 pages) serves all 8 rows, each waiting its
    turn. Returns the flash kernel's launches in the phase."""
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    t_phase = time.monotonic()
    fa.launches = 0
    kw = dict(max_slots=4, prefill_chunk=64, prefill_rows=2,
              page_size=PAGE_SIZE)
    t0 = time.monotonic()
    eng = ContinuousBatchingEngine(model32, **kw)
    with eng:
        rows = [h.result(timeout=120)
                for h in [eng.submit(p, n) for p, n in reqs]]
        serve_s = time.monotonic() - t0
        pa, pb = shared_head_pair()
        eng.submit(pa, 16).result(timeout=120)
        entry, _ = eng._prefix.lookup(pb)
        head = list(entry.pages[:192 // PAGE_SIZE])
        refs = [eng._pages.refcount(p) for p in head]
        seen = []
        complete = eng._complete_admission

        def spy(a, tok):
            seen.append((a.table.pages[:len(head)],
                         [eng._pages.refcount(p) for p in head]))
            return complete(a, tok)

        eng._complete_admission = spy
        hb = eng.submit(pb, 24)
        row_b = hb.result(timeout=120)
        stats = eng.stats()
        held = {p for e in eng._prefix.snapshot() for p in e["pages"]}
    leaked = eng._pages.pages_in_use
    with ContinuousBatchingEngine(model32, prefix_cache_rows=0,
                                  **kw) as cold:
        row_b_cold = cold.submit(pb, 24).result(timeout=120)
    tight = ContinuousBatchingEngine(model32, max_len=320, max_pages=21,
                                     prefix_cache_rows=0, **kw)
    t1 = time.monotonic()
    with tight:
        tight_rows = [h.result(timeout=300)
                      for h in [tight.submit(p, n) for p, n in reqs]]
        tight_s = time.monotonic() - t1
        tight_stats = tight.stats()["paging"]
    launches = fa.launches
    near_ties = held_to_lone(model32, reqs, rows, "paged")
    near_ties += held_to_lone(model32, reqs, tight_rows, "tight")
    warm_equals_cold = bool((row_b == row_b_cold).all())
    warm_tie = None if warm_equals_cold else \
        lone_mismatch(model32, pb, 24, row_b)
    pool = stats["paging"]["pool"]
    rec = {"phase": "paged_gate", "dtype": "float32",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "nvidia_smi": smi, "engine": kw,
           "requests": len(reqs), "seconds": serve_s,
           "rows_equal_lone_generate": 2 * len(reqs) - len(near_ties),
           "rows_held": 2 * len(reqs),
           "near_ties": near_ties, "near_tie_limit": NEAR_TIE,
           "prefix_tokens": hb.prefix_tokens,
           "head_pages": len(head),
           "head_pages_shared_at_admission": seen == [(head, [
               c + 1 for c in refs])],
           "warm_row_equals_cache_off": warm_equals_cold,
           "warm_near_tie": warm_tie,
           "pool": pool, "table_len": stats["paging"]["table_len"],
           "pages_in_use_after_drain": pool["pages_in_use"],
           "prefix_held_pages": len(held),
           "pages_in_use_after_stop": leaked,
           "tight_pool": {"max_len": 320, "max_pages": 21,
                          "seconds": tight_s,
                          "page_waits": tight_stats["page_waits"]},
           "flash_launches": launches,
           "phase_s": time.monotonic() - t_phase}
    emit(rec)
    assert launches == 0, launches
    assert hb.prefix_tokens == 192, hb.prefix_tokens
    assert rec["head_pages_shared_at_admission"], (seen, head, refs)
    assert pool["cow_forks_total"] == 0, pool
    assert pool["pages_in_use"] == len(held) > 0, (pool, held)
    assert leaked == 0, leaked
    assert tight_stats["page_waits"] >= 1, tight_stats
    return launches


def make_draft(torch, dtype):
    """Draft (a): ``DRAFT`` with random weights from its own seed."""
    from bigdl_tpu_torch.models.transformer import TransformerLM

    draft = TransformerLM(**DRAFT, seed=1, device="cuda", dtype=dtype)
    draft.evaluate()
    return draft


def spec_gate(torch, fa, smi, model32, reqs) -> int:
    """spec_gate (f32, TF32 off): engine_gate's 8 requests through the
    speculative engine (``spec_gamma=4``), dense and paged
    (``page_size=16``), with draft (a), which exercises rejections, and
    with the target as its own draft, where every proposal is accepted
    and the bonus and full-burst paths run; every row held to a lone
    ``generate``, the self-draft's acceptance at least
    ``SELF_ACCEPT_MIN``; then a lone ``speculative_generate`` with draft
    (a) for two of the prompts. Returns the flash kernel's launches."""
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    t_phase = time.monotonic()
    draft_a = make_draft(torch, torch.float32)
    fa.launches = 0
    runs, near_ties = [], []
    for name, draft in (("unrelated", draft_a), ("self", model32)):
        for paged in (False, True):
            label = f"{name}-{'paged' if paged else 'dense'}"
            t0 = time.monotonic()
            with ContinuousBatchingEngine(
                    model32, max_slots=4, prefill_chunk=64, prefill_rows=2,
                    draft=draft, spec_gamma=SPEC_GAMMA,
                    page_size=PAGE_SIZE if paged else None) as eng:
                rows = [h.result(timeout=300)
                        for h in [eng.submit(p, n) for p, n in reqs]]
                stats = eng.stats()
            ties = held_to_lone(model32, reqs, rows, label)
            near_ties += ties
            runs.append({"run": label, "seconds": time.monotonic() - t0,
                         "rows_equal_lone_generate": len(reqs) - len(ties),
                         "decode_steps": stats["decode_steps"],
                         "speculation": stats["speculation"]})
    lone_spec = []
    for i in (0, 1):
        p, n = reqs[i]
        ids, st = model32.speculative_generate(
            p, n, draft=draft_a, gamma=SPEC_GAMMA, return_stats=True)
        tie = lone_mismatch(model32, p, n, ids[0].cpu().numpy())
        lone_spec.append({"request": i, **st, "near_tie": tie})
    launches = fa.launches
    emit({"phase": "spec_gate", "dtype": "float32",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "nvidia_smi": smi, "gamma": SPEC_GAMMA, "draft_a": DRAFT,
          "runs": runs, "near_ties": near_ties,
          "near_tie_limit": NEAR_TIE,
          "lone_speculative_generate": lone_spec,
          "flash_launches": launches,
          "phase_s": time.monotonic() - t_phase})
    assert launches == 0, launches
    for r in runs:
        sp = r["speculation"]
        assert sp["enabled"] and sp["proposed_tokens"] > 0, r
        if r["run"].startswith("self"):
            assert sp["acceptance_rate"] >= SELF_ACCEPT_MIN, r
    return launches


def paged_serving(torch, fa, smi, model) -> int:
    """paged_serving (bf16): ``run_paged_comparison`` (``PAGED_SERVING``)
    at equal KV bytes: peak admitted concurrency both ways and its
    ratio, TTFT speedups, the byte budget, how many rows agree between
    the legs; then the steady-decode profile window of the paged engine
    (``page_size=16``). Returns the flash kernel's launches."""
    from bigdl_tpu_torch.serving import run_paged_comparison

    t_phase = time.monotonic()
    fa.launches = 0
    res = run_paged_comparison(model, **PAGED_SERVING)
    window = steady_decode_profile(torch, model, page_size=PAGE_SIZE)
    launches = fa.launches
    paged, dense = res["paged"], res["dense"]
    vocab = FLAGSHIP["vocab_size"]
    for req, row in zip(res["requests"], paged["rows"]):
        assert row.shape == (len(req["prompt"]) + req["n"],), row.shape
        assert (row[:len(req["prompt"])] == req["prompt"]).all()
        assert ((row >= 0) & (row < vocab)).all()
    same = sum(bool((a == b).all())
               for a, b in zip(paged["rows"], dense["rows"]))
    emit({"phase": "paged_serving", "dtype": "bfloat16",
          "nvidia_smi": smi, "workload": res["workload"],
          "admitted_concurrency_ratio": res["admitted_concurrency_ratio"],
          "peak_admitted_concurrency": {
              "paged": paged["peak_admitted_concurrency"],
              "dense": dense["peak_admitted_concurrency"]},
          "ttft_p50_speedup": res["ttft_p50_speedup"],
          "ttft_p99_speedup": res["ttft_p99_speedup"],
          "kv_budget": res["kv_budget"],
          "paged": {"ttft_s": paged["ttft"], "latency_s": paged["latency"],
                    "inter_token_s": paged["inter_token"],
                    "tokens_per_s": paged["tokens_per_sec"],
                    "paging": paged["paging"]},
          "dense": {"ttft_s": dense["ttft"], "latency_s": dense["latency"],
                    "inter_token_s": dense["inter_token"],
                    "tokens_per_s": dense["tokens_per_sec"]},
          "rows_equal_between_legs": same, "requests": len(paged["rows"]),
          "steady_decode_profile": window,
          "flash_launches": launches,
          "phase_s": time.monotonic() - t_phase})
    assert launches == 0, launches
    n_req = PAGED_SERVING["n_requests"] + 1     # and the warm request
    for leg in (paged, dense):
        assert (leg["stats"]["admitted"], leg["stats"]["finished"]) == \
            (n_req, n_req), leg["stats"]
    assert window["prefill_rounds"] == 0, window
    assert window["active_slots"] == ENGINE_SERVING["max_slots"], window
    assert window["kernel_launches"] > 0, window
    return launches


def spec_serving(torch, fa, smi, model) -> int:
    """spec_serving (bf16): ``run_speculative_comparison`` with draft (a)
    (``SPEC_SERVING``): inter-token and TTFT speedups, the acceptance
    rate, token parity; then the steady-decode profile window of the
    speculative engine. Returns the flash kernel's launches."""
    from bigdl_tpu_torch.serving import run_speculative_comparison

    t_phase = time.monotonic()
    draft = make_draft(torch, torch.bfloat16)
    fa.launches = 0
    res = run_speculative_comparison(model, draft=draft, **SPEC_SERVING)
    window = steady_decode_profile(torch, model, draft=draft,
                                   spec_gamma=SPEC_GAMMA)
    launches = fa.launches
    spec, nospec = res["spec"], res["nospec"]
    vocab = FLAGSHIP["vocab_size"]
    for req, row in zip(res["requests"], spec["rows"]):
        assert row.shape == (len(req["prompt"]) + req["n"],), row.shape
        assert ((row >= 0) & (row < vocab)).all()
    same = sum(bool((a == b).all())
               for a, b in zip(spec["rows"], nospec["rows"]))
    emit({"phase": "spec_serving", "dtype": "bfloat16",
          "nvidia_smi": smi, "workload": res["workload"],
          "draft_a": DRAFT,
          "inter_token_p50_speedup": res["inter_token_p50_speedup"],
          "inter_token_p99_speedup": res["inter_token_p99_speedup"],
          "ttft_p50_speedup": res["ttft_p50_speedup"],
          "ttft_p99_speedup": res["ttft_p99_speedup"],
          "acceptance_rate": res["acceptance_rate"],
          "token_parity": res["token_parity"],
          "rows_equal_between_legs": same, "requests": len(spec["rows"]),
          "spec": {"ttft_s": spec["ttft"], "latency_s": spec["latency"],
                   "inter_token_s": spec["inter_token"],
                   "tokens_per_s": spec["tokens_per_sec"],
                   "speculation": spec["speculation"]},
          "nospec": {"ttft_s": nospec["ttft"],
                     "latency_s": nospec["latency"],
                     "inter_token_s": nospec["inter_token"],
                     "tokens_per_s": nospec["tokens_per_sec"]},
          "steady_decode_profile": window,
          "flash_launches": launches,
          "phase_s": time.monotonic() - t_phase})
    assert launches == 0, launches
    assert spec["speculation"]["proposed_tokens"] > 0, spec["speculation"]
    assert window["decode_steps"] == window["iterations"], window
    assert window["kernel_launches"] > 0, window
    return launches


# ------------------------- int8 KV and weights, and the prefix host tier
def _tree_equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for la, lb in zip(a, b)
               for x, y in zip(la, lb))


def _row_of(tree, row):
    return [tuple(t[row].clone() for t in layer) for layer in tree]


def _watch_dense_tier(torch, eng, log):
    """Hold every dense demotion and promotion of ``eng`` to the bytes
    its row held on the device: the row is copied aside before its copy
    to host is enqueued, the host buffer must equal it, and so must the
    pool row a promotion lands in."""
    pc = eng._prefix
    before = {}
    real_resolve, real_promote = eng._resolve_pending_demotion, pc.promote

    def resolve():
        pend = pc._pending_demotion
        if pend is not None:
            with torch.inference_mode():
                before[id(pend[0])] = _row_of(eng._pool, pend[1])
        real_resolve()
        if pend is not None and pend[0].host_buf is not None:
            torch.cuda.synchronize()
            host = [tuple(t.cuda() for t in layer)
                    for layer in pend[0].host_buf]
            log.append(("demote", _tree_equal(torch, host,
                                               before[id(pend[0])])))

    def promote(entry, row):
        with torch.inference_mode():
            landed = _row_of(eng._pool, row)
        log.append(("promote", _tree_equal(torch, landed,
                                           before[id(entry)])))
        return real_promote(entry, row)

    eng._resolve_pending_demotion, pc.promote = resolve, promote


def _watch_paged_tier(torch, eng, log):
    """The paged twin of ``_watch_dense_tier``: each spilled page copied
    aside before its copy to host, each promoted page held to it."""
    spilled = {}
    real_spill, real_promote = eng._spill, eng._prefix.promote_pages

    def spill(pages):
        with torch.inference_mode():
            snap = [_row_of(eng._kv_pool, p) for p in pages]
        buf = real_spill(pages)
        if buf is not None:
            spilled[id(buf)] = snap
            torch.cuda.synchronize()
            log.append(("demote", all(
                _tree_equal(torch, [tuple(t.cuda() for t in layer)
                                    for layer in host], dev)
                for host, dev in zip(buf, snap))))
        return buf

    def promote_pages(entry, pages):
        snap = spilled[id(entry.host_buf)]
        with torch.inference_mode():
            log.append(("promote", all(
                _tree_equal(torch, _row_of(eng._kv_pool, p), want)
                for p, want in zip(pages, snap))))
        return real_promote(entry, pages)

    eng._spill, eng._prefix.promote_pages = spill, promote_pages


def quant_gate(torch, fa, smi, model32) -> int:
    """quant_gate (f32, TF32 off): the int8 pieces on the card against
    the CPU and the int8 engine against itself. ``quantize_kv`` at a
    flagship cache shape gives the CPU's bytes; the int8 Linear's int32
    products at the flagship widths (``QUANT_LINEAR_SHAPES`` at
    ``QUANT_ROWS`` rows) and its f32 outputs equal the CPU's bit for
    bit; the int8 convolution's f32-of-codes sums against the CPU's
    int32 ones (``QUANT_CONV_SHAPES``: exact below the 2**24 bound,
    reported above it); the int8 engine serves one template workload
    one request at a time with the same rows plain, with the prefix
    cache and its host tier (every demotion and promotion held to the
    bytes the row had on the device, dense and paged), paged with and
    without page pressure; dense against paged and the int8-draft
    speculative rows against the plain ones (int8 KV with float
    weights, and int8 weights) are reported; ``quantized_quality_report``
    at the flagship. Returns the flash kernel's launches."""
    import numpy as np

    from bigdl_tpu_torch.nn.attention import quantize_kv
    from bigdl_tpu_torch.nn.quantized import (
        Linear as QLinear, Quantizer, int8_conv2d, int8_matmul,
        quantize_activation, quantize_weight, quantize_weight_minmax)
    from bigdl_tpu_torch.serving import (ContinuousBatchingEngine,
                                         quantized_quality_report)

    t_phase = time.monotonic()
    fa.launches = 0
    g = torch.Generator(device="cuda").manual_seed(11)
    kv = torch.randn((8, 2, 2048, 64), device="cuda", generator=g) * 3.0
    kv[0, 0, :4] = 0.0                       # all-zero slices: scale 1/127
    q, s = quantize_kv(kv)
    qc, sc = quantize_kv(kv.cpu())
    kv_same = torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)

    linears = []
    for k, n in QUANT_LINEAR_SHAPES:
        w = torch.randn((n, k), device="cuda", generator=g) * 0.02
        b = torch.randn((n,), device="cuda", generator=g) * 0.02
        w_q, w_s, w_zp = quantize_weight_minmax(w, (1,))
        card = QLinear(w_q, w_s, b, w_zp)
        cpu = QLinear(w_q.cpu(), w_s.cpu(), b.cpu(), w_zp.cpu())
        for m in QUANT_ROWS:
            x = torch.randn((m, k), device="cuda", generator=g)
            x_q, _ = quantize_activation(x)
            acc = int8_matmul(x_q, w_q)
            acc_same = torch.equal(acc.cpu(), int8_matmul(x_q.cpu(),
                                                         w_q.cpu()))
            out = card(x)
            out_c = cpu(x.cpu())
            rec = {"in": k, "out": n, "rows": m, "int32_equal": acc_same,
                   "out_max_abs_diff": (out.cpu() - out_c).abs()
                   .max().item()}
            if m in (8, 256):
                rec["int8_ms"] = time_ms(torch, lambda: card(x))
                rec["float_ms"] = time_ms(
                    torch, lambda: torch.nn.functional.linear(x, w, b))
            linears.append(rec)

    convs = []
    for bsz, c_in, hw, c_out, kk in QUANT_CONV_SHAPES:
        x = torch.randn((bsz, c_in, hw, hw), device="cuda", generator=g)
        w = torch.randn((c_out, c_in, kk, kk), device="cuda", generator=g)
        x_q, _ = quantize_activation(x)
        w_q, _ = quantize_weight(w, (1, 2, 3))
        args = ((1, 1), (1, 1), (1, 1), 1)
        acc = int8_conv2d(x_q, w_q, *args)
        acc_c = int8_conv2d(x_q.cpu(), w_q.cpu(), *args)
        convs.append({"x": [bsz, c_in, hw, hw], "w": [c_out, c_in, kk, kk],
                      "k": c_in * kk * kk,
                      "within_2_24_bound": 127 * 127 * c_in * kk * kk
                      < 2 ** 24,
                      "max_abs_diff": (acc.cpu() - acc_c).abs().max().item(),
                      "max_abs_sum": acc_c.abs().max().item()})

    # the int8 engine: one template workload, one request at a time (the
    # batch each Linear sees, idle lanes included, is then the same in
    # every leg); three 128-token templates, two rounds
    vocab = FLAGSHIP["vocab_size"]
    r = np.random.RandomState(13)
    tpls = [r.randint(0, vocab, 128) for _ in range(3)]
    reqs = [(np.concatenate([tpls[i % 3], r.randint(0, vocab, 8 + i % 2)])
             .astype(np.int32), 12) for i in range(6)]
    draft = Quantizer.quantize(model32)
    draft.evaluate()
    int8 = dict(kv_dtype="int8", weights_dtype="int8")
    base_kw = dict(max_slots=4, prefill_chunk=64, prefill_rows=2)
    # (leg, engine kwargs, regime, tier watcher); the small paged window
    # (256 tokens, 30 pages) puts the pool under pressure so that entries
    # demote and promote page by page
    legs = [
        ("plain", dict(prefix_cache_bytes=0, **int8), "int8", None),
        ("tier", dict(prefix_cache_rows=1, prefix_host_rows=8, **int8),
         "int8", _watch_dense_tier),
        ("paged", dict(page_size=PAGE_SIZE, prefix_cache_rows=4, **int8),
         "int8", None),
        ("spec", dict(prefix_cache_bytes=0, draft=draft,
                      spec_gamma=SPEC_GAMMA, **int8), "int8", None),
        ("kv_plain", dict(prefix_cache_bytes=0, kv_dtype="int8"), "kv",
         None),
        ("kv_spec", dict(prefix_cache_bytes=0, kv_dtype="int8", draft=draft,
                         spec_gamma=SPEC_GAMMA), "kv", None),
        ("paged256", dict(page_size=PAGE_SIZE, max_len=256,
                          prefix_cache_rows=4, **int8), "int8_256", None),
        ("paged256_tier", dict(page_size=PAGE_SIZE, max_len=256,
                               max_pages=30, prefix_cache_rows=4,
                               prefix_host_rows=4, **int8), "int8_256",
         _watch_paged_tier),
    ]
    rows, runs, moves = {}, [], []
    for name, kw, regime, watch in legs:
        t0 = time.monotonic()
        eng = ContinuousBatchingEngine(model32, **base_kw, **kw)
        if watch is not None:
            watch(torch, eng, moves)
        with eng:
            rows[name] = [eng.submit(p, n).result(timeout=300)
                          for p, n in reqs]
            st = eng.stats()
        pc = st["prefix_cache"]
        runs.append({"leg": name, "regime": regime,
                     "seconds": time.monotonic() - t0,
                     "quantization": st["quantization"],
                     "prefix": {k: pc.get(k) for k in (
                         "hits", "host_hits", "demotions", "promotions")},
                     "speculation": st["speculation"]})
        if eng._pages is not None:
            assert eng._pages.pages_in_use == 0, name

    def same(a, b):
        return sum(bool((x == y).all()) for x, y in zip(rows[a], rows[b]))

    parity = {f"{a}=={b}": same(a, b) for a, b in (
        ("plain", "tier"), ("plain", "paged"), ("plain", "spec"),
        ("kv_plain", "kv_spec"), ("paged256", "paged256_tier"))}
    quality = quantized_quality_report(model32, horizon=16)
    launches = fa.launches
    tier = {r["leg"]: r["prefix"] for r in runs}
    emit({"phase": "quant_gate", "dtype": "float32",
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "nvidia_smi": smi, "quantize_kv_bytes_equal_cpu": kv_same,
          "linear": linears, "conv": convs, "requests": len(reqs),
          "runs": runs, "rows_equal": parity,
          "tier_moves_bit_identical": {
              "demotions": sum(ok for kind, ok in moves if kind == "demote"),
              "promotions": sum(ok for kind, ok in moves
                                if kind == "promote"),
              "checked": len(moves)},
          "quality": quality, "flash_launches": launches,
          "phase_s": time.monotonic() - t_phase})
    assert launches == 0, launches
    assert kv_same
    assert all(rec["int32_equal"] and rec["out_max_abs_diff"] == 0.0
               for rec in linears), linears
    assert all(c["max_abs_diff"] == 0 for c in convs
               if c["within_2_24_bound"]), convs
    # identity holds where every batched Linear input is the same in
    # both legs: dense with and without the host tier, paged with and
    # without it. Dense against paged (idle lanes read other junk) and a
    # verify chunk against a decode step (the activation scale spans
    # gamma + 1 positions a row) differ by construction under int8
    # weights, in the JAX engine too: reported, not asserted
    n = len(reqs)
    for pair in ("plain==tier", "paged256==paged256_tier"):
        assert parity[pair] == n, parity
    for leg in ("tier", "paged256_tier"):
        assert tier[leg]["demotions"] >= 2 and tier[leg]["promotions"] >= 2, \
            tier
    assert moves and all(ok for _, ok in moves), moves
    assert math.isfinite(quality["logit_div_max"]) \
        and quality["logit_div_max"] > 0, quality
    return launches


def quant_scoring(torch, fa, smi, model) -> int:
    """quant_scoring (bf16): the int8 clone's full-sequence ``forward``
    over 4 x 2048 tokens goes through the flash kernel (attention is not
    quantized): its launches (one a layer a forward), its tokens/s
    beside the float forward's in the same run, and the max |logit|
    difference against the float model. Returns the kernel's launches."""
    from bigdl_tpu_torch.nn.quantized import Quantizer

    t_phase = time.monotonic()
    q = Quantizer.quantize(model)
    q.evaluate()
    g = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, FLAGSHIP["vocab_size"], (4, 2048), device="cuda",
                        generator=g)
    fa.launches = 0
    n_fwd = 3
    with torch.inference_mode():
        logits_q = q(ids)
        torch.cuda.synchronize()
        assert fa.launches == q.num_layers, fa.launches
        int8_ms = time_ms(torch, lambda: q(ids), warmup=0, iters=n_fwd)
        launches = fa.launches
        logits = model(ids)
        float_ms = time_ms(torch, lambda: model(ids), warmup=0, iters=n_fwd)
    assert launches == (1 + n_fwd) * q.num_layers, launches
    assert logits_q.shape == logits.shape
    assert torch.isfinite(logits_q).all()
    diff = (logits_q.float() - logits.float()).abs().max().item()
    agree = (logits_q.argmax(-1) == logits.argmax(-1)).float().mean().item()
    emit({"phase": "quant_scoring", "batch": 4, "seq": 2048,
          "dtype": "bfloat16", "nvidia_smi": smi,
          "int8_forward_ms": int8_ms, "float_forward_ms": float_ms,
          "int8_tokens_per_s": 4 * 2048 / int8_ms * 1e3,
          "float_tokens_per_s": 4 * 2048 / float_ms * 1e3,
          "max_abs_logit_diff": diff,
          "max_abs_logit": logits.float().abs().max().item(),
          "argmax_agreement": agree,
          "flash_launches": launches,
          "launches_per_forward": q.num_layers,
          "phase_s": time.monotonic() - t_phase})
    return launches


def quant_serving(torch, fa, smi, model) -> int:
    """quant_serving (bf16): ``run_quantized_comparison``
    (``QUANT_SERVING``): int8 KV and weights against full precision,
    int8 KV only, and the int8 draft over float and int8 KV; the row
    bytes (``stats()["quantization"]``), the quality report, the
    acceptance delta, parity within each regime; then the steady-decode
    profile of the int8 engine beside the dense one of engine_serving.
    Returns the flash kernel's launches."""
    from bigdl_tpu_torch.serving import run_quantized_comparison

    t_phase = time.monotonic()
    fa.launches = 0
    res = run_quantized_comparison(model, **QUANT_SERVING)
    window = steady_decode_profile(torch, model, kv_dtype="int8",
                                   weights_dtype="int8")
    launches = fa.launches
    vocab = FLAGSHIP["vocab_size"]

    def leg(r):
        return {"ttft_s": r["ttft"], "latency_s": r["latency"],
                "inter_token_s": r["inter_token"],
                "tokens_per_s": r["tokens_per_sec"]}

    for name in ("quantized", "fp_baseline", "kv_only", "spec_fp",
                 "spec_int8"):
        for req, row in zip(res["requests"], res[name]["rows"]):
            assert row.shape == (len(req["prompt"]) + req["n"],), row.shape
            assert ((row >= 0) & (row < vocab)).all()
    emit({"phase": "quant_serving", "dtype": "bfloat16", "nvidia_smi": smi,
          "workload": res["workload"],
          "quantization": res["quantized"]["quantization"],
          "capacity": res["capacity"], "quality": res["quality"],
          **{name: leg(res[name]) for name in (
              "quantized", "fp_baseline", "kv_only", "spec_fp",
              "spec_int8")},
          "acceptance": {"spec_fp": res["spec_fp"]["speculation"],
                         "spec_int8": res["spec_int8"]["speculation"]},
          "inter_token_p50_speedup": res["inter_token_p50_speedup"],
          "inter_token_p99_speedup": res["inter_token_p99_speedup"],
          "token_parity_spec_fp": res["token_parity_spec_fp"],
          "token_parity_spec_int8": res["token_parity_spec_int8"],
          "membw_util": res["membw_util"],
          "steady_decode_profile": window,
          "dense_steady_decode_profile": _WINDOWS.get("dense"),
          "flash_launches": launches,
          "phase_s": time.monotonic() - t_phase})
    assert launches == 0, launches
    qz = res["quantized"]["quantization"]
    assert qz["kv_dtype"] == "int8" and qz["weights_dtype"] == "int8"
    d = FLAGSHIP["embed_dim"] // FLAGSHIP["num_heads"]
    assert qz["row_bytes_ratio"] == round((d + 4) / (2 * d), 4), qz
    assert window["decode_steps"] == window["iterations"], window
    assert window["kernel_launches"] > 0, window
    return launches


def tier_serving(torch, fa, smi, model) -> int:
    """tier_serving (bf16): ``run_working_set_sweep`` (``TIER_SERVING``):
    a round-robin template working set of 2 and 8 templates against a
    2-row prefix pool, through a host-tiered, a device-only and a
    cache-off engine: hit rates, TTFT, demotions, promotions, host hits,
    rows equal to the cache-off leg. Returns the flash kernel's
    launches."""
    from bigdl_tpu_torch.serving import run_working_set_sweep

    t_phase = time.monotonic()
    fa.launches = 0
    res = run_working_set_sweep(model, **TIER_SERVING)
    launches = fa.launches
    emit({"phase": "tier_serving", "dtype": "bfloat16", "nvidia_smi": smi,
          "workload": res["workload"], "headline": res["headline"],
          "points": res["points"], "flash_launches": launches,
          "phase_s": time.monotonic() - t_phase})
    assert launches == 0, launches
    tiered = res["tiered"]
    assert tiered["demotions"] >= 1 and tiered["promotions"] >= 1, tiered
    assert res["headline"]["tiered_hit_rate"] > \
        res["headline"]["device_only_hit_rate"], res["headline"]
    return launches


def qos_requests():
    """qos_gate's prompts (seed 17): the victim, the urgent request, a
    short probe, and two freeze-drill prompts of one prefill chunk."""
    import numpy as np

    g = np.random.RandomState(17)
    v = FLAGSHIP["vocab_size"]
    return {name: g.randint(0, v, n).astype(np.int32)
            for name, n in (("victim", 96), ("urgent", 128), ("probe", 16),
                            ("frozen", 48), ("other", 40))}


def ledger_conservation(eng) -> float:
    """|sum of the tenants' device-seconds - the ledger's busy total| over
    the busy total, from the ledger's unrounded sums (every request
    finalized)."""
    led = eng._usage
    with led._lock:
        tenants = sum(a["device_s"] for a in led._tenants.values())
        busy = sum(led._busy.values())
        open_records = led._open
    assert open_records == 0, open_records
    assert busy > 0, busy
    return abs(tenants - busy) / busy


def preemption_drill(torch, model32, reqs, label, **engine_kw) -> dict:
    """One slot; the victim (96 tokens, ``QOS_VICTIM_NEW`` new, low class)
    provably decoding in it, then the urgent request (128 tokens, 16 new,
    high class) whose 2 ms slack expires at once: both rows held to a lone
    ``generate``, the victim preempted, the urgent one not; paged, the
    pool holds exactly the prefix index's pages after drain and none
    after stop; the ledger conserves."""
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    t0 = time.monotonic()
    victim, urgent = reqs["victim"], reqs["urgent"]
    eng = ContinuousBatchingEngine(model32, max_slots=1, prefill_chunk=64,
                                   preempt_slack_s=0.002, **engine_kw)
    with eng:
        eng.submit(victim, 2, priority="low").result(timeout=120)
        eng.submit(urgent, 2, priority="high").result(timeout=120)
        h_low = eng.submit(victim, QOS_VICTIM_NEW, priority="low",
                           tenant="batch")
        next(h_low.tokens())
        h_high = eng.submit(urgent, 16, priority="high",
                            tenant="interactive")
        row_high = h_high.result(timeout=300)
        row_low = h_low.result(timeout=300)
        deadline = time.monotonic() + 30
        while eng._has_work() and time.monotonic() < deadline:
            time.sleep(0.005)
        stats = eng.stats()
        held = None
        if eng.paged:
            held = len({p for e in eng._prefix.snapshot()
                        for p in e["pages"]})
            in_use_after_drain = eng._pages.pages_in_use
    ties = held_to_lone(model32, [(victim, QOS_VICTIM_NEW), (urgent, 16)],
                        [row_low, row_high], label)
    rec = {"drill": label, "seconds": time.monotonic() - t0,
           "rows_equal_lone_generate": 2 - len(ties), "near_ties": ties,
           "victim_preempted": h_low.preempted,
           "urgent_preempted": h_high.preempted,
           "qos_preempted": stats["qos"]["preempted"],
           "victim_usage": h_low.usage(),
           "conservation_rel": ledger_conservation(eng)}
    assert h_low.preempted >= 1 and stats["qos"]["preempted"] >= 1, rec
    assert h_high.preempted == 0, rec
    assert h_low.usage()["decode_tokens"] == QOS_VICTIM_NEW, rec
    if eng.paged:
        rec.update(pages_in_use_after_drain=in_use_after_drain,
                   prefix_held_pages=held,
                   pages_in_use_after_stop=eng._pages.pages_in_use)
        assert in_use_after_drain == held > 0, rec
        assert eng._pages.pages_in_use == 0, rec
    return rec


def qos_gate(torch, fa, smi, model32) -> int:
    """qos_gate (f32, TF32 off, ``max_slots=1``, ``prefill_chunk=64``,
    ``preempt_slack_s=0.002``): the preemption drill dense, paged
    (``page_size=16``), with a prefix host tier and speculative with draft
    (a); the chaos shed drill (a burn sheds low and serves normal, a
    severe burn sheds normal too, high is always served); ``fail_dispatch``
    on a prefill round and on a decode (the loop stops, every handle fails
    within a bounded wait); ``freeze_slot`` (the frozen row stalls while
    the other streams, then resumes equal to a lone ``generate``); a
    tenant bucket refusing with ``retry_after_s > 0``; the ledger's
    conservation (tenants' device-seconds against the busy total, within
    ``CONSERVATION_RTOL``) in every engine that served to the end.
    Returns the flash kernel's launches."""
    from bigdl_tpu_torch.serving import (
        ChaosFault, ChaosInjector, ContinuousBatchingEngine, EngineStopped,
        RequestHandle, RequestRateLimited, RequestShed)

    t_phase = time.monotonic()
    reqs = qos_requests()
    draft_a = make_draft(torch, torch.float32)
    fa.launches = 0
    drills = [
        preemption_drill(torch, model32, reqs, "dense"),
        preemption_drill(torch, model32, reqs, "paged",
                         page_size=PAGE_SIZE),
        preemption_drill(torch, model32, reqs, "host_tier",
                         prefix_host_rows=4),
        preemption_drill(torch, model32, reqs, "speculative",
                         draft=draft_a, spec_gamma=SPEC_GAMMA)]

    # the chaos shed drill
    probe = reqs["probe"]
    chaos = ChaosInjector()
    shed = {}
    eng = ContinuousBatchingEngine(model32, max_slots=1, prefill_chunk=64,
                                   shed_classes=("low", "normal"),
                                   chaos=chaos)
    with eng:
        chaos.force_burn(True)
        try:
            eng.submit(probe, 4, priority="low")
        except RequestShed as e:
            shed["low_on_burn"] = e.retry_after_s
        shed["normal_on_burn_served"] = bool(
            eng.submit(probe, 4, priority="normal").result(
                timeout=120).shape == (len(probe) + 4,))
        chaos.force_burn(True, severe=True)
        try:
            eng.submit(probe, 4, priority="normal")
        except RequestShed as e:
            shed["normal_on_severe_burn"] = e.retry_after_s
        shed["high_on_severe_burn_served"] = bool(
            eng.submit(probe, 4, priority="high").result(
                timeout=120).shape == (len(probe) + 4,))
        chaos.force_burn(False)
        shed["low_after_burn_served"] = bool(
            eng.submit(probe, 4, priority="low").result(
                timeout=120).shape == (len(probe) + 4,))
        shed["qos"] = {k: v for k, v in eng.stats()["qos"].items()
                       if k in ("shed", "shedding")}
    shed["conservation_rel"] = ledger_conservation(eng)

    # fail_dispatch on a prefill round (the first dispatch after an idle
    # engine admits) and on a decode (the second, after a one-chunk
    # prompt's single round)
    faults = []
    for target, nth in (("prefill", 1), ("decode", 2)):
        chaos = ChaosInjector()
        eng = ContinuousBatchingEngine(model32, max_slots=1,
                                       prefill_chunk=64, chaos=chaos)
        eng.submit(probe, 2).result(timeout=120)
        before = eng.stats()
        chaos.fail_dispatch(nth)
        handles, at_submit = [], 0
        for p, n in ((reqs["frozen"], 32), (reqs["victim"], 8),
                     (reqs["urgent"], 8)):
            try:
                handles.append(eng.submit(p, n))
            except EngineStopped:
                at_submit += 1
        waits, causes = [], []
        for h in handles:
            t = time.monotonic()
            try:
                h.result(timeout=FAULT_WAIT_S)
                causes.append("served")
            except EngineStopped as e:
                causes.append(type(e.__cause__).__name__)
            waits.append(time.monotonic() - t)
        eng.stop()
        after = eng.stats()
        rec = {"target": target, "nth": nth, "handles": len(handles),
               "stopped_at_submit": at_submit, "causes": causes,
               "fail_wait_s": waits,
               "prefill_rounds": after["prefill_rounds"]
               - before["prefill_rounds"],
               "decode_steps": after["decode_steps"]
               - before["decode_steps"],
               "crashed": type(eng._crashed).__name__,
               "in_flight_records": after["usage"]["totals"]["in_flight"]}
        faults.append(rec)
        assert isinstance(eng._crashed, ChaosFault), rec
        assert causes == ["ChaosFault"] * len(handles), rec
        assert len(handles) + at_submit == 3, rec
        assert max(waits, default=0.0) < FAULT_WAIT_S, rec
        assert rec["decode_steps"] == 0, rec
        assert rec["prefill_rounds"] == (0 if target == "prefill" else 1), \
            rec
        assert rec["in_flight_records"] == 0, rec

    # freeze_slot, driven on this thread: two slots, the first request's
    # slot frozen for FREEZE_ITERATIONS iterations once both stream
    chaos = ChaosInjector()
    eng = ContinuousBatchingEngine(model32, max_slots=2, prefill_chunk=64,
                                   chaos=chaos)
    ha = RequestHandle(reqs["frozen"], 48)
    hb = RequestHandle(reqs["other"], 24)
    eng._queue.put(ha)
    eng._queue.put(hb)
    with torch.inference_mode():
        while len(ha._tokens) < 1 or len(hb._tokens) < 1:
            eng._iterate()
        sid = next(s for s, st in enumerate(eng._slots)
                   if st is not None and st.handle is ha)
        chaos.freeze_slot(sid, FREEZE_ITERATIONS)
        a_seen, b_seen = [], []
        for _ in range(FREEZE_ITERATIONS):
            eng._iterate()
            a_seen.append(len(ha._tokens))
            b_seen.append(len(hb._tokens))
        while not (ha.done() and hb.done()):
            eng._iterate()
    eng.stop()
    freeze_ties = held_to_lone(
        model32, [(reqs["frozen"], 48), (reqs["other"], 24)],
        [ha.result(timeout=1), hb.result(timeout=1)], "freeze")
    freeze = {"iterations": FREEZE_ITERATIONS,
              "frozen_tokens_while_frozen": a_seen,
              "other_tokens_while_frozen": b_seen,
              "rows_equal_lone_generate": 2 - len(freeze_ties),
              "near_ties": freeze_ties}
    assert a_seen == [a_seen[0]] * len(a_seen), freeze
    assert b_seen[-1] > b_seen[0], freeze

    # a tenant bucket: the first request lands (post-paid), its measured
    # device-seconds overdraw the bucket, a later submit is refused
    with ContinuousBatchingEngine(
            model32, max_slots=1, prefill_chunk=64,
            tenant_rate_limits={"greedy": (0.001, 0.0005)}) as eng:
        eng.submit(reqs["probe"], 32, tenant="greedy").result(timeout=120)
        limited, probes = None, 0
        deadline = time.monotonic() + 30
        while limited is None and time.monotonic() < deadline:
            probes += 1
            try:
                eng.submit(reqs["probe"], 32, tenant="greedy").result(
                    timeout=120)
            except RequestRateLimited as e:
                limited = e
        polite = eng.submit(reqs["probe"], 4, tenant="polite").result(
            timeout=120)
        bucket = eng.stats()["qos"]["rate_limits"]["greedy"]
    rate = {"probes": probes, "bucket": bucket,
            "retry_after_s": limited.retry_after_s if limited else None,
            "polite_served": bool(polite.shape == (len(probe) + 4,)),
            "conservation_rel": ledger_conservation(eng)}
    launches = fa.launches
    emit({"phase": "qos_gate", "dtype": "float32",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "nvidia_smi": smi, "victim_new_tokens": QOS_VICTIM_NEW,
          "preemption": drills, "shed": shed, "fail_dispatch": faults,
          "freeze": freeze, "rate_limit": rate,
          "near_tie_limit": NEAR_TIE,
          "conservation_rtol": CONSERVATION_RTOL,
          "flash_launches": launches,
          "phase_s": time.monotonic() - t_phase})
    assert launches == 0, launches
    assert shed.get("low_on_burn", 0) > 0, shed
    assert shed.get("normal_on_severe_burn", 0) > 0, shed
    assert shed["normal_on_burn_served"], shed
    assert shed["high_on_severe_burn_served"], shed
    assert shed["low_after_burn_served"] and shed["qos"]["shed"] == 2, shed
    assert limited is not None and limited.retry_after_s > 0, rate
    assert rate["polite_served"], rate
    for rel in ([d["conservation_rel"] for d in drills]
                + [shed["conservation_rel"], rate["conservation_rel"]]):
        assert rel <= CONSERVATION_RTOL, rel
    return launches


def qos_serving(torch, fa, smi, model) -> int:
    """qos_serving (bf16): ``run_qos_storm`` at the JAX defaults
    (``QOS_SERVING``: 24 requests at 20/s into 2 slots with the whole QoS
    stack on, 3 greedy-tenant requests, then the high class alone): the
    high-class TTFT ratios, the shed / preempted / rate-limited counts
    (each must be > 0: a storm that never fired measured nothing), the
    outcomes, outcome conservation, the tenants' device-seconds and the
    goodput block. No limit is set on the ratios. Returns the flash
    kernel's launches."""
    from bigdl_tpu_torch.serving import run_qos_storm

    t_phase = time.monotonic()
    fa.launches = 0
    res = run_qos_storm(model, **QOS_SERVING)
    launches = fa.launches
    storm, uncont = res["qos"], res["uncontended"]
    emit({"phase": "qos_serving", "dtype": "bfloat16", "nvidia_smi": smi,
          "workload": res["workload"],
          "high_ttft_p50_ratio": res["high_ttft_p50_ratio"],
          "high_ttft_p99_ratio": res["high_ttft_p99_ratio"],
          "shed": res["shed"], "preempted": res["preempted"],
          "rate_limited": res["rate_limited"],
          "conservation_ok": res["conservation_ok"],
          "storm": {k: storm[k] for k in (
              "outcomes", "ttft_by_class", "ttft", "inter_token",
              "latency", "tokens_per_sec", "wall_s", "submitted",
              "retry_after_s_max", "tenants", "goodput", "alerts")},
          "uncontended": {k: uncont[k] for k in (
              "outcomes", "ttft", "inter_token", "latency",
              "tokens_per_sec", "wall_s", "submitted", "tenants",
              "goodput")},
          "flash_launches": launches,
          "phase_s": time.monotonic() - t_phase})
    assert launches == 0, launches
    assert res["shed"] > 0 and res["preempted"] > 0 \
        and res["rate_limited"] > 0, storm["qos_state"]
    assert res["conservation_ok"], (storm["outcomes"], uncont["outcomes"])
    return launches


def rel_diff(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def randomize_bn(torch, model, seed: int) -> None:
    """Random gamma, beta, running mean and variance in every BN of
    ``model``: the zero gamma of each bottleneck's last BN would make
    every residual branch 0 and hide its convolutions from the checks."""
    from bigdl_tpu_torch.nn import SpatialBatchNormalization

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SpatialBatchNormalization):
                n = m.n_output
                m.weight.copy_(torch.rand(n, generator=g) * 0.4 + 0.1)
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean = 0.1 * torch.randn(n, generator=g).to(
                    m.running_mean.device)
                m.running_var = (torch.rand(n, generator=g) * 1.5 + 0.5).to(
                    m.running_var.device)


def vision_gate(torch, smi):
    """Phase vision_gate: f32, TF32 off. Returns the card's NCHW model
    (random BN state) for the eval phase."""
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.nn.module import tree_leaves
    from bigdl_tpu_torch.optim import SGD, make_train_step

    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = {"depth": 50, "dataSet": "ImageNet"}
    nchw = ResNet(1000, cfg, seed=0, device="cuda")
    randomize_bn(torch, nchw, seed=5)
    nhwc = ResNet(1000, {**cfg, "format": "NHWC"}, seed=1, device="cuda")
    cpu = ResNet(1000, cfg, seed=2, device="cpu")
    for m in (nhwc, cpu):
        m.load_params_dict(nchw.params_dict())
        m.load_buffers_dict(nchw.buffers_dict())
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 3, 224, 224), generator=g)
    with torch.inference_mode():
        for m in (nchw, nhwc, cpu):
            m.evaluate()
        out_nchw = nchw(x.cuda())
        out_nhwc = nhwc(x.permute(0, 2, 3, 1).contiguous().cuda())
        out_cpu = cpu(x)
        torch.cuda.synchronize()
    eval_rel = {"nhwc_vs_nchw": rel_diff(out_nhwc.cpu(), out_nchw.cpu()),
                "nchw_vs_cpu": rel_diff(out_nchw.cpu(), out_cpu),
                "nhwc_vs_cpu": rel_diff(out_nhwc.cpu(), out_cpu)}

    # one training step, card (NHWC) against CPU (NCHW)
    xt = torch.randn((4, 3, 224, 224), generator=g)
    yt = torch.tensor([1, 17, 400, 1000])
    steps = {}
    for name, model, xin in (
            ("card", nhwc, xt.permute(0, 2, 3, 1).contiguous().cuda()),
            ("cpu", cpu, xt)):
        ts = make_train_step(model, CrossEntropyCriterion(),
                             SGD(learning_rate=0.01))
        p0, b0 = model.params_dict(), model.buffers_dict()
        loss, p1, b1, _ = ts.step(p0, b0, ts.init_slots(p0), xin,
                                  yt.to(xin.device), ts.current_lrs(), None)
        steps[name] = (loss.item(),
                       [(n, (b - a).float().cpu()) for (n, a), (_, b) in
                        zip(tree_leaves(p0), tree_leaves(p1))],
                       [(n, b.float().cpu(), a.float().cpu()) for (n, a),
                        (_, b) in zip(tree_leaves(b0), tree_leaves(b1))])
    err = math.sqrt(sum(((dg - dc) ** 2).sum().item() for (_, dg), (_, dc)
                        in zip(steps["card"][1], steps["cpu"][1])))
    ref = math.sqrt(sum((dc ** 2).sum().item() for _, dc in steps["cpu"][1]))
    upd_rel = err / ref
    stats_rel, unmoved = 0.0, []
    for (n, bg, old), (_, bc, _) in zip(steps["card"][2], steps["cpu"][2]):
        stats_rel = max(stats_rel, rel_diff(bg, bc))
        if torch.equal(bc, old):
            unmoved.append(n)
    rec = {"phase": "vision_gate", "nvidia_smi": smi,
           "model": "ResNet-50 ImageNet, random BN affine and statistics",
           "dtype": "float32", "allow_tf32": False,
           "eval_batch": 2, "eval_max_rel_to_max_logit": eval_rel,
           "eval_rtol": VISION_RTOL, "train_batch": 4,
           "train_loss": {"card_nhwc": steps["card"][0],
                          "cpu_nchw": steps["cpu"][0]},
           "update_rel_l2": upd_rel, "update_rtol": UPDATE_RTOL,
           "update_tol": "||d_card - d_cpu|| / ||d_cpu|| over all "
                         "parameters, d = new - old",
           "stats_max_rel": stats_rel, "stats_rtol": STATS_RTOL,
           "running_stats": len(steps["cpu"][2]),
           "unmoved_stats": unmoved}
    emit(rec)
    assert max(eval_rel.values()) <= VISION_RTOL, eval_rel
    assert abs(steps["card"][0] - steps["cpu"][0]) <= \
        VISION_RTOL * abs(steps["cpu"][0]), rec["train_loss"]
    assert upd_rel <= UPDATE_RTOL, upd_rel
    assert stats_rel <= STATS_RTOL, stats_rel
    assert not unmoved, unmoved
    del nhwc, cpu, steps
    return nchw


def vision_train(torch, smi):
    """Phases vision_train and vision_profile: the run_perf twin."""
    from bigdl_tpu_torch.models.perf import run_perf
    from bigdl_tpu_torch.utils.profiling import device_profile

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    warm, steps = 3, 10
    perf = run_perf("resnet50", batch_size=VISION_BATCH, iterations=steps,
                    warmup=warm, dtype=torch.bfloat16, format="NHWC",
                    master_f32=True, log=lambda *_: None, device="cuda",
                    profile=lambda fn: device_profile(fn, top=400))
    peak = torch.cuda.max_memory_allocated()
    prof = perf.pop("profile")
    # every kernel of the step by name: cuDNN's layout transposes, and
    # ATen's own kernels (BN, ReLU, adds, casts, SGD) against the rest
    # (cuDNN convolutions, cuBLAS for the head)
    kernels = prof.pop("top_kernels_ms")
    transposes = [k for k in kernels if "nchwtonhwc" in k[0].lower()
                  or "nhwctonchw" in k[0].lower()]
    aten_ms = sum(k[1] for k in kernels if "at::native" in k[0])
    prof.update(top_kernels_ms=kernels[:15],
                top_ops_ms=prof["top_ops_ms"][:15],
                distinct_kernels=len(kernels),
                aten_kernel_ms=aten_ms,
                other_kernel_ms=prof["device_kernel_ms"] - aten_ms,
                layout_transpose_kernels={
                    "names": len(transposes),
                    "ms": sum(k[1] for k in transposes)})
    # the same step in NCHW, for the layout's cost (short: its time only)
    nchw = run_perf("resnet50", batch_size=VISION_BATCH, iterations=3,
                    warmup=2, dtype=torch.bfloat16, format="NCHW",
                    master_f32=True, log=lambda *_: None, device="cuda")
    assert all(map(math.isfinite, nchw["losses"])), nchw["losses"]
    assert len(perf["losses"]) == warm + steps
    assert all(map(math.isfinite, perf["losses"])), perf["losses"]
    mfu = perf["records_per_sec"] * RESNET50_TRAIN_FLOPS / \
        PEAK_FLOPS["bfloat16"]
    emit({"phase": "vision_train", "nvidia_smi": smi,
          "config": {"model": "resnet50", "batch": VISION_BATCH,
                     "format": "NHWC", "compute_dtype": "bfloat16",
                     "masters": "float32", "optimizer": "SGD(0.01)",
                     "criterion": "CrossEntropyCriterion"},
          "warmup_steps": warm, "timed_steps": steps,
          "ms_per_step": perf["ms_per_iter"],
          "images_per_s": perf["records_per_sec"],
          "peak_memory_gb": peak / 1e9, "losses": perf["losses"],
          "analytic_flops_per_image": RESNET50_TRAIN_FLOPS,
          "analytic_mfu": mfu, "mfu_peak": "989 TFLOP/s bf16 (H100 SXM)",
          "timer": perf["timer"], "warmup_s": perf["warmup_s"],
          "nchw_ms_per_step": nchw["ms_per_iter"],
          "nchw_images_per_s": nchw["records_per_sec"]})
    emit({"phase": "vision_profile", "nvidia_smi": smi,
          "window": "one ResNet-50 train step, batch 256 NHWC bf16", **prof})


def vision_eval(torch, smi, model):
    """Phase vision_eval: the entry() twin (f32, batch 8, NCHW) and the
    bf16 NHWC forward at batch 256, on the gate's weights."""
    from bigdl_tpu_torch.models import ResNet

    g = torch.Generator(device="cuda").manual_seed(4)
    x8 = torch.randn((8, 3, 224, 224), device="cuda", generator=g)
    with torch.inference_mode():
        out8 = model(x8)
        f32_ms = time_ms(torch, lambda: model(x8), warmup=2, iters=10)
    assert out8.shape == (8, 1000) and torch.isfinite(out8).all()
    bf = ResNet(1000, {"depth": 50, "dataSet": "ImageNet", "format": "NHWC"},
                seed=1, device="cuda", dtype=torch.bfloat16)
    bf.load_params_dict(model.params_dict())
    bf.load_buffers_dict(model.buffers_dict())
    bf.evaluate()
    xb = torch.randn((VISION_BATCH, 224, 224, 3), device="cuda",
                     generator=g).to(torch.bfloat16)
    xb[:8] = x8.permute(0, 2, 3, 1).to(torch.bfloat16)
    with torch.inference_mode():
        outb = bf(xb)
        bf16_ms = time_ms(torch, lambda: bf(xb), warmup=2, iters=10)
    assert outb.shape == (VISION_BATCH, 1000) and torch.isfinite(outb).all()
    rel = rel_diff(outb[:8], out8)
    emit({"phase": "vision_eval", "nvidia_smi": smi,
          "f32_nchw": {"batch": 8, "ms": f32_ms,
                       "images_per_s": 8 / f32_ms * 1e3},
          "bf16_nhwc": {"batch": VISION_BATCH, "ms": bf16_ms,
                        "images_per_s": VISION_BATCH / bf16_ms * 1e3},
          "bf16_vs_f32_max_rel": rel, "rtol": EVAL_BF16_RTOL,
          "timing": "median CUDA-event interval around eager forwards "
                    "under inference_mode"})
    assert rel <= EVAL_BF16_RTOL, rel
    del bf


class LoopLog(logging.Handler):
    """The (loss, records/s) of every iteration the LocalOptimizer logs."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        if "Throughput" in record.msg:
            self.rows.append((record.args[-1], record.args[-2]))


def logged(name, fn):
    """Run ``fn`` with a LoopLog on the logger ``name``; its rows."""
    log = logging.getLogger(name)
    handler, level = LoopLog(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        fn()
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return handler.rows


def local_optimizer_phase(torch, smi):
    """Phase local_optimizer: LeNet-5 for one epoch with validation, then
    ResNet-50 NHWC bf16 for 8 iterations through the prefetch thread, and
    the same step without the loop."""
    import numpy as np

    from bigdl_tpu_torch.dataset import (LocalDataSet, MiniBatch, Sample,
                                         SampleToMiniBatch, Transformer,
                                         to_device)
    from bigdl_tpu_torch.dataset.dataset import minibatches
    from bigdl_tpu_torch.models import LeNet5, ResNet
    from bigdl_tpu_torch.models.perf import run_perf
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, CrossEntropyCriterion,
                                    Linear, SpatialBatchNormalization)
    from bigdl_tpu_torch.nn.module import tree_leaves
    from bigdl_tpu_torch.optim import (SGD, Optimizer, Top1Accuracy, Trigger,
                                       make_train_step)
    from bigdl_tpu_torch.utils.profiling import device_profile

    rs = np.random.RandomState(0)
    templates = rs.randn(10, 28, 28).astype(np.float32)

    def mnist_like(n):
        """Noisy copies of ten fixed 28 x 28 templates, labelled 1..10."""
        y = rs.randint(0, 10, n)
        x = templates[y] + rs.randn(n, 28, 28).astype(np.float32)
        return [Sample(a, b) for a, b in zip(x, (y + 1).astype(np.float32))]

    lenet = LeNet5(10, seed=0, device="cuda")
    opt = Optimizer(model=lenet, dataset=mnist_like(4096),
                    criterion=ClassNLLCriterion(), batch_size=128,
                    end_when=Trigger.max_epoch(1))
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_validation(Trigger.every_epoch(), mnist_like(1024),
                       [Top1Accuracy()])
    t0 = time.monotonic()
    rows = logged("bigdl_tpu_torch.optim", opt.optimize)
    lenet_s = time.monotonic() - t0
    losses = [r[0] for r in rows]
    state = opt.optim_method.state
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    lenet_rec = {"samples": 4096, "batch": 128, "iterations": len(rows),
                 "epoch_after": state["epoch"], "neval": state["neval"],
                 "top1_after_epoch": state.get("score"),
                 "loss_first4_mean": first, "loss_last4_mean": last,
                 "seconds": lenet_s,
                 "records_per_s_logged_median": float(np.median(
                     [r[1] for r in rows]))}
    assert len(rows) == 32 and state["epoch"] == 2, lenet_rec
    assert state.get("score") is not None and last < first, lenet_rec

    # ResNet-50 in bf16 (f32 BN statistics), fed as a bf16 model is: the
    # user's transformer casts each stacked batch on the prefetch thread
    class ToBF16(Transformer):
        def __call__(self, it):
            for b in it:
                yield MiniBatch(to_bf16(b.get_input()), b.get_target())

    def to_bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    batch, iters = 64, 8
    images = rs.randn(4 * batch, 224, 224, 3).astype(np.float32)
    labels = rs.randint(1, 1001, 4 * batch).astype(np.float32)
    samples = [Sample(a, b) for a, b in zip(images, labels)]
    net = ResNet(1000, {"depth": 50, "dataSet": "ImageNet",
                        "format": "NHWC"}, seed=0, device="cuda",
                 dtype=torch.bfloat16)
    par0 = [(n, p.clone()) for n, p in tree_leaves(net.params_dict())]
    buf0 = [b.clone() for _, b in tree_leaves(net.buffers_dict())]
    opt = Optimizer(model=net, dataset=(LocalDataSet(samples)
                                        >> SampleToMiniBatch(batch)
                                        >> ToBF16()),
                    criterion=CrossEntropyCriterion(), batch_size=batch,
                    end_when=Trigger.max_iteration(iters))
    opt.set_optim_method(SGD(learning_rate=0.01))
    t0 = time.monotonic()
    rows = logged("bigdl_tpu_torch.optim", opt.optimize)
    resnet_s = time.monotonic() - t0
    changed = [n for (n, a), (_, b) in zip(par0, tree_leaves(
        net.params_dict())) if not torch.equal(a, b)]
    moved = sum(not torch.equal(a, b) for a, (_, b) in
                zip(buf0, tree_leaves(net.buffers_dict())))
    # bf16 rounds away most SGD updates (lr 0.01) of the conv weights and
    # of gamma = 1; the head and the BN shifts (beta, from 0) keep theirs
    must_change = [f"{n}.{w}" for n, m in net.named_modules() for w in
                   (("weight", "bias") if isinstance(m, Linear) else
                    ("bias",) if isinstance(m, SpatialBatchNormalization)
                    else ())]

    # where a loop step's time goes. (1) The host side of the data path
    # alone, per batch: numpy stacking, the bf16 cast, the pinned
    # non-blocking copy. (2) The same step without the loop: the loop's
    # model and TrainStep on one batch already on the card, timed as the
    # loop times a step (host clock around the step and the loss's sync).
    # (3) run_perf at this batch (bf16 over f32 masters, CUDA events) and
    # one profiled step of it: its device busy time.
    stream = minibatches(LocalDataSet(samples), batch, train=True)
    host = {"stack_ms": [], "cast_ms": [], "pin_copy_ms": []}
    for _ in range(4):
        t0 = time.perf_counter()
        b = next(stream)
        t1 = time.perf_counter()
        x = to_bf16(b.get_input())
        t2 = time.perf_counter()
        to_device(x, torch.device("cuda"))
        to_device(b.get_target(), torch.device("cuda"))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(host, (t1 - t0, t2 - t1, t3 - t2)):
            host[k].append(v * 1e3)
    ts = make_train_step(net, CrossEntropyCriterion(), SGD(learning_rate=0.01))
    params, buffers = net.params_dict(), net.buffers_dict()
    slots, lrs = ts.init_slots(params), ts.current_lrs()
    xb = to_bf16(images[:batch]).cuda()
    yb = torch.from_numpy(labels[:batch]).cuda()
    bare_ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        loss, params, buffers, slots = ts.step(params, buffers, slots, xb, yb,
                                               lrs, None)
        float(loss)
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    del ts, params, buffers, slots
    perf = run_perf("resnet50", batch_size=batch, iterations=iters, warmup=3,
                    dtype=torch.bfloat16, format="NHWC", master_f32=True,
                    log=lambda *_: None, device="cuda",
                    profile=lambda fn: device_profile(fn, top=5))
    prof = perf["profile"]
    loop_ms = [batch / r[1] * 1e3 for r in rows]
    emit({"phase": "local_optimizer", "nvidia_smi": smi, "lenet5": lenet_rec,
          "resnet50": {"format": "NHWC", "param_dtype": "bfloat16",
                       "stats_dtype": "float32", "batch": batch,
                       "iterations": len(rows), "losses": [r[0] for r in rows],
                       "records_per_s_logged": [r[1] for r in rows],
                       "step_ms_logged": loop_ms, "seconds": resnet_s,
                       "params_changed": len(changed), "params": len(par0),
                       "must_change": len(must_change),
                       "running_stats_moved": moved,
                       "running_stats": len(buf0)},
          "resnet50_without_loop": {
              "host_data_path_ms_per_batch": host,
              "bare_step_ms": bare_ms,
              "timing": "host clock around the step and float(loss), as "
                        "the loop times it",
              "loop_minus_bare_median_ms": statistics.median(loop_ms[1:])
                                           - statistics.median(bare_ms[1:])},
          "run_perf_batch64": {
              "config": "resnet50 NHWC bf16 over f32 masters",
              "ms_per_step": perf["ms_per_iter"],
              "images_per_s": perf["records_per_sec"],
              "timer": perf["timer"],
              "profiled_step": {k: prof[k] for k in prof
                                if not k.startswith("top_")}}})
    assert len(rows) == iters and all(math.isfinite(r[0]) for r in rows)
    assert moved == len(buf0), (moved, len(buf0))
    missed = sorted(set(must_change) - set(changed))
    assert len(must_change) == 55 and not missed, (len(must_change), missed)
    assert all(map(math.isfinite, perf["losses"])), perf["losses"]


# ------------------------------------------------------------ slice 9
def beam_serving(torch, fa, smi, model, prompts) -> int:
    """beam_serving (bf16 serving flagship): ``beam_search`` over 4
    prompts of 128 tokens, 4 beams, 64 new tokens, with eos and without;
    one beam against greedy ``generate`` (equal, or a near tie of the
    greedy run at the first difference); the best beam's normalized
    score against the greedy row's; the reported score against an f32
    teacher-forced rescoring of the beam's tokens on the same weights;
    a run that fills the whole 2048-token window. Beam search runs over
    the KV cache: no flash launch, counted from 0 and asserted."""
    import copy

    b, t0, n, k = BEAM["prompts"], BEAM["prompt_len"], BEAM["new"], \
        BEAM["beams"]
    p = prompts[:b, :t0]
    greedy, greedy_logits = model.generate(p, n, return_logits=True)
    # eos: a token the greedy run of prompt 0 emits early, so beams finish
    eos = int(greedy[0, t0 + 2])
    fa.launches = 0
    timings = {}
    for label, eos_id in (("no_eos", None), ("eos", eos)):
        model.beam_search(p[:, :16], 4, num_beams=k, eos_id=eos_id)
        torch.cuda.synchronize()
        t_s = time.monotonic()
        out = model.beam_search(p, n, num_beams=k, eos_id=eos_id)
        torch.cuda.synchronize()
        dt = time.monotonic() - t_s
        assert out.shape == (b, t0 + n) and torch.equal(out[:, :t0], p)
        if eos_id is not None:
            for row in out[:, t0:].cpu().numpy():
                hits = (row == eos_id).nonzero()[0]
                if hits.size:
                    assert (row[hits[0]:] == eos_id).all(), row
        timings[label] = {"ms": dt * 1e3, "tokens_per_s": b * n / dt}
    # the scores each run ranked on, for the checks below
    _, logits, caches = model._decode_setup(p, n, None)
    run = model._beam_loop(logits, t0, caches, k, n, None, 1.0,
                           with_scores=True)
    best, score, length = run["tokens"], run["score"], run["length"]
    _, logits, caches = model._decode_setup(p, n, None)
    one = model._beam_loop(logits, t0, caches, 1, n, None, 1.0,
                           with_scores=True)
    # the window's edge: a prompt of 2048 - 64 tokens, one row
    edge_prompt = prompts[:1].repeat(1, FLAGSHIP["max_len"] // 256)[
        :, :FLAGSHIP["max_len"] - n]
    edge = model.beam_search(edge_prompt, n, num_beams=k)
    torch.cuda.synchronize()
    launches = fa.launches
    assert launches == 0, launches
    assert edge.shape == (1, FLAGSHIP["max_len"])
    assert 0 <= int(edge.min()) and int(edge.max()) < FLAGSHIP["vocab_size"]
    # one beam is greedy
    ties = []
    g_np, o_np = greedy.cpu().numpy(), one["tokens"].cpu().numpy()
    for r in range(b):
        diff = (o_np[r] != g_np[r, t0:]).nonzero()[0]
        if diff.size:
            j = int(diff[0])
            top2 = greedy_logits[r, j].topk(2).values
            ties.append({"row": r, "position": j,
                         "margin": (top2[0] - top2[1]).item()})
            assert ties[-1]["margin"] < NEAR_TIE, ties[-1]
    # normalized scores (penalty 1, every length n without eos). Beam
    # search keeps the K best prefixes by summed log-prob, so it may drop
    # the greedy prefix and end below it (the JAX package's beam search
    # too: tests/test_torch_beam_search.py); a best beam below the greedy
    # row is allowed only where the greedy prefix left the beams
    norm = score / length
    one_norm = one["score"] / one["length"]
    kept = greedy_kept(run, o_np)
    below = [r for r in range(b)
             if norm[r].item() < one_norm[r].item() - BEAM_RANK_ATOL]
    assert not [r for r in below if kept[r]], (below, kept)
    # f32 rescoring of the best beams' tokens on the same (bf16) weights
    ref = copy.deepcopy(model).float()
    for blk in ref.blocks():
        blk.attn.use_flash = False
    seq = torch.cat([p, best], 1)
    with torch.inference_mode():
        lp = torch.log_softmax(ref(seq)[:, t0 - 1:-1].float(), -1)
    rescored = lp.gather(-1, best[..., None])[..., 0].sum(1)
    del ref
    score_rel = ((score - rescored).abs() / rescored.abs()).max().item()
    emit({"phase": "beam_serving", "nvidia_smi": smi, "dtype": "bfloat16",
          "prompts": b, "prompt_len": t0, "new_tokens": n, "beams": k,
          "eos_id": eos, "runs": timings,
          "best_normalized": norm.tolist(),
          "greedy_normalized": one_norm.tolist(),
          "rows_best_at_least_greedy": b - len(below),
          "rows_greedy_prefix_pruned": b - sum(kept),
          "score_vs_f32_rescoring_max_rel": score_rel,
          "score_rtol": BEAM_SCORE_RTOL, "one_beam_near_ties": ties,
          "window_edge": {"prompt_len": int(edge_prompt.shape[1]),
                          "new_tokens": n, "max_len": FLAGSHIP["max_len"]},
          "flash_launches": launches})
    assert score_rel <= BEAM_SCORE_RTOL, score_rel
    return launches


def greedy_kept(run, greedy):
    """For each row, whether the greedy tokens ``greedy`` (B, n) stayed a
    prefix of one of the K beams after every step of ``run`` (the
    lineage ``_beam_loop(with_scores=True)`` returns)."""
    first = run["first"].cpu().numpy()
    toks = run["toks"].cpu().numpy()
    parents = run["parents"].cpu().numpy()
    b, k = first.shape
    kept = []
    for r in range(b):
        beams = [[int(first[r, j])] for j in range(k)]
        ok = [int(greedy[r, 0])] in beams
        for i in range(toks.shape[0]):
            beams = [beams[int(parents[i, r, j])] + [int(toks[i, r, j])]
                     for j in range(k)]
            ok = ok and [int(x) for x in greedy[r, :i + 2]] in beams
        kept.append(ok)
    return kept


def predict_serving(torch, fa, smi, model) -> int:
    """predict_serving (bf16): ``PredictionService`` over the flash-on
    serving flagship, 16 client threads sending requests of 512 tokens,
    half as bytes (``max_batch`` 8, ``sample_ndim`` 1): every answer
    held to a lone ``forward`` of the same input by the phase-3 rule; a
    malformed request (strings) and a malformed payload get the error
    tensor while the requests around them are answered. Then
    ``LocalPredictor.predict_class`` over a ResNet-50 eval batch of 256,
    held to 1 + the argmax of a lone forward of that batch. Returns the
    service's flash launches: 8 a dispatch that ran a forward."""
    import numpy as np

    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.optim import LocalPredictor, PredictionService
    from bigdl_tpu_torch.optim.prediction_service import (
        deserialize_activity, serialize_activity)

    cfg = PREDICT_SERVING
    rs = np.random.RandomState(0)
    reqs = [rs.randint(0, FLAGSHIP["vocab_size"], cfg["tokens"])
            for _ in range(cfg["clients"] * cfg["per_client"])]
    svc = PredictionService(model, num_threads=cfg["clients"],
                            max_batch=cfg["max_batch"],
                            batch_timeout_ms=cfg["timeout_ms"],
                            sample_ndim=1)
    answers, lat = [None] * len(reqs), [None] * len(reqs)
    bad = {}

    def client(c):
        for i in range(c, len(reqs), cfg["clients"]):
            t_s = time.monotonic()
            if i % 2:
                answers[i] = deserialize_activity(
                    svc.predict(serialize_activity(reqs[i])))
            else:
                answers[i] = svc.predict(reqs[i])
            lat[i] = time.monotonic() - t_s
        if c == 0:
            bad["strings"] = svc.predict(np.asarray(["a", "b", "c"]))
        if c == 1:
            bad["bytes"] = deserialize_activity(svc.predict(b"\x00 no npz"))

    fa.launches = 0
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(cfg["clients"])]
    t_s = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.monotonic() - t_s
    torch.cuda.synchronize()
    launches = fa.launches
    stats = svc.stats()
    # the strings request took a dispatch of its own and failed before
    # its forward
    assert launches == model.num_layers * (stats["dispatches"] - 1), \
        (launches, stats)
    assert bad["strings"].dtype.kind == "U" and \
        "running forward" in str(bad["strings"]), bad["strings"]
    assert "DeSerialize Input" in str(bad["bytes"]), bad["bytes"]
    worst = 0.0
    with torch.inference_mode():
        for i, req in enumerate(reqs):
            assert answers[i] is not None and answers[i].dtype.kind == "f", i
            lone = model(torch.from_numpy(req).cuda()[None])[0]
            worst = max(worst, tol_excess(
                torch, torch.from_numpy(answers[i]).cuda(), lone,
                RTOL["bfloat16"]))
    lat_ms = sorted(x * 1e3 for x in lat)
    rec = {"phase": "predict_serving", "nvidia_smi": smi,
           "dtype": "bfloat16", **cfg, "requests": len(reqs),
           "bytes_requests": len(reqs) // 2, "seconds": wall,
           "stats": stats,
           "requests_per_dispatch": stats["mean_batch_occupancy"],
           "latency_ms_p50": lat_ms[len(lat_ms) // 2],
           "latency_ms_p99": lat_ms[min(len(lat_ms) - 1,
                                        int(0.99 * len(lat_ms)))],
           "vs_lone_forward_excess": worst, "rtol": RTOL["bfloat16"],
           "flash_launches": launches}
    del svc, answers
    assert worst < 1.0, worst

    # LocalPredictor.predict_class over a ResNet-50 eval batch (f32)
    net = ResNet(1000, {"depth": 50, "dataSet": "ImageNet"}, seed=0,
                 device="cuda")
    images = rs.randn(cfg["resnet_batch"], 3, 224, 224).astype(np.float32)
    samples = [Sample(x, np.float32(1)) for x in images]
    fa.launches = 0
    t_s = time.monotonic()
    cls = LocalPredictor(net, batch_size=cfg["resnet_batch"]).predict_class(
        samples)
    torch.cuda.synchronize()
    pred_s = time.monotonic() - t_s
    assert fa.launches == 0, fa.launches
    net.evaluate()
    with torch.inference_mode():
        ref = net(torch.from_numpy(images).cuda()).float()
    want = ref.argmax(-1).cpu().numpy() + 1
    ties = []
    for i in (cls != want).nonzero()[0]:
        top2 = ref[i].topk(2).values
        ties.append({"image": int(i), "margin": (top2[0] - top2[1]).item()})
        assert ties[-1]["margin"] < NEAR_TIE, ties[-1]
    rec["resnet50_predict_class"] = {
        "batch": cfg["resnet_batch"], "dtype": "float32", "seconds": pred_s,
        "images_per_s": cfg["resnet_batch"] / pred_s,
        "equal_lone_argmax": int((cls == want).sum()), "near_ties": ties,
        "one_based": bool(cls.min() >= 1)}
    emit(rec)
    assert cls.min() >= 1
    del net
    return launches


def noncausal_scoring(torch, fa, smi) -> int:
    """noncausal_scoring (bf16): the non-causal flagship's forward over 4
    x 2048 tokens launches the flash kernel once a layer with
    ``causal=False``; its logits against the same model with
    ``use_flash=False`` (phase 4's model-level rule), the phase-3
    row-RMS excess reported beside it."""
    from bigdl_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(**FLAGSHIP, causal=False, seed=0, device="cuda",
                          dtype=torch.bfloat16)
    model.evaluate()
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, FLAGSHIP["vocab_size"], (4, 2048), device="cuda",
                        generator=g)
    with torch.inference_mode():
        fa.launches = 0
        logits = model(ids)
        torch.cuda.synchronize()
        launches = fa.launches
        assert launches == model.num_layers, launches
        fwd_ms = time_ms(torch, lambda: model(ids), warmup=1, iters=3)
        for blk in model.blocks():
            blk.attn.use_flash = False
        dense = model(ids)
    rel = rel_diff(logits, dense)
    excess = tol_excess(torch, logits, dense, RTOL["bfloat16"])
    agree = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
    emit({"phase": "noncausal_scoring", "nvidia_smi": smi, "batch": 4,
          "seq": 2048, "dtype": "bfloat16", "causal": False,
          "forward_ms": fwd_ms, "tokens_per_s": 4 * 2048 / fwd_ms * 1e3,
          "flash_vs_dense_max_rel": rel, "rtol": LOGIT_RTOL,
          "row_rms_excess": excess, "argmax_agreement": agree,
          "flash_launches": launches})
    assert rel <= LOGIT_RTOL, rel
    return launches


def checkpoint_train(torch, fa, smi) -> int:
    """checkpoint_train: the training flagship (32 x 1024, bf16 over f32
    masters) through the ``LocalOptimizer`` with ``RMSprop``, a
    ``TrainSummary`` and async checkpoints after iterations 1, 3 and 5,
    eight iterations; ``load_latest_checkpoint`` into a fresh model and
    method, then iterations 6 and 7 again. The loaded parameters, slots
    and state equal device copies taken when the checkpoint was, bit for
    bit; the resumed losses equal the uninterrupted run's within
    ``RESUME_RTOL``; the summary's Loss scalars read back. Returns the
    flash launches of the checkpointed run: 8 an iteration."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.models.perf import LMLoss
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.optim import (Optimizer, RMSprop, Trigger,
                                       load_latest_checkpoint)
    from bigdl_tpu_torch.utils import file as bt_file
    from bigdl_tpu_torch.visualization import TrainSummary

    cfg = CHECKPOINT_TRAIN
    rs = np.random.RandomState(0)
    ids = rs.randint(0, TRAIN["vocab"], (TRAIN_BATCH, TRAIN["seq_len"]))
    data = [MiniBatch(ids, ids)]
    writes, snaps = [], {}
    real_save_module, real_save = bt_file.save_module, bt_file.save

    def timed(real, kind):
        def run(obj, path, overwrite=False, snapshot=None):
            t_s = time.monotonic()
            real(obj, path, overwrite=overwrite, snapshot=snapshot)
            writes.append({"file": kind, "seconds": time.monotonic() - t_s,
                           "bytes": os.path.getsize(path)})
        return run

    def build():
        return TransformerLM(TRAIN["vocab"], TRAIN["embed_dim"],
                             TRAIN["heads"], TRAIN["layers"],
                             TRAIN["seq_len"], use_flash=True, seed=0,
                             device="cuda", dtype=torch.float32)

    def fires(state):
        return state["neval"] % 2 == 0 and state["neval"] <= cfg["last_ckpt"]

    def run(model, method, iters, path=None, summary=None):
        opt = Optimizer(model=model, dataset=data,
                        criterion=LMLoss(TRAIN["vocab"]),
                        batch_size=TRAIN_BATCH,
                        end_when=Trigger.max_iteration(iters))
        opt.set_optim_method(method).set_compute_dtype(torch.bfloat16)
        if path is not None:
            opt.set_checkpoint(path, fires, async_write=True)
            snapshot, stalls = opt._snapshot, []

            def recorded(slots):
                # device copies at the instant of the snapshot, to hold
                # the written files to
                tag = opt.optim_method.state["neval"] - 1
                snaps[tag] = ([p.detach().clone()
                               for p in opt.model.parameters()],
                              [a.clone() for a in slots[0]["accum"]],
                              dict(opt.optim_method.state))
                return snapshot(slots)

            checkpoint = opt._run_checkpoint

            def timed_checkpoint(state, slots):
                t_s = time.monotonic()
                checkpoint(state, slots)
                stalls.append(time.monotonic() - t_s)

            opt._snapshot = recorded
            opt._run_checkpoint = timed_checkpoint
            opt.stalls = stalls
        if summary is not None:
            opt.set_train_summary(summary)
        rows = logged("bigdl_tpu_torch.optim", opt.optimize)
        return opt, rows

    with tempfile.TemporaryDirectory() as tmp:
        bt_file.save_module = timed(real_save_module, "model")
        bt_file.save = timed(real_save, "optimMethod")
        try:
            summary = TrainSummary(tmp, "flagship")
            fa.launches = 0
            bwd_start(fa)
            t_s = time.monotonic()
            opt, rows = run(build(), RMSprop(cfg["lr"]), cfg["iterations"],
                            tmp, summary)
            run_s = time.monotonic() - t_s
            torch.cuda.synchronize()
            launches = fa.launches
            loss_rows = summary.read_scalar("Loss")
            summary.close()
            model, method, tag = load_latest_checkpoint(tmp, device="cuda")
            names = sorted(f for f in os.listdir(tmp) if "." in f
                           and not f.startswith("."))
        finally:
            bt_file.save_module, bt_file.save = real_save_module, real_save
    assert launches == TRAIN["layers"] * cfg["iterations"], launches
    bwd = bwd_end(fa, "checkpoint_train", launches)
    assert tag == cfg["last_ckpt"] - 1, (tag, names)
    want_p, want_s, want_state = snaps[tag]
    same_params = all(torch.equal(a.cpu(), b.cpu()) for a, b in
                      zip(model.parameters(), want_p))
    same_slots = all(torch.equal(a.cpu(), b.cpu()) for a, b in
                     zip(method._train_slots[0]["accum"], want_s))
    same_state = method.state == want_state
    fa.launches = 0
    bwd_start(fa)
    _, resumed = run(model, method, cfg["iterations"] - 1)
    resumed_launches = fa.launches
    resumed_bwd = bwd_end(fa, "checkpoint_train_resumed", resumed_launches)
    losses = [r[0] for r in rows]
    again = [r[0] for r in resumed]
    ref = losses[tag:tag + len(again)]
    resume_rel = max(abs(a - b) / abs(b) for a, b in zip(again, ref))
    step_ms = [TRAIN_BATCH / r[1] * 1e3 for r in rows]
    # a write is in flight during the iterations right after a checkpoint
    in_flight = [step_ms[t] for t in sorted(snaps) if t < len(step_ms)]
    quiet = [ms for i, ms in enumerate(step_ms[1:], 1)
             if i not in snaps]
    emit({"phase": "checkpoint_train", "nvidia_smi": smi,
          "config": {**TRAIN, "batch": TRAIN_BATCH,
                     "compute_dtype": "bfloat16", "masters": "float32",
                     "optimizer": f"RMSprop({cfg['lr']})",
                     "iterations": cfg["iterations"],
                     "checkpoints_after": sorted(snaps), "async": True},
          "files": names, "latest_tag": tag, "writes": writes,
          "checkpoint_bytes": sum(w["bytes"] for w in writes) // len(snaps),
          "loop_stall_s_at_checkpoint": opt.stalls,
          "step_ms": step_ms, "step_ms_write_in_flight": in_flight,
          "step_ms_no_write": quiet, "run_seconds": run_s,
          "losses": losses, "resumed_losses": again,
          "resume_max_rel": resume_rel, "resume_rtol": RESUME_RTOL,
          "loaded_equal": {"params": same_params, "slots": same_slots,
                           "state": same_state},
          "summary_loss_rows": len(loss_rows),
          "flash_launches": launches,
          "flash_launches_resumed": resumed_launches,
          "flash_backward_launches": bwd,
          "flash_backward_launches_resumed": resumed_bwd})
    assert same_params and same_slots and same_state
    assert resumed_launches == TRAIN["layers"] * len(again)
    assert len(again) == cfg["iterations"] - 1 - tag
    assert resume_rel <= RESUME_RTOL, (again, ref)
    assert [r[0] for r in loss_rows] == list(range(1, cfg["iterations"] + 1))
    np.testing.assert_allclose([r[2] for r in loss_rows], losses, rtol=1e-6)
    return launches


def _criterion_cases(np, nn, Table):
    """(name, criterion, input, target) on the host: every criterion of
    the port, f32."""
    rs = np.random.RandomState(0)
    r, c = 64, 10

    def f(*shape):
        return rs.randn(*shape).astype(np.float32)

    def probs(*shape):
        e = np.exp(f(*shape))
        return e / e.sum(-1, keepdims=True)

    def labels(*shape):
        return rs.randint(1, c + 1, shape).astype(np.float32)

    def sign(*shape):
        return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)

    def onehot():
        return np.eye(c, dtype=np.float32)[rs.randint(0, c, r)]

    multi = np.zeros((r, c), np.float32)
    for i in range(r):
        multi[i, :1 + i % 3] = rs.permutation(c)[:1 + i % 3] + 1
    tmask = labels(r, 4)
    tmask[:, -1] = 0
    return [
        ("ClassNLL", nn.ClassNLLCriterion(), np.log(probs(r, c)), labels(r)),
        ("CrossEntropy", nn.CrossEntropyCriterion(label_smoothing=0.1),
         f(r, c), labels(r)),
        ("CategoricalCrossEntropy", nn.CategoricalCrossEntropy(),
         probs(r, c), onehot()),
        ("MSE", nn.MSECriterion(), f(r, c), f(r, c)),
        ("Abs", nn.AbsCriterion(), f(r, c), f(r, c)),
        ("BCE", nn.BCECriterion(), 1 / (1 + np.exp(-f(r, c))),
         (rs.rand(r, c) > 0.5).astype(np.float32)),
        ("SmoothL1", nn.SmoothL1Criterion(), 2 * f(r, c), f(r, c)),
        ("DistKLDiv", nn.DistKLDivCriterion(), np.log(probs(r, c)),
         probs(r, c)),
        ("KLD", nn.KLDCriterion(), Table(f(r, c), 0.5 * f(r, c)), None),
        ("Gaussian", nn.GaussianCriterion(), Table(f(r, c), 0.5 * f(r, c)),
         f(r, c)),
        ("Margin", nn.MarginCriterion(squared=True), f(r, c), sign(r, c)),
        ("HingeEmbedding", nn.HingeEmbeddingCriterion(), f(r, c),
         sign(r, c)),
        ("L1HingeEmbedding", nn.L1HingeEmbeddingCriterion(40.0),
         Table(f(c), f(c)), np.float32(-1)),
        ("CosineEmbedding", nn.CosineEmbeddingCriterion(0.1),
         Table(f(r, c), f(r, c)), sign(r)),
        ("MarginRanking", nn.MarginRankingCriterion(), Table(f(r), f(r)),
         sign(r)),
        ("MultiMargin", nn.MultiMarginCriterion(p=2), f(r, c), labels(r)),
        ("MultiLabelMargin", nn.MultiLabelMarginCriterion(), f(r, c), multi),
        ("MultiLabelSoftMargin", nn.MultiLabelSoftMarginCriterion(),
         f(r, c), (rs.rand(r, c) > 0.5).astype(np.float32)),
        ("SoftMargin", nn.SoftMarginCriterion(), f(r, c), sign(r, c)),
        ("L1Cost", nn.L1Cost(), f(r, c), None),
        ("DotProduct", nn.DotProductCriterion(True), f(r, c), f(r, c)),
        ("CosineDistance", nn.CosineDistanceCriterion(), f(r, c), f(r, c)),
        ("CosineProximity", nn.CosineProximityCriterion(), f(r, c),
         f(r, c)),
        ("Poisson", nn.PoissonCriterion(), np.exp(f(r, c)), np.exp(f(r, c))),
        ("MeanAbsolutePercentage", nn.MeanAbsolutePercentageCriterion(),
         f(r, c), f(r, c)),
        ("MeanSquaredLogarithmic", nn.MeanSquaredLogarithmicCriterion(),
         np.exp(f(r, c)), np.exp(f(r, c))),
        ("KullbackLeiblerDivergence",
         nn.KullbackLeiblerDivergenceCriterion(), probs(r, c), probs(r, c)),
        ("DiceCoefficient", nn.DiceCoefficientCriterion(),
         1 / (1 + np.exp(-f(r, 4, 5))),
         (rs.rand(r, 4, 5) > 0.5).astype(np.float32)),
        ("ClassSimplex", nn.ClassSimplexCriterion(c), f(r, c), labels(r)),
        ("Parallel", nn.ParallelCriterion().add(nn.MSECriterion(), 0.5)
         .add(nn.AbsCriterion(), 2.0), Table(f(r, c), f(r)),
         Table(f(r, c), f(r))),
        ("Multi", nn.MultiCriterion().add(nn.MSECriterion())
         .add(nn.SmoothL1Criterion(), 0.3), f(r, c), f(r, c)),
        ("TimeDistributed", nn.TimeDistributedCriterion(
            nn.MSECriterion(), size_average=True), f(r, 3, c), f(r, 3, c)),
        ("PG", nn.PGCriterion(), probs(r, c), f(r, c)),
        ("ActivityRegularization", nn.ActivityRegularization(0.1, 0.2),
         f(r, c), None),
        ("SmoothL1WithWeights", nn.SmoothL1CriterionWithWeights(2.0, 3),
         f(r, c), Table(f(r, c), rs.rand(r, c).astype(np.float32),
                        rs.rand(r, c).astype(np.float32))),
        ("SoftmaxWith", nn.SoftmaxWithCriterion(ignore_label=2),
         f(4, c, 6, 7), labels(4, 6, 7)),
        ("TimeDistributedMask", nn.TimeDistributedMaskCriterion(
            nn.ClassNLLCriterion()), np.log(probs(r, 4, c)), tmask),
        ("Transformer", nn.TransformerCriterion(
            nn.MSECriterion(), nn.Tanh(), nn.Tanh()), f(r, c), f(r, c)),
    ]


def optim_criterion_gate(torch, smi) -> None:
    """optim_criterion_gate (f32, TF32 off): each new optim method trains
    a small model five steps through the train step on the card and on
    the CPU from the same weights and batch; the flat ``optimize`` of
    each, and LBFGS, on a quadratic; every criterion's forward and input
    gradient. Card against CPU within OPTIM_TOL / CRITERION_TOL: the
    same math, other reduction orders, and CUDA divides by a Python
    number through its reciprocal."""
    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.module import activity_tensors
    from bigdl_tpu_torch.optim import (LBFGS, Adadelta, Adagrad, Adamax,
                                       Ftrl, ParallelAdam, RMSprop,
                                       make_train_step)
    from bigdl_tpu_torch.utils.table import Table

    methods = {
        "Adagrad": lambda: Adagrad(0.05, weight_decay=0.01),
        "Adadelta": lambda: Adadelta(0.9, 1e-6),
        "Adamax": lambda: Adamax(0.01),
        "RMSprop": lambda: RMSprop(0.01),
        "Ftrl": lambda: Ftrl(0.1, l1_regularization_strength=0.01,
                             l2_regularization_strength=0.01),
        "ParallelAdam": lambda: ParallelAdam(0.01),
    }
    rs = np.random.RandomState(0)
    x = rs.randn(128, 64).astype(np.float32)
    y = rs.randint(1, 11, 128).astype(np.float32)
    a = rs.randn(16, 16).astype(np.float32)
    quad_a = a @ a.T / 16 + np.eye(16, dtype=np.float32)
    quad_b = rs.randn(16).astype(np.float32)
    rows = {}
    for name, make in methods.items():
        final = {}
        for dev in ("cpu", "cuda"):
            torch.manual_seed(0)
            model = nn.Sequential(nn.Linear(64, 32, device="cpu"), nn.Tanh(),
                                  nn.Linear(32, 10, device="cpu"),
                                  nn.LogSoftMax()).to(dev)
            ts = make_train_step(model, nn.ClassNLLCriterion(), make())
            params, buffers = model.params_dict(), model.buffers_dict()
            slots, lrs = ts.init_slots(params), ts.current_lrs()
            xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            for _ in range(5):
                loss, params, buffers, slots = ts.step(params, buffers, slots,
                                                       xd, yd, lrs, None)
            meth = make()
            qa, qb = (torch.from_numpy(quad_a).to(dev),
                      torch.from_numpy(quad_b).to(dev))
            xq = torch.zeros(16, device=dev)
            for _ in range(5):
                xq, _ = meth.optimize(lambda v: (0.5 * v @ (qa @ v) - qb @ v,
                                                 qa @ v - qb), xq)
            final[dev] = ([p.detach().cpu() for p in
                           (v for _, v in _leaves_of(params))], xq.cpu(),
                          float(loss))
        err = max(_rel_err(torch, c, g) for c, g in
                  zip(final["cpu"][0], final["cuda"][0]))
        flat = _rel_err(torch, final["cpu"][1], final["cuda"][1])
        rows[name] = {"params_max_rel": err, "flat_max_rel": flat,
                      "loss_cpu": final["cpu"][2],
                      "loss_cuda": final["cuda"][2]}
    lb = {}
    for dev in ("cpu", "cuda"):
        qa, qb = (torch.from_numpy(quad_a).to(dev),
                  torch.from_numpy(quad_b).to(dev))
        xq, losses = LBFGS(max_iter=30, learning_rate=0.5).optimize(
            lambda v: (0.5 * v @ (qa @ v) - qb @ v, qa @ v - qb),
            torch.zeros(16, device=dev))
        lb[dev] = (xq.cpu(), losses)
    rows["LBFGS"] = {"flat_max_rel": _rel_err(torch, lb["cpu"][0],
                                              lb["cuda"][0]),
                     "iterations_cpu": len(lb["cpu"][1]),
                     "iterations_cuda": len(lb["cuda"][1])}
    crit = {}
    for name, c, xi, ti in _criterion_cases(np, nn, Table):
        res = {}
        for dev in ("cpu", "cuda"):
            def put(v):
                if isinstance(v, Table):
                    return Table(*[torch.from_numpy(np.asarray(t)).to(dev)
                                   for t in v.values()])
                if v is None or np.ndim(v) == 0:
                    return v
                return torch.from_numpy(np.asarray(v)).to(dev)

            xd, td = put(xi), put(ti)
            value = float(c(xd, td))
            grads = [g.cpu() for g in activity_tensors(c.backward(xd, td))]
            res[dev] = (value, grads)
        crit[name] = {
            "value_rel": abs(res["cuda"][0] - res["cpu"][0])
            / max(abs(res["cpu"][0]), 1e-30),
            "grad_max_rel": max(_rel_err(torch, a_, b_) for a_, b_ in
                                zip(res["cpu"][1], res["cuda"][1]))}
    worst_optim = max(max(r.get("params_max_rel", 0.0), r["flat_max_rel"])
                      for r in rows.values())
    worst_crit = max(max(r["value_rel"], r["grad_max_rel"])
                     for r in crit.values())
    emit({"phase": "optim_criterion_gate", "nvidia_smi": smi,
          "dtype": "float32", "tf32": False, "optim": rows,
          "optim_tol": OPTIM_TOL, "criterions": len(crit),
          "criterion_worst": worst_crit, "criterion_tol": CRITERION_TOL,
          "criterion_rows": crit})
    assert worst_optim <= OPTIM_TOL, rows
    assert len(crit) == 38 and worst_crit <= CRITERION_TOL, crit


def _leaves_of(tree):
    from bigdl_tpu_torch.nn.module import tree_leaves

    return tree_leaves(tree)


def _rel_err(torch, ref, got) -> float:
    """max |got - ref| over max(max |ref|, 1e-30): one number a tensor."""
    ref, got = ref.float().cpu(), got.float().cpu()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
            ).item()


# ------------------------------------------------------------ slice 10
def _randomize_all_bn(torch, model, seed: int) -> None:
    """Random gamma in [0.5, 1.5), beta, running mean and variance in
    every BN of ``model`` (any BatchNormalization)."""
    from bigdl_tpu_torch.nn import BatchNormalization

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormalization):
                n, dev = m.n_output, m.running_mean.device
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean = (0.1 * torch.randn(n, generator=g)).to(dev)
                m.running_var = (torch.rand(n, generator=g) * 1.5
                                 + 0.5).to(dev)


def _zoo_cases():
    """(name, make(device), input shape, criterion, NHWC input, the
    update's tolerance): every zoo model at full width, at the gate's
    batch sizes."""
    from bigdl_tpu_torch import models as M

    return [
        ("vgg_cifar", lambda d: M.VggForCifar10(10, has_dropout=False,
                                                seed=0, device=d),
         (ZOO_GATE["vgg_cifar_batch"], 3, 32, 32), "nll", False,
         ZOO_UPDATE_RTOL),
        ("vgg16", lambda d: M.Vgg16(1000, has_dropout=False, seed=0,
                                    device=d),
         (ZOO_GATE["batch"], 3, 224, 224), "nll", False, ZOO_UPDATE_RTOL),
        ("inception_v1_noaux", lambda d: M.InceptionV1NoAuxClassifier(
            1000, has_dropout=False, seed=0, device=d),
         (ZOO_GATE["batch"], 3, 224, 224), "nll", False, ZOO_UPDATE_RTOL),
        ("inception_v1", lambda d: M.InceptionV1(1000, has_dropout=False,
                                                 seed=0, device=d),
         (ZOO_GATE["batch"], 3, 224, 224), "mse", False, ZOO_UPDATE_RTOL),
        ("mobilenet_nchw", lambda d: M.MobileNetV1(1000, seed=0, device=d),
         (ZOO_GATE["mobilenet_batch"], 3, 224, 224), "ce", False,
         UPDATE_RTOL),
        ("mobilenet_nhwc", lambda d: M.MobileNetV1(1000, format="NHWC",
                                                   seed=0, device=d),
         (ZOO_GATE["mobilenet_batch"], 3, 224, 224), "ce", True,
         UPDATE_RTOL),
        ("autoencoder", lambda d: M.Autoencoder(32, seed=0, device=d),
         (ZOO_GATE["autoencoder_batch"], 28, 28), "mse", False,
         ZOO_UPDATE_RTOL),
    ]


def _zoo_step(torch, model, crit, x, y):
    """(loss, [new - old for every parameter]) of one SGD step at
    learning rate 1: the update is the gradient, which the f32 rounding
    of ``new`` does not hide (at rate 0.01 an update is ~1e-4 of its
    weight, and storing the new weight in f32 alone moves it by ~1e-3)."""
    from bigdl_tpu_torch.nn.module import tree_leaves
    from bigdl_tpu_torch.optim import SGD, make_train_step

    ts = make_train_step(model, crit, SGD(learning_rate=1.0))
    p0, b0 = model.params_dict(), model.buffers_dict()
    loss, p1, _, _ = ts.step(p0, b0, ts.init_slots(p0), x, y,
                             ts.current_lrs(), None)
    return loss.item(), [(b - a).double().cpu() for (_, a), (_, b) in
                         zip(tree_leaves(p0), tree_leaves(p1))]


def _rel_l2(ours, ref) -> float:
    err = math.sqrt(sum(((a - b) ** 2).sum().item()
                        for a, b in zip(ours, ref)))
    return err / math.sqrt(sum((b ** 2).sum().item() for b in ref))


def zoo_gate(torch, fa, smi) -> int:
    """zoo_gate (f32, TF32 off): every zoo model on the card against the
    same model (the card's weights and random BN state) on the CPU in
    f64: eval outputs (InceptionV1's three heads each) within
    ``ZOO_EVAL_RTOL`` of the largest |output|; one SGD step's update,
    all parameters as one vector, within ``ZOO_UPDATE_RTOL`` in L2
    (MobileNet within ``UPDATE_RTOL``, the ill-conditioned bound of
    vision_gate; the CPU's own f32 step is read beside it); MobileNet
    NHWC against NCHW on the card. Returns the flash launches (0)."""
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, CrossEntropyCriterion,
                                    MSECriterion)

    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    fa.launches = 0
    crits = {"nll": ClassNLLCriterion, "ce": CrossEntropyCriterion,
             "mse": MSECriterion}
    rows, outs, failed = [], {}, []
    t0 = time.monotonic()
    for i, (name, build, shape, crit, nhwc, tol) in enumerate(
            _zoo_cases()):
        card = build("cuda")
        _randomize_all_bn(torch, card, seed=10)
        refs = {}
        for dtype in (torch.float64, torch.float32):
            ref = build("cpu")
            ref.load_params_dict(card.params_dict())
            ref.load_buffers_dict(card.buffers_dict())
            refs[dtype] = ref.to(dtype)
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(shape, generator=g)
        if nhwc:
            x = x.permute(0, 2, 3, 1).contiguous()
        with torch.no_grad():
            for m in (card, *refs.values()):
                m.evaluate()
            out_card = card(x.cuda()).cpu()
            out_ref = refs[torch.float64](x.double())
            torch.cuda.synchronize()
        outs[name] = out_card
        row = {"model": name, "input": list(shape), "nhwc": nhwc,
               "eval_max_rel": rel_diff(out_card, out_ref)}
        if name == "inception_v1":
            row["head_max_rel"] = {
                head: rel_diff(out_card[:, 1000 * k:1000 * (k + 1)],
                               out_ref[:, 1000 * k:1000 * (k + 1)])
                for k, head in enumerate(("main", "aux2", "aux1"))}
        for m in (card, *refs.values()):
            m.training_mode()
        if crit == "mse":
            y = (x.reshape(x.shape[0], -1) / 4.0 if name == "autoencoder"
                 else 0.1 * torch.randn(out_ref.shape, generator=g))
        else:
            y = torch.randint(1, out_ref.shape[-1] + 1, (shape[0],),
                              generator=g)
        steps = {}
        for key, model, dev, dtype in (
                ("card", card, "cuda", torch.float32),
                ("cpu_f64", refs[torch.float64], "cpu", torch.float64),
                ("cpu_f32", refs[torch.float32], "cpu", torch.float32)):
            yy = y.to(dtype) if y.is_floating_point() else y
            steps[key] = _zoo_step(torch, model, crits[crit](),
                                   x.to(dev, dtype), yy.to(dev))
        row.update(
            loss={k: v[0] for k, v in steps.items()},
            update_rel_l2=_rel_l2(steps["card"][1], steps["cpu_f64"][1]),
            cpu_f32_update_rel_l2=_rel_l2(steps["cpu_f32"][1],
                                          steps["cpu_f64"][1]),
            update_rtol=tol, eval_rtol=ZOO_EVAL_RTOL)
        if (row["eval_max_rel"] > ZOO_EVAL_RTOL
                or max(row.get("head_max_rel", {0: 0}).values())
                > ZOO_EVAL_RTOL or row["update_rel_l2"] > tol
                or not all(map(math.isfinite, row["loss"].values()))):
            failed.append(name)
        rows.append(row)
        del card, refs, steps
        torch.cuda.empty_cache()
    nhwc_rel = rel_diff(outs["mobilenet_nhwc"], outs["mobilenet_nchw"])
    emit({"phase": "zoo_gate", "nvidia_smi": smi, "dtype": "float32",
          "allow_tf32": False, "reference": "the port on the CPU in f64",
          "update_tol": "||d_card - d_cpu_f64|| / ||d_cpu_f64|| over all "
                        "parameters, d = new - old, SGD(1.0)",
          "models": rows, "mobilenet_nhwc_vs_nchw_max_rel": nhwc_rel,
          "seconds": time.monotonic() - t0, "flash_launches": fa.launches})
    assert not failed, failed
    assert nhwc_rel <= ZOO_EVAL_RTOL, nhwc_rel
    assert fa.launches == 0, fa.launches
    return fa.launches


def zoo_train(torch, fa, smi) -> dict:
    """zoo_train: ``run_perf`` at full width, bf16 over f32 masters, for
    VGG-16, Inception v1 and MobileNetV1 (``ZOO_TRAIN``): ms/step,
    images/s, peak memory, analytic MFU (FLOPs from the built model's
    convolution and linear shapes, checked against the published MACs),
    then one profiled step each (launches, device busy share, top
    kernels, ATen's passes against the rest). Returns images/s by
    model."""
    from bigdl_tpu_torch.models.perf import analytic_macs, run_perf
    from bigdl_tpu_torch.utils.profiling import device_profile

    fa.launches = 0
    warm, steps = ZOO_TRAIN_STEPS
    ips = {}
    for name, batch, fmt in ZOO_TRAIN:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        perf = run_perf(name, batch_size=batch, iterations=steps,
                        warmup=warm, dtype=torch.bfloat16, format=fmt,
                        master_f32=True, log=lambda *_: None, device="cuda",
                        profile=lambda fn: device_profile(fn, top=400))
        peak = torch.cuda.max_memory_allocated()
        prof = perf.pop("profile")
        kernels = prof.pop("top_kernels_ms")
        aten_ms = sum(k[1] for k in kernels if "at::native" in k[0])
        var_mean_ms = sum(op[2] for op in prof["top_ops_ms"]
                          if op[0] == "aten::var_mean")
        macs = perf["flops_per_iter"] / (6.0 * batch)
        mfu = perf["flops_per_iter"] / (perf["ms_per_iter"] / 1e3) / \
            PEAK_FLOPS["bfloat16"]
        ips[name] = perf["records_per_sec"]
        emit({"phase": "zoo_train", "nvidia_smi": smi,
              "config": {"model": name, "batch": batch, "format": fmt,
                         "compute_dtype": "bfloat16", "masters": "float32",
                         "optimizer": "SGD(0.01)"},
              "warmup_steps": warm, "timed_steps": steps,
              "ms_per_step": perf["ms_per_iter"],
              "images_per_s": perf["records_per_sec"],
              "peak_memory_gb": peak / 1e9, "losses": perf["losses"],
              "analytic_macs_per_image": macs,
              "published_macs_per_image": PUBLISHED_MACS[name],
              "analytic_flops_per_step": perf["flops_per_iter"],
              "analytic_mfu": mfu, "mfu_peak": "989 TFLOP/s bf16 (H100 SXM)",
              "timer": perf["timer"], "warmup_s": perf["warmup_s"]})
        prof.update(top_kernels_ms=kernels[:12],
                    top_ops_ms=prof["top_ops_ms"][:12],
                    distinct_kernels=len(kernels), aten_kernel_ms=aten_ms,
                    other_kernel_ms=prof["device_kernel_ms"] - aten_ms,
                    var_mean_ms=var_mean_ms,
                    device_busy_share=1.0 - prof["device_idle_share"])
        emit({"phase": "zoo_profile", "nvidia_smi": smi,
              "window": f"one {name} train step, batch {batch} {fmt} bf16",
              **prof})
        assert len(perf["losses"]) == warm + steps
        assert all(map(math.isfinite, perf["losses"])), perf["losses"]
        assert abs(macs / PUBLISHED_MACS[name] - 1.0) <= MACS_RTOL, \
            (name, macs)
    assert fa.launches == 0, fa.launches
    return ips


def _synth_digits(np, n, rng, size=28):
    """A learnable 10-class image set: each class lights its own block."""
    labels = rng.randint(0, 10, n)
    imgs = rng.randint(0, 40, (n, size, size)).astype(np.uint8)
    for i, lab in enumerate(labels):
        r, c = divmod(int(lab), 4)
        imgs[i, 6 * r + 1:6 * r + 5, 7 * c + 1:7 * c + 5] += 180
    return imgs, labels.astype(np.uint8)


def _run_main(torch, main, argv):
    """(model, the loop's (loss, records/s) rows, seconds) of one main."""
    out = {}
    t0 = time.monotonic()
    rows = logged("bigdl_tpu_torch.optim",
                  lambda: out.setdefault("model", main(argv)))
    torch.cuda.synchronize()
    return out["model"], rows, time.monotonic() - t0


def _params_equal(torch, a, b) -> bool:
    from bigdl_tpu_torch.nn.module import tree_leaves

    pa, pb = tree_leaves(a.params_dict()), tree_leaves(b.params_dict())
    return len(pa) == len(pb) and all(
        x.device == y.device and torch.equal(x, y)
        for (_, x), (_, y) in zip(pa, pb))


def zoo_mains(torch, fa, smi) -> int:
    """zoo_mains: the train and test mains through their argument parsers
    on the card, on files the phase writes: vgg.train (and vgg.test) and
    resnet.train on CIFAR binary batches, lenet.train then lenet.test on
    MNIST idx files, imagenet_gen over a folder of .npy images then
    inception.train on its records. Each train main runs one epoch with
    a checkpoint at its end, then again with ``--resume``: no iteration
    is left, so the resumed model must equal the first run's bit for bit
    and the checkpoint's. Returns the flash launches (0)."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch.dataset import cifar, mnist
    from bigdl_tpu_torch.models import imagenet_gen
    from bigdl_tpu_torch.models.inception import train as inception_train
    from bigdl_tpu_torch.models.lenet import test as lenet_test
    from bigdl_tpu_torch.models.lenet import train as lenet_train
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    from bigdl_tpu_torch.models.vgg import test as vgg_test
    from bigdl_tpu_torch.models.vgg import train as vgg_train
    from bigdl_tpu_torch.optim import load_latest_checkpoint

    fa.launches = 0
    cfg = ZOO_MAINS
    rs = np.random.RandomState(0)
    rec, bad = {"nvidia_smi": smi, "phase": "zoo_mains"}, []
    with tempfile.TemporaryDirectory() as tmp:
        cdir, mdir = os.path.join(tmp, "cifar"), os.path.join(tmp, "mnist")
        os.makedirs(cdir)
        os.makedirs(mdir)
        n = cfg["cifar_images"]
        labels = rs.randint(0, 10, n + n // 4).astype(np.uint8)
        imgs = rs.randint(0, 40, (n + n // 4, 3, 32, 32)).astype(np.uint8)
        for i, lab in enumerate(labels):
            imgs[i, :, 3 * int(lab):3 * int(lab) + 3, :] += 180
        cifar.write_batch(os.path.join(cdir, "data_batch_1.bin"),
                          imgs[:n], labels[:n])
        cifar.write_batch(os.path.join(cdir, "test_batch.bin"),
                          imgs[n:], labels[n:])
        n = cfg["mnist_images"]
        imgs, labels = _synth_digits(np, n + n // 4, rs)
        for split, sl in (("train", slice(0, n)), ("t10k", slice(n, None))):
            mnist.write_images(os.path.join(mdir, f"{split}-images-idx3-ubyte"),
                               imgs[sl])
            mnist.write_labels(os.path.join(mdir, f"{split}-labels-idx1-ubyte"),
                               labels[sl])
        folder = os.path.join(tmp, "folder")
        side = cfg["folder_side"]
        for c in ("class_a", "class_b"):
            os.makedirs(os.path.join(folder, c))
            for i in range(cfg["folder_per_class"]):
                np.save(os.path.join(folder, c, f"{i:03d}.npy"),
                        rs.randint(0, 255, (side, side, 3)).astype(np.uint8))
        records = os.path.join(tmp, "records")
        t0 = time.monotonic()
        shards = imagenet_gen.main(["-f", folder, "-o", records, "-p", "4",
                                    "--resize", str(side)])
        rec["imagenet_gen"] = {"images": 2 * cfg["folder_per_class"],
                               "side": side, "shards": len(shards),
                               "seconds": time.monotonic() - t0}

        b = cfg["batch"]
        runs = [
            ("vgg", vgg_train.main, ["-f", cdir, "-b", str(b)],
             cfg["cifar_images"] // b),
            ("resnet", resnet_train.main,
             ["-f", cdir, "--dataset", "cifar10", "--depth", "20", "-b",
              str(b)], cfg["cifar_images"] // b),
            ("lenet", lenet_train.main, ["-f", mdir, "-b", str(b)],
             cfg["mnist_images"] // b),
            ("inception", inception_train.main,
             ["-f", records, "-b", str(cfg["inception_batch"]),
              "--classes", "2", "-r", "0.01"],
             2 * cfg["folder_per_class"] // cfg["inception_batch"]),
        ]
        snaps = {}
        for name, main, argv, iters in runs:
            ckpt = os.path.join(tmp, f"ckpt_{name}")
            common = argv + ["--device", "cuda", "--max-iteration",
                             str(iters), "--checkpoint", ckpt, "--overwrite"]
            model, rows, secs = _run_main(torch, main, common)
            resumed, rows2, secs2 = _run_main(torch, main,
                                              common + ["--resume"])
            saved, method, tag = load_latest_checkpoint(ckpt, device="cuda")
            losses = [r[0] for r in rows]
            row = {"iterations": len(rows), "losses": losses,
                   "records_per_s_logged_median":
                       float(np.median([r[1] for r in rows])),
                   "seconds": secs, "checkpoint_tag": tag,
                   "resumed_iterations": len(rows2),
                   "resume_seconds": secs2,
                   "resumed_equals_run": _params_equal(torch, resumed, model),
                   "checkpoint_equals_run": _params_equal(torch, saved,
                                                          model),
                   "device": str(next(model.parameters()).device)}
            rec[name] = row
            if (len(rows) != iters or not all(map(math.isfinite, losses))
                    or tag != iters or rows2 or row["device"] != "cuda:0"
                    or not row["resumed_equals_run"]
                    or not row["checkpoint_equals_run"]):
                bad.append(name)
            snap = os.path.join(tmp, f"{name}.model")
            model.save(snap)
            snaps[name] = snap
        for name, main, folder_ in (("lenet_test", lenet_test.main, mdir),
                                    ("vgg_test", vgg_test.main, cdir)):
            t0 = time.monotonic()
            results = main(["-f", folder_, "--model",
                            snaps[name.split("_")[0]], "-b", str(b),
                            "--device", "cuda"])
            top1 = results[0][1].result()[0]
            rec[name] = {"top1": top1, "seconds": time.monotonic() - t0}
            if not 0.0 <= top1 <= 1.0:
                bad.append(name)
    rec["flash_launches"] = fa.launches
    emit(rec)
    assert not bad, bad
    assert fa.launches == 0, fa.launches
    return fa.launches


def input_pipeline(torch, fa, smi, inception_ips: float) -> int:
    """input_pipeline: ``run_input_pipeline_perf`` (records -> the
    ImageNet augment chain -> minibatches -> the pinned copy onto the
    card, at prefetch depths 0, 2, 4: the composed chain read by the C++
    reader and by the Python pool, the fused transform through the C++
    kernel and through its numpy twin, the kernel on 4 workers), each
    row's records/s beside the images/s zoo_train's Inception step
    consumes. Fails when the native runtime did not build on this
    machine, when a row that asked for the C++ reader or kernel did not
    run it, or when the fused transform does not call the kernel for
    every image with the numpy path's bytes. Returns the flash launches
    (0)."""
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.models.perf import run_input_pipeline_perf

    fa.launches = 0
    t0 = time.monotonic()
    built = native.native_available()
    emit({"phase": "native_build", "available": built,
          "reason": native.unavailable_reason(),
          "library": os.path.relpath(native.library_path(), ROOT),
          "compiler": native.compiler(), "flags": list(native.CXX_FLAGS),
          "seconds": time.monotonic() - t0})
    assert built, native.unavailable_reason()
    augment = native_augment_check()
    notes = []
    t0 = time.monotonic()
    rows = run_input_pipeline_perf(**PIPELINE, log=notes.append,
                                   device="cuda")
    for r in rows:
        r["inception_images_per_s"] = inception_ips
        r["feed_over_demand"] = r["records_per_sec"] / inception_ips
    emit({"phase": "input_pipeline", "nvidia_smi": smi, "config": PIPELINE,
          "host_cpus": os.cpu_count(), "native_augment_check": augment,
          "rows": rows, "notes": notes, "seconds": time.monotonic() - t0})
    assert rows and all(r["records"] == PIPELINE["n_records"] for r in rows)
    for r in rows:
        assert r["native_reader"] == r["asked"]["native_reader"], r
        assert r["fused_augment"] == r["asked"]["native_augment"], r
    assert any(r["augment_workers"] > 1 for r in rows) or \
        (os.cpu_count() or 1) < 2
    assert fa.launches == 0, fa.launches
    return fa.launches


# ------------------------------------------------------------ slice 11
#: the CLI runs of perf_cli: (name, argv); decode runs at the JAX
#: defaults (the serving flagship's width: batch 8, prompt 128, 128 new
#: tokens, vocab 32000, embed 512, 8 layers, 8 heads), bf16
#: the decode runs make 32 new tokens (the CLI's default 128 cut, in two
#: steps, to keep the whole script inside its time limit)
PERF_DECODE = ["--decode", "--dtype", "bfloat16", "--batch-size", "8",
               "--new-tokens", "32"]
PERF_CLI_RUNS = [
    ("train_transformer", ["--model", "transformer", "--dtype", "bfloat16",
                           "--master-f32", "--iterations", "5"]),
    ("decode", PERF_DECODE),
    ("decode_int8", PERF_DECODE + ["--int8"]),
    ("decode_speculative_2", PERF_DECODE + ["--speculative", "2"]),
    ("decode_speculative_int8", PERF_DECODE + ["--speculative-int8"]),
    ("input_pipeline", ["--input-pipeline", "--records", "128",
                        "--batch-size", "32"]),
]
#: bench.py's ResNet-50 configuration through the CLI
RESNET_CLI = ["--model", "resnet50", "--batch-size", "256", "--dtype",
              "bfloat16", "--format", "NHWC", "--master-f32",
              "--iterations", "10"]
#: run_perf's default warm-up steps (the CLI passes none)
PERF_WARMUP = 3
#: bench.py's vs_baseline: ours / (VS_REF_SHARE x the raw step's)
VS_REF_SHARE = 0.70
VARIANTS_RTOL = 1e-5


def _cli_row(torch, perf, argv):
    """Run ``perf.main(argv)`` on the card and return the JSON of its
    last printed line and the seconds it took."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        perf.main(argv)
    torch.cuda.synchronize()
    return (json.loads(buf.getvalue().strip().splitlines()[-1]),
            time.monotonic() - t0)


def _trace_kernels(path) -> int:
    """CUDA kernel events in a Chrome trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel")


def perf_cli(torch, fa, smi) -> int:
    """perf_cli: ``python -m bigdl_tpu_torch.models.perf`` through
    ``main(argv)``, each printed JSON row read back, the bench history
    pointed at a temporary file: (a) the training flagship (its flash
    launches counted from 0 and held to layers x (warm-up + timed
    steps)); (b) ``bench.py``'s ResNet-50 with ``--profile`` (the trace
    must hold CUDA kernel events) and the same run without it; (c) the
    four decode runs (rates finite and positive, accept rates in [0,
    1]); (d) the input pipeline; (e) the raw-torch ResNet-50 step at
    batch 256 and ``vs_ref = ours / (0.70 x ref)``, printed, not
    asserted. Returns the flash launches of (a); every other run
    launches none, checked."""
    import glob
    import tempfile

    from bigdl_tpu_torch.models import perf, torch_resnet_ref

    rows = {}
    saved = os.environ.get("BIGDL_BENCH_HISTORY")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["BIGDL_BENCH_HISTORY"] = os.path.join(tmp, "h.jsonl")
        try:
            launches = {}
            for name, argv in PERF_CLI_RUNS:
                fa.launches = 0
                bwd_start(fa)
                rows[name], secs = _cli_row(torch, perf, argv)
                launches[name] = fa.launches
                if name == "train_transformer":
                    bwd_end(fa, "perf_cli", fa.launches)
                else:
                    assert (fa.backward_launches
                            == fa.plain_backward_cuda_calls == 0), name
                if isinstance(rows[name], dict):
                    rows[name]["seconds"] = secs
            trace_dir = os.path.join(tmp, "trace")
            fa.launches = 0
            rows["resnet50_profiled"], _ = _cli_row(
                torch, perf, RESNET_CLI + ["--profile", trace_dir])
            rows["resnet50"], _ = _cli_row(torch, perf, RESNET_CLI)
            traces = glob.glob(os.path.join(trace_dir, "*.json"))
            trace_kernels = _trace_kernels(traces[0]) if traces else 0
            trace_mb = (os.path.getsize(traces[0]) / 2 ** 20 if traces
                        else 0.0)
            ref = torch_resnet_ref.run_ref_perf(batch_size=256,
                                                log=lambda *_: None,
                                                device="cuda")
            launches["resnet50_and_ref"] = fa.launches
            with open(os.environ["BIGDL_BENCH_HISTORY"]) as f:
                history_rows = sum(1 for _ in f)
        finally:
            if saved is None:
                os.environ.pop("BIGDL_BENCH_HISTORY", None)
            else:
                os.environ["BIGDL_BENCH_HISTORY"] = saved
    train = rows["train_transformer"]
    expect = TRAIN["layers"] * (PERF_WARMUP + 5)
    ours = rows["resnet50"]["records_per_sec"]
    emit({"phase": "perf_cli", "nvidia_smi": smi,
          "train_transformer": train,
          "flash_launches": launches["train_transformer"],
          "flash_launches_reckoned": expect,
          "reckoning": "layers x (run_perf's 3 warm-up + 5 timed steps), "
                       "no remat",
          "decode": {k: rows[k] for k in rows if k.startswith("decode")},
          "input_pipeline": rows["input_pipeline"],
          "resnet50": rows["resnet50"],
          "resnet50_profiled": rows["resnet50_profiled"],
          "trace_files": len(traces), "trace_kernel_events": trace_kernels,
          "trace_mb": trace_mb, "ref_resnet50": ref,
          "vs_ref": ours / (VS_REF_SHARE * ref["records_per_sec"]),
          "vs_ref_profiled": rows["resnet50_profiled"]["records_per_sec"]
          / (VS_REF_SHARE * ref["records_per_sec"]),
          "vs_ref_formula": "ours / (0.70 x ref), bench.py's vs_baseline",
          "history_rows": history_rows, "launches": launches})
    assert launches["train_transformer"] == expect, launches
    assert all(v == 0 for k, v in launches.items()
               if k != "train_transformer"), launches
    assert train["model"] == "transformer_lm" and all(
        map(math.isfinite, train["losses"])), train
    assert traces and trace_kernels > 0, (traces, trace_kernels)
    for name, row in rows.items():
        if name.startswith("decode"):
            for key in ("decode_tokens_per_sec", "prefill_tokens_per_sec",
                        "spec_tokens_per_sec"):
                if key in row:
                    assert math.isfinite(row[key]) and row[key] > 0, \
                        (name, key, row[key])
            if "spec_accept_rate" in row:
                assert 0.0 <= row["spec_accept_rate"] <= 1.0, row
            assert row["device"] == torch.cuda.get_device_name(0), row
    # the decode and pipeline rows went to the temporary history
    assert history_rows == 4 + len(rows["input_pipeline"]), history_rows
    assert all(r["records"] == 128 for r in rows["input_pipeline"])
    assert math.isfinite(ref["loss"]) and ref["records_per_sec"] > 0, ref
    return launches["train_transformer"]


def _variant_cases(tnn, torch):
    """(name, CPU module factory, input shape) for every conv and pooling
    variant and every new ``nn`` option of slice 11."""
    cpu = dict(device="cpu")
    rs = torch.Generator().manual_seed(3)
    w_init = torch.randn(24, 40, generator=rs)
    b_init = torch.randn(24, generator=rs)
    cw_init = torch.randn(16, 8, 3, 3, generator=rs)
    table = tnn.SpatialConvolutionMap.random(8, 12, 3, seed=5)
    return [
        ("SpatialDilatedConvolution", lambda: tnn.SpatialDilatedConvolution(
            16, 32, 3, 3, 2, 2, 2, 2, 2, 2, **cpu), (4, 16, 33, 31)),
        ("SpatialDilatedConvolution_same_nhwc",
         lambda: tnn.SpatialDilatedConvolution(
             16, 32, 3, 3, 2, 2, -1, -1, 2, 2, n_group=2, format="NHWC",
             **cpu), (4, 33, 31, 16)),
        ("SpatialShareConvolution", lambda: tnn.SpatialShareConvolution(
            16, 32, 3, 3, 1, 1, 1, 1, **cpu), (4, 16, 28, 28)),
        ("SpatialFullConvolution", lambda: tnn.SpatialFullConvolution(
            16, 24, 4, 4, 2, 2, 1, 1, 1, 1, n_group=2, **cpu),
         (4, 16, 15, 17)),
        ("SpatialFullConvolution_adj_at_stride",
         lambda: tnn.SpatialFullConvolution(16, 8, 3, 3, 1, 1, 1, 1, 1, 1,
                                            **cpu), (2, 16, 13, 11)),
        ("SpatialSeparableConvolution",
         lambda: tnn.SpatialSeparableConvolution(16, 32, 2, 3, 3, 2, 2, 1,
                                                 1, **cpu), (4, 16, 29, 27)),
        ("LocallyConnected2D", lambda: tnn.LocallyConnected2D(
            8, 15, 17, 12, 3, 3, 2, 2, 1, 1, **cpu), (4, 8, 17, 15)),
        ("TemporalConvolution", lambda: tnn.TemporalConvolution(
            64, 96, 5, 2, **cpu), (8, 101, 64)),
        ("VolumetricConvolution", lambda: tnn.VolumetricConvolution(
            8, 16, 3, 3, 3, 2, 1, 2, 1, 1, 1, **cpu), (2, 8, 9, 17, 15)),
        ("VolumetricFullConvolution", lambda: tnn.VolumetricFullConvolution(
            8, 6, 3, 3, 3, 2, 2, 2, 1, 1, 1, 1, 0, 1, n_group=2, **cpu),
         (2, 8, 5, 7, 6)),
        ("SpatialConvolutionMap", lambda: tnn.SpatialConvolutionMap(
            table, 3, 3, 2, 2, 1, 1, **cpu), (4, 8, 25, 23)),
        ("LocallyConnected1D", lambda: tnn.LocallyConnected1D(
            33, 16, 24, 4, 2, **cpu), (8, 33, 16)),
        ("TemporalMaxPooling", lambda: tnn.TemporalMaxPooling(4, 3),
         (8, 101, 32)),
        ("VolumetricMaxPooling", lambda: tnn.VolumetricMaxPooling(
            3, 3, 3, 2, 2, 2, 1, 1, 1), (2, 8, 9, 17, 15)),
        ("VolumetricMaxPooling_wide_pad", lambda: tnn.VolumetricMaxPooling(
            3, 3, 3, 2, 2, 2, 2, 2, 2), (2, 8, 9, 11, 10)),
        ("VolumetricAveragePooling", lambda: tnn.VolumetricAveragePooling(
            5, 5, 5, 3, 3, 3, 2, 2, 2), (2, 8, 11, 17, 15)),
        ("SpatialMaxPoolingWithIndices+SpatialUnpooling",
         lambda: tnn.Sequential(
             tnn.SpatialMaxPoolingWithIndices(4, 4, 2, 2, 1, 1).ceil(),
             tnn.SpatialUnpooling(4, 4, 2, 2, 1, 1)), (4, 16, 31, 29)),
        ("LayerNorm_no_affine", lambda: tnn.LayerNorm(512, affine=False,
                                                      **cpu),
         (8, 64, 512)),
        ("MultiHeadAttention_no_bias", lambda: tnn.MultiHeadAttention(
            512, 8, causal=True, num_kv_heads=2, with_bias=False, **cpu),
         (4, 128, 512)),
        ("Linear_init", lambda: tnn.Linear(40, 24, init_weight=w_init,
                                           init_bias=b_init, **cpu),
         (16, 40)),
        ("SpatialConvolution_init", lambda: tnn.SpatialConvolution(
            8, 16, 3, 3, 1, 1, 1, 1, init_weight=cw_init, init_bias=b_init[
                :16], **cpu), (4, 8, 19, 17)),
    ]


def variants_gate(torch, fa, smi) -> int:
    """variants_gate (f32, TF32 off): every conv and pooling variant of
    slice 11 and every new ``nn`` option (``LayerNorm(affine=False)``,
    ``MultiHeadAttention(with_bias=False)``, ``init_weight`` /
    ``init_bias``, ``dot_product_attention(mask=)``) on the card against
    the same module on the CPU with the same weights: the forward, the
    input gradient and every parameter gradient for one random
    cotangent, each within ``VARIANTS_RTOL`` of its largest |value|;
    ``SpatialMaxPoolingWithIndices``'s indices equal. Returns the flash
    launches (0)."""
    import copy

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.nn.module import tree_leaves

    fa.launches = 0
    g = torch.Generator().manual_seed(11)
    results = []
    worst = 0.0
    for name, factory, shape in _variant_cases(tnn, torch):
        cpu_m = factory()
        cpu_m.evaluate()
        with torch.no_grad():
            for pname, p in tree_leaves(cpu_m.params_dict()):
                if pname.endswith("bias"):
                    p.copy_(torch.randn(p.shape, generator=g))
        card_m = copy.deepcopy(cpu_m).cuda()
        x = torch.randn(shape, generator=g)
        errs = {}
        outs = []
        for m, dev in ((cpu_m, "cpu"), (card_m, "cuda")):
            xx = x.to(dev).requires_grad_(True)
            out = m(xx)
            ps = [p for _, p in tree_leaves(m.params_dict())]
            cot = torch.randn(out.shape, generator=torch.Generator()
                              .manual_seed(12)).to(dev)
            grads = torch.autograd.grad(out, [xx] + ps, cot)
            outs.append([out] + list(grads))
        names = ["forward", "input_grad"] + [
            "grad_" + n for n, _ in tree_leaves(cpu_m.params_dict())]
        for n, ref, got in zip(names, outs[0], outs[1]):
            errs[n] = _rel_err(torch, ref.detach(), got.detach())
        if name.startswith("SpatialMaxPoolingWithIndices"):
            pool = tnn.SpatialMaxPoolingWithIndices(4, 4, 2, 2, 1, 1).ceil()
            _, i_cpu = list(pool(x))
            _, i_card = list(pool(x.cuda()))
            errs["indices_equal"] = float(torch.equal(i_cpu, i_card.cpu()))
            assert errs["indices_equal"] == 1.0, name
        worst = max(worst, max(v for k, v in errs.items()
                               if k != "indices_equal"))
        results.append({"case": name, "shape": list(shape), **errs})
    # dot_product_attention with a mask (and a row that keeps no key)
    q, k, v = (torch.randn(4, 8, 128, 64, generator=g) for _ in range(3))
    mask = torch.rand(4, 1, 128, 128, generator=g) > 0.3
    mask[0, 0, 5] = False
    ref = tnn.dot_product_attention(q, k, v, causal=True, mask=mask)
    got = tnn.dot_product_attention(q.cuda(), k.cuda(), v.cuda(),
                                    causal=True, mask=mask.cuda())
    att = _rel_err(torch, ref, got)
    results.append({"case": "dot_product_attention_mask", "forward": att})
    worst = max(worst, att)
    assert (got[0, :, 5] == 0).all()
    emit({"phase": "variants_gate", "nvidia_smi": smi, "dtype": "float32",
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "rtol": VARIANTS_RTOL, "worst": worst, "cases": results})
    assert worst <= VARIANTS_RTOL, worst
    assert fa.launches == 0, fa.launches
    return fa.launches


# ------------------------------------------------------------ slice 12
#: text_train's runs of the text-classification main: (name, argv); the
#: JAX test's sizes, then the real corpus's width (news20.CLASS_NUM
#: classes, get_glove_w2v's default 100-dim vectors) over the synthetic
#: corpus
TEXT_TRAIN_RUNS = [
    ("jax_test_sizes", ["--samples", "96", "--class-num", "3",
                        "--max-epoch", "8"]),
    ("news20_width", ["--class-num", "20", "--embed-dim", "100",
                      "--samples", "2000"]),
]
#: the JAX test's bar on validation accuracy (tests/test_datasets_aux.py)
TEXT_ACC_MIN = 0.85
#: text_lm: BPE over the synthetic news20 text, scored and continued by
#: the serving flagship in bf16
TEXT_LM = dict(docs=2000, bpe_vocab=2000, batch=16, seq=128, new=32)


def _sweep_input(torch, *shape):
    """tests/test_layer_sweep.py's ``_f``: randn from RandomState(sum of
    the shape + its rank), f32."""
    import numpy as np

    rs = np.random.RandomState(sum(shape) + len(shape))
    return torch.tensor(rs.randn(*shape).astype(np.float32))


def _table_cases(tnn, torch, Table):
    """(name, CPU module factory, input builder) for every layer of
    slice 12 at the JAX sweep's arguments and inputs
    (tests/test_layer_sweep.py FIXTURES)."""
    import numpy as np

    cpu = dict(device="cpu")

    def f(*shape):
        return lambda: _sweep_input(torch, *shape)

    def pos(*shape):
        return lambda: _sweep_input(torch, *shape).abs() + 0.1

    def tab(*builders):
        return lambda: Table(*[b() for b in builders])

    ints = lambda: torch.tensor(np.random.RandomState(17).randint(  # noqa
        1, 5, size=(3,)), dtype=torch.int32)
    mask = lambda: torch.tensor(np.random.RandomState(3).rand(3, 4) > 0.5)  # noqa
    gater = lambda: torch.softmax(_sweep_input(torch, 2, 3), -1)  # noqa
    return [
        ("Masking", lambda: tnn.Masking(0.0), f(2, 3, 4)),
        ("Contiguous", lambda: tnn.Contiguous(), f(3, 4)),
        ("InferReshape", lambda: tnn.InferReshape((-1, 2)), f(3, 4)),
        ("Squeeze", lambda: tnn.Squeeze(2), f(3, 1, 4)),
        ("Unsqueeze", lambda: tnn.Unsqueeze(2), f(3, 4)),
        ("Transpose", lambda: tnn.Transpose(((2, 3),)), f(2, 3, 4)),
        ("Tile", lambda: tnn.Tile(2, 3), f(2, 3)),
        ("Replicate", lambda: tnn.Replicate(3, 2), f(2, 4)),
        ("Select", lambda: tnn.Select(2, 1), f(3, 4)),
        ("Narrow", lambda: tnn.Narrow(2, 1, 2), f(3, 6)),
        ("Reverse", lambda: tnn.Reverse(2), f(2, 5, 3)),
        ("Padding", lambda: tnn.Padding(2, 2, 2), f(3, 4)),
        ("Index", lambda: tnn.Index(1), tab(f(5, 4), ints)),
        ("MaskedSelect", lambda: tnn.MaskedSelect(), tab(f(3, 4), mask)),
        ("Max", lambda: tnn.Max(2), f(3, 4)),
        ("Min", lambda: tnn.Min(2), f(3, 4)),
        ("Mean", lambda: tnn.Mean(2), f(3, 4)),
        ("Sum", lambda: tnn.Sum(2), f(3, 4)),
        ("CAveTable", lambda: tnn.CAveTable(), tab(f(2, 4), f(2, 4))),
        ("CMaxTable", lambda: tnn.CMaxTable(), tab(f(2, 4), f(2, 4))),
        ("CMinTable", lambda: tnn.CMinTable(), tab(f(2, 4), f(2, 4))),
        ("CSubTable", lambda: tnn.CSubTable(), tab(f(2, 4), f(2, 4))),
        ("CDivTable", lambda: tnn.CDivTable(), tab(f(2, 4), pos(2, 4))),
        ("CMulTable", lambda: tnn.CMulTable(), tab(f(2, 4), f(2, 4))),
        ("DotProduct", lambda: tnn.DotProduct(), tab(f(3, 4), f(3, 4))),
        ("CosineDistance", lambda: tnn.CosineDistance(),
         tab(f(3, 4), f(3, 4))),
        ("PairwiseDistance", lambda: tnn.PairwiseDistance(),
         tab(f(3, 4), f(3, 4))),
        ("CrossProduct", lambda: tnn.CrossProduct(),
         tab(f(2, 4), f(2, 4), f(2, 4))),
        ("MM", lambda: tnn.MM(), tab(f(2, 3, 4), f(2, 4, 5))),
        ("MV", lambda: tnn.MV(), tab(f(2, 3, 4), f(2, 4))),
        ("JoinTable", lambda: tnn.JoinTable(2), tab(f(2, 3), f(2, 5))),
        ("SplitTable", lambda: tnn.SplitTable(2), f(2, 3, 4)),
        ("BifurcateSplitTable", lambda: tnn.BifurcateSplitTable(2), f(2, 6)),
        ("NarrowTable", lambda: tnn.NarrowTable(1, 2),
         tab(f(2, 3), f(2, 3), f(2, 3))),
        ("SelectTable", lambda: tnn.SelectTable(2), tab(f(2, 3), f(2, 5))),
        ("FlattenTable", lambda: tnn.FlattenTable(),
         tab(tab(f(2, 3), f(2, 3)), f(2, 3))),
        ("Pack", lambda: tnn.Pack(2), tab(f(2, 3), f(2, 3))),
        ("MixtureTable", lambda: tnn.MixtureTable(),
         tab(gater, tab(f(2, 4), f(2, 4), f(2, 4)))),
        ("SpatialZeroPadding", lambda: tnn.SpatialZeroPadding(1),
         f(1, 2, 4, 4)),
        ("Cropping2D", lambda: tnn.Cropping2D((1, 1), (1, 1)), f(1, 2, 6, 6)),
        ("Cropping3D", lambda: tnn.Cropping3D(), f(1, 2, 4, 6, 6)),
        ("UpSampling1D", lambda: tnn.UpSampling1D(2), f(2, 4, 3)),
        ("UpSampling2D", lambda: tnn.UpSampling2D((2, 2)), f(1, 2, 3, 3)),
        ("UpSampling3D", lambda: tnn.UpSampling3D(), f(1, 2, 2, 3, 3)),
        ("ResizeBilinear", lambda: tnn.ResizeBilinear(6, 6), f(1, 2, 4, 4)),
        ("ResizeBilinear_shrink", lambda: tnn.ResizeBilinear(3, 5),
         f(1, 2, 7, 9)),
        ("Add", lambda: tnn.Add(4, **cpu), f(3, 4)),
        ("CAdd", lambda: tnn.CAdd((1, 4), **cpu), f(3, 4)),
        ("CMul", lambda: tnn.CMul((1, 4), **cpu), f(3, 4)),
        ("Mul", lambda: tnn.Mul(**cpu), f(3, 4)),
        ("Bilinear", lambda: tnn.Bilinear(3, 4, 5, **cpu),
         tab(f(2, 3), f(2, 4))),
        ("Cosine", lambda: tnn.Cosine(4, 3, **cpu), f(2, 4)),
        ("Euclidean", lambda: tnn.Euclidean(4, 3, **cpu), f(2, 4)),
        ("Scale", lambda: tnn.Scale((1, 4), **cpu), f(3, 4)),
        ("ParallelTable", lambda: tnn.ParallelTable(
            tnn.Linear(4, 3, **cpu), tnn.Linear(5, 3, **cpu)),
         tab(f(2, 4), f(2, 5))),
        ("MapTable", lambda: tnn.MapTable(tnn.Linear(4, 3, **cpu)),
         tab(f(2, 4), f(2, 4))),
        ("Bottle", lambda: tnn.Bottle(tnn.Linear(4, 3, **cpu)), f(2, 5, 4)),
        ("TimeDistributed", lambda: tnn.TimeDistributed(
            tnn.Linear(5, 3, **cpu)), f(2, 4, 5)),
    ]


def table_gate(torch, fa, smi) -> int:
    """table_gate (f32, TF32 off): every table, shape, linear and
    container layer of slice 12 on the card against the same module on
    the CPU, on the JAX sweep's inputs with every parameter drawn from a
    seed: the forward and, for one random cotangent per output tensor,
    the autograd gradients of every float input and parameter, each
    within ``VARIANTS_RTOL`` of its largest |value|. Returns the flash
    launches (0)."""
    import copy

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.nn.module import (activity_tensors, tree_leaves,
                                           with_tensors)
    from bigdl_tpu_torch.utils.table import Table

    fa.launches = 0
    g = torch.Generator().manual_seed(21)
    results, classes = [], set()
    worst, worst_case = 0.0, None
    t0 = time.monotonic()
    for name, factory, build in _table_cases(tnn, torch, Table):
        cpu_m = factory()
        cpu_m.evaluate()
        with torch.no_grad():
            for _, p in tree_leaves(cpu_m.params_dict()):
                p.copy_(torch.randn(p.shape, generator=g))
        card_m = copy.deepcopy(cpu_m).cuda()
        classes |= {type(m).__name__ for m in cpu_m.modules()}
        x = build()
        outs = []
        for m, dev in ((cpu_m, "cpu"), (card_m, "cuda")):
            leaves = [t.to(dev).requires_grad_(t.is_floating_point())
                      for t in activity_tensors(x)]
            xx = with_tensors(x, iter(leaves))
            got = activity_tensors(m(xx))
            wrt = ([t for t in leaves if t.requires_grad]
                   + [p for _, p in tree_leaves(m.params_dict())])
            cg = torch.Generator().manual_seed(22)
            cots = [torch.randn(o.shape, generator=cg).to(dev) for o in got]
            grads = torch.autograd.grad(got, wrt, cots, allow_unused=True)
            outs.append([o.detach() for o in got] + [
                torch.zeros_like(w) if d is None else d
                for w, d in zip(wrt, grads)])
        errs = [_rel_err(torch, ref, got) for ref, got in zip(*outs)]
        case_worst = max(errs)
        if case_worst > worst:
            worst, worst_case = case_worst, name
        results.append({"case": name, "tensors": len(errs),
                        "worst": case_worst})
    emit({"phase": "table_gate", "nvidia_smi": smi, "dtype": "float32",
          "cases": len(results), "classes": sorted(classes),
          "rtol": VARIANTS_RTOL, "worst": worst, "worst_case": worst_case,
          "worst_excess": worst / VARIANTS_RTOL,
          "seconds": time.monotonic() - t0, "results": results})
    assert worst <= VARIANTS_RTOL, (worst_case, worst)
    assert fa.launches == 0, fa.launches
    return fa.launches


def text_train(torch, fa, smi) -> int:
    """text_train: the text-classification main
    (``bigdl_tpu_torch.example.textclassification.train.main``) on the
    card at the JAX test's sizes, where it must pass that test's bar,
    and at the real corpus's width over the synthetic corpus: ms a step,
    records/s and validation accuracy from the main's JSON summary.
    Returns the flash launches (0)."""
    import contextlib
    import io

    from bigdl_tpu_torch.example.textclassification import train

    fa.launches = 0
    runs = []
    for name, argv in TEXT_TRAIN_RUNS:
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            model, acc = train.main(argv + ["--device", "cuda"])
        seconds = time.monotonic() - t0
        summary = json.loads(out.getvalue().strip().splitlines()[-1])
        assert next(model.parameters()).device.type == "cuda"
        runs.append({"run": name, "argv": argv, "seconds": seconds,
                     **summary})
        assert summary["validation_accuracy"] == acc
        assert acc > TEXT_ACC_MIN, (name, acc)
        assert math.isfinite(summary["ms_per_step"]), summary
    emit({"phase": "text_train", "nvidia_smi": smi, "acc_min": TEXT_ACC_MIN,
          "runs": runs, "flash_launches": fa.launches})
    assert fa.launches == 0, fa.launches
    return fa.launches


def text_lm(torch, fa, smi) -> int:
    """text_lm: a ``BPETokenizer`` trained on the synthetic news20 text;
    the encoded documents (each cut or right-padded with <pad> to
    ``TEXT_LM["seq"]`` tokens) scored by the serving flagship's bf16
    ``forward`` (vocab 32000, the BPE ids inside it: one flash launch a
    layer), then ``generate`` continuing their first halves, whose rows
    must decode back to text beginning with the prompt's. Returns the
    flash launches of the phase."""
    import numpy as np

    from bigdl_tpu_torch.dataset import bpe, news20
    from bigdl_tpu_torch.models.transformer import TransformerLM

    cfg = TEXT_LM
    t0 = time.monotonic()
    texts = [t for t, _ in news20.synthetic_news20(
        n=cfg["docs"], class_num=news20.CLASS_NUM)]
    tok = bpe.BPETokenizer.train(texts, vocab_size=cfg["bpe_vocab"])
    bpe_s = time.monotonic() - t0
    assert tok.vocab_size <= FLAGSHIP["vocab_size"]
    ids = np.full((cfg["batch"], cfg["seq"]), bpe.PAD, np.int64)
    lengths = []
    for i, doc in enumerate(texts[:cfg["batch"]]):
        enc = tok.encode(doc, add_bos=True)[:cfg["seq"]]
        ids[i, :len(enc)] = enc
        lengths.append(len(enc))
    model = TransformerLM(**FLAGSHIP, seed=0, device="cuda",
                          dtype=torch.bfloat16)
    model.evaluate()
    x = torch.tensor(ids, device="cuda")
    fa.launches = 0
    with torch.inference_mode():
        logits = model(x)
        torch.cuda.synchronize()
        assert fa.launches == model.num_layers, fa.launches
        assert logits.shape == (cfg["batch"], cfg["seq"],
                                FLAGSHIP["vocab_size"])
        assert torch.isfinite(logits).all()
        fwd_ms = time_ms(torch, lambda: model(x), warmup=1, iters=3)
        # the mean next-token log-likelihood of the documents' own ids
        logp = torch.log_softmax(logits[:, :-1].float(), -1).gather(
            -1, x[:, 1:, None])[..., 0]
        mask = x[:, 1:] != bpe.PAD
        nll = float(-(logp * mask).sum() / mask.sum())
    half = min(lengths) // 2
    prompts = x[:, :half]
    t1 = time.monotonic()
    out = model.generate(prompts, cfg["new"])
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t1
    assert out.shape == (cfg["batch"], half + cfg["new"])
    decoded = [tok.decode(row.tolist()) for row in out.cpu()]
    heads = [tok.decode(row.tolist()) for row in prompts.cpu()]
    assert all(isinstance(d, str) and d.startswith(h)
               for d, h in zip(decoded, heads))
    launches = fa.launches
    emit({"phase": "text_lm", "nvidia_smi": smi, "config": cfg,
          "bpe_vocab_size": tok.vocab_size, "bpe_merges": len(tok.merges),
          "bpe_train_s": bpe_s, "doc_tokens": lengths,
          "forward_ms": fwd_ms,
          "tokens_per_s": cfg["batch"] * cfg["seq"] / fwd_ms * 1e3,
          "nll_random_weights": nll, "generate_s": gen_s,
          "generated_in_bpe_vocab": float(
              (out[:, half:] < tok.vocab_size).float().mean()),
          "sample": decoded[0][:200], "flash_launches": launches})
    assert launches >= 4 * model.num_layers, launches
    del model, logits
    return launches


# ------------------------------------------------------------- slice 13
def _lm_flagship(torch):
    from bigdl_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(TRAIN["vocab"], TRAIN["embed_dim"], TRAIN["heads"],
                         TRAIN["layers"], TRAIN["seq_len"], use_flash=True,
                         seed=0, device="cuda", dtype=torch.float32)


def _median_ms(rows, batch):
    """The median step ms of a loop's logged (loss, records/s) rows, the
    first (warm-up) iteration left out."""
    ms = [batch / r[1] * 1e3 for r in rows]
    return statistics.median(ms[1:] or ms)


def distri_train(torch, fa, smi) -> int:
    """distri_train: the training flagship (32 x 1024, bf16 compute over
    f32 masters, SGD with momentum) through ``Optimizer`` on a
    ``ShardedDataSet`` (the factory gives the DistriOptimizer) over the
    world-of-one NCCL group, in each mode, against the ``LocalOptimizer``
    on the same weights and batch. Returns the flash launches (8 an
    iteration)."""
    import numpy as np

    from bigdl_tpu_torch.dataset import MiniBatch, ShardedDataSet
    from bigdl_tpu_torch.models.perf import LMLoss
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.parallel import collectives as C

    cfg = DISTRI_TRAIN
    rs = np.random.RandomState(0)
    ids = rs.randint(0, TRAIN["vocab"], (TRAIN_BATCH, TRAIN["seq_len"]))
    p0 = [p.detach().clone() for p in _lm_flagship(torch).parameters()]

    def run(dataset, **kw):
        model = _lm_flagship(torch)
        opt = Optimizer(model=model, dataset=dataset,
                        criterion=LMLoss(TRAIN["vocab"]),
                        batch_size=TRAIN_BATCH,
                        end_when=Trigger.max_iteration(cfg["iterations"]),
                        **kw)
        opt.set_optim_method(SGD(learning_rate=cfg["lr"],
                                 momentum=cfg["momentum"], dampening=0.0))
        opt.set_compute_dtype(torch.bfloat16)
        fa.launches = 0
        bwd_start(fa)
        C.calls.clear()
        torch.cuda.reset_peak_memory_stats()
        rows = logged("bigdl_tpu_torch.optim", opt.optimize)
        torch.cuda.synchronize()
        return opt, model, {
            "step_ms": _median_ms(rows, TRAIN_BATCH),
            "losses": [r[0] for r in rows], "flash_launches": fa.launches,
            "flash_backward_launches": fa.backward_launches,
            "plain_backward_cuda_calls": fa.plain_backward_cuda_calls,
            "backend_calls": dict(C.calls),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}

    _, local, local_row = run([MiniBatch(ids, ids)])
    want = [p.detach() for p in local.parameters()]
    step = [a - b for a, b in zip(want, p0)]
    update = max(d.abs().max().item() for d in step)

    def over(params, wire):
        """The largest |w - w_local| over its allowance (passes <= 1)."""
        worst = 0.0
        for w, wl, d in zip(params, want, step):
            err = (w.detach() - wl).abs()
            allow = (2 ** -8 * wl.abs() + 2 ** -7 * d.abs() if wire
                     else DISTRI_F32_RTOL * update)
            worst = max(worst, torch.where(err == 0, 0.0, err / allow)
                        .max().item())
        return worst

    rows, launches = {}, 0
    for name, sync, wire in DISTRI_MODES:
        opt, model, row = run(
            ShardedDataSet([MiniBatch(ids, ids)]), parameter_sync=sync,
            compress_dtype=getattr(torch, wire) if wire else None)
        assert isinstance(opt, DistriOptimizer), type(opt)
        row.update({
            "max_abs_err_vs_local": max(
                (a.detach() - b).abs().max().item()
                for a, b in zip(model.parameters(), want)),
            "allowance": ("2^-8 |w_local| + 2^-7 |dw_local|" if wire else
                          DISTRI_F32_RTOL * update),
            "err_over_allowance": over(model.parameters(), wire),
            "unchanged_over_allowance": over(p0, wire),
            "step_ms_over_local": row["step_ms"] - local_row["step_ms"]})
        rows[name] = row
        launches += row["flash_launches"]
    emit({"phase": "distri_train", "nvidia_smi": smi,
          "config": {**TRAIN, "batch": TRAIN_BATCH, "world": 1,
                     "backend": "nccl", "compute_dtype": "bfloat16",
                     "masters": "float32", "iterations": cfg["iterations"],
                     "optimizer": f"SGD({cfg['lr']}, momentum "
                                  f"{cfg['momentum']})"},
          "local": local_row, "modes": rows, "max_update": update,
          "f32_rtol_of_update": DISTRI_F32_RTOL})
    per_run = TRAIN["layers"] * cfg["iterations"]
    assert local_row["flash_launches"] == per_run, local_row
    for name, row in [("local", local_row), *rows.items()]:
        assert row["flash_backward_launches"] == per_run, (name, row)
        assert row["plain_backward_cuda_calls"] == 0, (name, row)
    BWD_LAUNCHES["distri_train"] = per_run * (1 + len(rows))
    for name, row in rows.items():
        assert row["flash_launches"] == per_run, (name, row)
        assert row["err_over_allowance"] <= 1.0, (name, row)
        assert row["unchanged_over_allowance"] > 1.0, (name, row)
        assert row["backend_calls"], (name, "no NCCL call")
    return launches


def ring_one(torch, fa, smi) -> int:
    """The flash ring over the world-of-one NCCL group: one causal launch
    over the whole 2048 positions, equal to the kernel's own output."""
    from bigdl_tpu_torch.parallel import ring_attention
    from bigdl_tpu_torch.parallel import collectives as C

    cfg = RING
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(cfg["b"], cfg["h"], cfg["t"], cfg["d"], generator=g,
                    device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn(cfg["b"], cfg["h_kv"], cfg["t"], cfg["d"],
                        generator=g, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    fa.launches = 0
    out = ring_attention(q, k, v, None, causal=True, use_flash=True)
    torch.cuda.synchronize()
    launches = fa.launches
    same = torch.equal(out, fa.flash_attention(q, k, v, causal=True))
    emit({"phase": "ring_one", "nvidia_smi": smi, "world": 1,
          "transport": C.transport(None, q), "flash_launches": launches,
          "equal_to_one_kernel_call": same})
    assert launches == 1 and same
    return launches


def distri_main(torch, fa, smi) -> int:
    """distri_main: ``lenet/train.py --distributed`` at the world of one
    on the card: the sharded DistriOptimizer over the NCCL group."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch.dataset import mnist
    from bigdl_tpu_torch.models import train_utils
    from bigdl_tpu_torch.models.lenet import train as lenet_train
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.parallel import collectives as C

    built = []
    real = train_utils.build_optimizer

    def spy(*a, **k):
        built.append(real(*a, **k))
        return built[-1]

    fa.launches = 0
    C.calls.clear()
    rs = np.random.RandomState(3)
    with tempfile.TemporaryDirectory() as tmp:
        imgs, labels = _synth_digits(np, DISTRI_MAIN["images"], rs)
        for split in ("train", "t10k"):
            mnist.write_images(os.path.join(tmp, f"{split}-images-idx3-ubyte"),
                               imgs)
            mnist.write_labels(os.path.join(tmp, f"{split}-labels-idx1-ubyte"),
                               labels)
        train_utils.build_optimizer = spy
        try:
            model, rows, secs = _run_main(torch, lenet_train.main, [
                "-f", tmp, "-b", str(DISTRI_MAIN["batch"]),
                "--max-iteration", str(DISTRI_MAIN["iterations"]),
                "--distributed"])
        finally:
            train_utils.build_optimizer = real
    opt = built[0]
    losses = [r[0] for r in rows]
    emit({"phase": "distri_main", "nvidia_smi": smi, "main": "lenet.train",
          "argv": ["--distributed", "-b", DISTRI_MAIN["batch"],
                   "--max-iteration", DISTRI_MAIN["iterations"]],
          "optimizer": type(opt).__name__,
          "parameter_sync": opt.parameter_sync, "world": opt.n_data,
          "backend_calls": dict(C.calls), "seconds": secs,
          "losses": losses, "flash_launches": fa.launches})
    assert isinstance(opt, DistriOptimizer) and opt.n_data == 1
    assert len(losses) == DISTRI_MAIN["iterations"], losses
    assert all(math.isfinite(x) for x in losses)
    assert C.calls["reduce_scatter"] == DISTRI_MAIN["iterations"]
    assert fa.launches == 0
    return fa.launches


def world_of_one(torch, fa, smi):
    """distri_train, ring_one, distri_main and tp_one over a world-of-one
    NCCL group made with a FileStore, left when they end. Returns (the
    DistriOptimizer runs' launches, ring_one's, distri_main's,
    tp_one's)."""
    import tempfile

    from bigdl_tpu_torch.parallel import Engine

    with tempfile.TemporaryDirectory() as tmp:
        Engine.init(f"file://{tmp}/store", 1, 0, device="cuda")
        try:
            assert Engine.backend() == "nccl", Engine.backend()
            return (distri_train(torch, fa, smi), ring_one(torch, fa, smi),
                    distri_main(torch, fa, smi), tp_one(torch, fa, smi))
        finally:
            Engine.reset()


def ring_rank() -> int:
    """One rank of ring_gate, run by the launcher on the card
    (``chip_smoke.py --ring-rank``): its checks, then its record as one
    JSON line, the ranks printing in turn."""
    import torch

    sys.path.insert(0, ROOT)
    from bigdl_tpu_torch.ops import build
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.parallel import ring_attention, ulysses_attention
    from bigdl_tpu_torch.parallel import collectives as C

    rank, world = C.group_rank(None), C.group_size(None)
    rec = _ring_checks(torch, fa, build, C, ring_attention,
                       ulysses_attention, rank, world)
    for turn in range(world):
        C.barrier(None)
        if turn == rank:
            sys.stdout.write(json.dumps(rec) + "\n")
            sys.stdout.flush()
    return 0


def _ring_checks(torch, fa, build, C, ring_attention, ulysses_attention,
                 rank, world) -> dict:
    cfg = RING
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    full = {"q": torch.randn(cfg["b"], cfg["h"], cfg["t"], cfg["d"],
                             generator=g, device="cuda", dtype=bf16)}
    for n in ("k", "v"):
        full[n] = torch.randn(cfg["b"], cfg["h_kv"], cfg["t"], cfg["d"],
                              generator=g, device="cuda", dtype=bf16)
    d_out = torch.randn(cfg["b"], cfg["h"], cfg["t"], cfg["d"], generator=g,
                        device="cuda", dtype=torch.float32)
    blk = cfg["t"] // world
    rows = slice(rank * blk, (rank + 1) * blk)
    rec = {"rank": rank, "library": os.path.basename(build.load()._name),
           "transport": None}

    def block(x):
        return x[:, :, rows].detach().clone().requires_grad_(True)

    def reference(causal, q, k, v):
        """(out, dq, dk, dv) of one kernel call over the whole sequence
        and of the plain version, each cut to this rank's block."""
        res = {}
        for label in ("kernel", "plain"):
            qf, kf, vf = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            if label == "kernel":
                o = fa.flash_attention(qf, kf, vf, causal=causal)
            else:
                kx = kf.repeat_interleave(q.shape[1] // k.shape[1], 1)
                vx = vf.repeat_interleave(q.shape[1] // k.shape[1], 1)
                o = fa.flash_attention_reference(
                    qf.float(), kx.float(), vx.float(), causal)[0]
            (o.float() * d_out).sum().backward()
            res[label] = [t[:, :, rows] for t in
                          (o.detach(), qf.grad, kf.grad, vf.grad)]
        return res

    def held(got, ref, dtype="bfloat16"):
        errs = {"out": tol_excess(torch, got[0], ref[0], RTOL[dtype])}
        for gname, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
            errs[gname] = grad_excess(torch, a, b, BWD_RTOL[dtype])
        return errs

    def run(causal, flash, q, k, v, kind="ring"):
        qb, kb, vb = block(q), block(k), block(v)
        C.barrier(None)
        fa.launches = 0
        t0 = time.monotonic()
        if kind == "ring":
            o = ring_attention(qb, kb, vb, None, causal=causal,
                               use_flash=flash)
        else:
            o = ulysses_attention(qb, kb, vb, None, causal=causal)
        torch.cuda.synchronize()
        t_fwd = time.monotonic() - t0
        launches = fa.launches
        fa.backward_launches = fa.plain_backward_cuda_calls = 0
        (o.float() * d_out[:, :, rows]).sum().backward()
        torch.cuda.synchronize()
        t_all = time.monotonic() - t0
        rec["transport"] = C.transport(None, qb)
        return ([o.detach(), qb.grad, kb.grad, vb.grad],
                {"launches": launches,
                 "backward_launches": fa.backward_launches,
                 "plain_backward_cuda_calls": fa.plain_backward_cuda_calls},
                t_fwd * 1e3, t_all * 1e3)

    q, k, v = full["q"], full["k"], full["v"]
    for causal in (True, False):
        ref = reference(causal, q, k, v)
        tag = "causal" if causal else "noncausal"
        for flash in (True, False):
            got, counts, fwd_ms, all_ms = run(causal, flash, q, k, v)
            name = f"{'flash' if flash else 'dense'}_{tag}"
            rec[name] = {**counts, "fwd_ms": fwd_ms,
                         "fwd_bwd_ms": all_ms,
                         "vs_kernel": held(got, ref["kernel"]),
                         "vs_plain": held(got, ref["plain"])}
        # the same flash calls alone (no exchange, no merge), and one
        # exchange of the stacked K/V block, for the ring's overhead
        kv = torch.stack([k[:, :, rows], v[:, :, rows]])
        C.barrier(None)
        t0 = time.monotonic()
        srcs = [s for s in range(world) if not causal or s <= rank]
        for s in srcs:
            src_rows = slice(s * blk, (s + 1) * blk)
            fa.flash_attention_with_lse(q[:, :, rows], k[:, :, src_rows],
                                        v[:, :, src_rows],
                                        causal=causal and s == rank)
        torch.cuda.synchronize()
        rec[f"flash_{tag}"]["calls_alone_ms"] = (time.monotonic() - t0) * 1e3
        C.barrier(None)
        t0 = time.monotonic()
        C.ppermute(kv, None, 1)
        torch.cuda.synchronize()
        rec[f"flash_{tag}"]["one_exchange_ms"] = (time.monotonic() - t0) * 1e3
        # Ulysses: H 8 over the ranks (K/V expanded to 8 heads)
        rep = cfg["h"] // cfg["h_kv"]
        kx, vx = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        uref = reference(causal, q, kx, vx)
        got, counts, fwd_ms, all_ms = run(causal, False, q, kx, vx,
                                          kind="ulysses")
        rec[f"ulysses_{tag}"] = {**counts, "fwd_ms": fwd_ms,
                                 "fwd_bwd_ms": all_ms,
                                 "vs_kernel": held(got, uref["kernel"]),
                                 "vs_plain": held(got, uref["plain"])}
    # the flash ring in f32, as the long-context main runs it
    q, k, v = (torch.randn(x.shape, generator=g, device="cuda")
               for x in (q, k, v))
    for causal in (True, False):
        ref = reference(causal, q, k, v)
        got, counts, fwd_ms, all_ms = run(causal, True, q, k, v)
        rec[f"flash_f32_{'causal' if causal else 'noncausal'}"] = {
            **counts, "fwd_ms": fwd_ms, "fwd_bwd_ms": all_ms,
            "vs_kernel": held(got, ref["kernel"], "float32"),
            "vs_plain": held(got, ref["plain"], "float32")}
    return rec


def ring_gate(torch, fa, smi) -> int:
    """ring_gate: four ranks on the one card through the launcher over
    gloo (NCCL refuses two ranks on one device), each holding one
    512-position block of the serving flagship's attention (B 4, H 8,
    H_kv 2, T 2048, d 64): the flash ring, the dense ring and Ulysses in
    bf16, and the flash ring in f32, causal and not, forward and
    backward, held to one kernel call over all 2048 positions and to the
    plain version; the flash launches by rank as reckoned (causal rank r:
    r + 1; non-causal: 4). Returns the ring's launches."""
    import tempfile

    cfg = RING
    with tempfile.TemporaryDirectory() as tmp:
        ranks, secs = _launch(tmp, cfg["ranks"],
                              [os.path.join(ROOT, "chip_smoke.py"),
                               "--ring-rank"], RING_TIMEOUT_S)
    assert [r["rank"] for r in ranks] == list(range(cfg["ranks"])), ranks
    launches = {f"{ring}_{tag}": [r[f"{ring}_{tag}"]["launches"]
                                  for r in ranks]
                for ring in ("flash", "flash_f32")
                for tag in ("causal", "noncausal")}
    # a flash call's backward launches the backward kernels once; the
    # dense ring and Ulysses launch neither
    bwd = {name: [r[name]["backward_launches"] for r in ranks]
           for name in ranks[0] if isinstance(ranks[0][name], dict)
           and "backward_launches" in ranks[0][name]}
    plain = sum(r[name]["plain_backward_cuda_calls"] for r in ranks
                for name in bwd)
    worst = {}
    for rec in ranks:
        for key, row in rec.items():
            if isinstance(row, dict) and "vs_kernel" in row:
                for ref in ("vs_kernel", "vs_plain"):
                    for t, e in row[ref].items():
                        k = f"{key}.{ref}.{t}"
                        worst[k] = max(worst.get(k, 0.0), e)
    emit({"phase": "ring_gate", "nvidia_smi": smi,
          "shape": {k: cfg[k] for k in ("b", "h", "h_kv", "t", "d")},
          "ranks": cfg["ranks"], "block": cfg["t"] // cfg["ranks"],
          "dtypes": ["bfloat16", "float32 (flash_f32_*)"],
          "backend": "gloo", "transport": ranks[0]["transport"],
          "libraries": sorted({r["library"] for r in ranks}),
          "launches_by_rank": launches,
          "backward_launches_by_rank": bwd,
          "plain_backward_cuda_calls": plain,
          "rtol": {"out": RTOL, "grads": BWD_RTOL},
          "worst_excess": worst, "seconds": secs, "ranks_detail": ranks})
    for name, counts in launches.items():
        want = ([r + 1 for r in range(cfg["ranks"])]
                if name.endswith("_causal") else [cfg["ranks"]] * cfg["ranks"])
        assert counts == want, (name, counts)
    assert all(r["dense_causal"]["launches"] == 0 for r in ranks)
    for name, counts in bwd.items():
        assert counts == launches.get(name, [0] * cfg["ranks"]), (name,
                                                                  counts)
    assert plain == 0, ("the plain backward ran on the card", plain)
    BWD_LAUNCHES["ring_gate"] = sum(sum(c) for c in bwd.values())
    assert all(e < 1.0 for e in worst.values()), worst
    assert len({r["library"] for r in ranks}) == 1
    return sum(sum(c) for c in launches.values())


def _launch(tmp, procs, target, timeout):
    """``target`` (a script and its arguments, or ``-m``, a module and
    its arguments) through the launcher over ``procs`` ranks sharing the
    card over gloo, or alone (``procs`` 0): each rank's JSON line, by
    rank, and the seconds."""
    cmd = [sys.executable, *target]
    if procs:
        cmd[1:1] = ["-m", "bigdl_tpu_torch.tools.launch", "--procs",
                    str(procs), "--backend", "gloo", "--store-file",
                    os.path.join(tmp, f"store-{len(os.listdir(tmp))}")]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=timeout)
    secs = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    rows = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    return sorted(rows, key=lambda r: r["rank"]), secs


def _tp_reqs():
    """TP_REQS's prompts, the same on every rank (a numpy seed)."""
    import numpy as np

    rs = np.random.RandomState(7)
    return [(rs.randint(0, FLAGSHIP["vocab_size"], t0).astype(np.int32), n)
            for t0, n in TP_REQS]


def _tp_tier_reqs():
    """Three 128-token templates twice round-robin, each with its own
    short tail: with one device row every revisit demotes and promotes."""
    import numpy as np

    rs = np.random.RandomState(8)
    tpls = [rs.randint(0, FLAGSHIP["vocab_size"], 128) for _ in range(3)]
    return [(np.concatenate([tpls[i % 3], rs.randint(
        0, FLAGSHIP["vocab_size"], 8 + i % 2)]).astype(np.int32), 8)
        for i in range(6)]


def _serve_all(eng, reqs, concurrent: bool):
    """The rows of ``reqs`` through ``eng``: from one thread each, or in
    turn (int8 weights: the activation scale spans the batch)."""
    if not concurrent:
        return [eng.submit(p, n).result(timeout=300) for p, n in reqs]
    rows = [None] * len(reqs)

    def one(i):
        rows[i] = eng.submit(*reqs[i]).result(timeout=300)

    ts = [threading.Thread(target=one, args=(i,), daemon=True)
          for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return rows


def _tp_engine_rows(torch, C, mesh, leader, model32) -> dict:
    """The engine at tp 2 (f32) in each configuration on both ranks; on
    the leader, each configuration's rows against the unsharded engine's
    and the lone ``generate``'s (equal, or a near tie there), its
    messages and seconds, and the dense run's mesh block and ledger
    conservation. A follower runs the leader's programs."""
    from bigdl_tpu_torch.nn.quantized import Quantizer
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    reqs = _tp_reqs()
    base = dict(max_slots=TP["slots"], prefill_chunk=TP["chunk"])
    configs = [
        ("dense", {}, reqs, True),
        ("paged", {"page_size": TP["page"]}, reqs, True),
        ("int8_kv", {"kv_dtype": "int8"}, reqs, False),
        ("int8_weights", {"kv_dtype": "int8", "weights_dtype": "int8"},
         reqs, False),
        ("speculative", {"spec_gamma": TP["gamma"]}, reqs, True),
        ("host_tier", {"prefix_cache_rows": 1, "prefix_host_rows": 8},
         _tp_tier_reqs(), False),
    ]
    out = {}
    for name, kw, creqs, concurrent in configs:
        kw = dict(base, **kw)
        if name == "speculative":
            draft = Quantizer.quantize(model32)
            draft.evaluate()
            kw["draft"] = draft
        eng = ContinuousBatchingEngine(model32, mesh=mesh,
                                       service_name=f"tp_{name}", **kw)
        if not leader:
            eng.start()             # runs the leader's programs
            continue
        calls0, t0 = dict(C.calls), time.monotonic()
        with eng:
            rows = _serve_all(eng, creqs, concurrent)
            st = eng.stats()
        secs = time.monotonic() - t0
        msgs = {k: v - calls0.get(k, 0) for k, v in C.calls.items()
                if v - calls0.get(k, 0)}
        with ContinuousBatchingEngine(model32, **kw) as un:
            want = _serve_all(un, creqs, concurrent)
        rec = {"seconds": secs, "messages": msgs,
               "iterations": st["iterations"],
               "decode_steps": st["decode_steps"],
               "rows_equal_unsharded": sum(
                   bool((a == b).all()) for a, b in zip(rows, want)),
               "rows": len(rows)}
        if "int8" in name:
            # int8 rows are held to the unsharded int8 engine exactly
            assert rec["rows_equal_unsharded"] == len(rows), (name, rec)
        else:
            rec["near_ties"] = [t for t in (
                lone_mismatch(model32, p, n, r)
                for (p, n), r in zip(creqs, rows)) if t is not None]
        if name == "dense":
            out["mesh"] = st["mesh"]
            out["ledger_conservation"] = ledger_conservation(eng)
            out["usage_devices"] = st["usage"]["devices"]
        if name == "speculative":
            rec["speculation"] = st["speculation"]
        if name == "host_tier":
            pc = st["prefix_cache"]
            rec["demotions"], rec["promotions"] = (pc["demotions"],
                                                   pc["promotions"])
            assert pc["demotions"] >= 1 and pc["promotions"] >= 1, pc
        out[name] = rec
    # one preemption: a low decode in the only slot, then a high request
    eng = ContinuousBatchingEngine(model32, mesh=mesh, max_slots=1,
                                   prefill_chunk=TP["chunk"],
                                   preempt_slack_s=0.002,
                                   service_name="tp_preempt")
    if not leader:
        eng.start()
        return out
    victim, urgent = reqs[0][0], reqs[3][0][:48]
    with eng:
        h_low = eng.submit(victim, 48, priority="low")
        next(h_low.tokens())
        h_high = eng.submit(urgent, 8, priority="high")
        high, low = h_high.result(timeout=300), h_low.result(timeout=300)
    out["preemption"] = {
        "preempted": h_low.preempted,
        "near_ties": [t for t in (lone_mismatch(model32, urgent, 8, high),
                                  lone_mismatch(model32, victim, 48, low))
                      if t is not None]}
    assert h_low.preempted >= 1, out["preemption"]
    return out


def _tp_gate(torch, fa, C, mesh, leader) -> dict:
    """tp_gate on one rank: the sharded scoring forward (f32) through the
    flash kernel on the rank's heads against the unsharded forward and
    against the shard's plain attention; the bf16 flagship forward at tp
    2, timed; then the engine's configurations (``_tp_engine_rows``).
    ``launches`` counts the sharded paths' flash launches only."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.parallel.tp import shard_model

    f32, bf16 = torch.float32, torch.bfloat16
    vocab = FLAGSHIP["vocab_size"]
    g = torch.Generator(device="cuda").manual_seed(1)
    rec, launches = {}, 0
    model32 = TransformerLM(**FLAGSHIP, seed=0, device="cuda", dtype=f32)
    model32.evaluate()
    local = shard_model(model32, mesh)
    ids = torch.randint(0, vocab, (TP["gate_batch"], TP["gate_seq"]),
                        device="cuda", generator=g)
    with torch.inference_mode():
        fa.launches = 0
        got = local(ids)
        torch.cuda.synchronize()
        launches += fa.launches
        per_fwd = fa.launches
        want = model32(ids)
        for blk in local.blocks():
            blk.attn.use_flash = False
        plain = local(ids)
        for blk in local.blocks():
            blk.attn.use_flash = True
    attn = local.blocks()[0].attn
    rec["scoring_f32"] = {
        "batch": TP["gate_batch"], "seq": TP["gate_seq"],
        "local_heads": attn.num_heads, "local_kv_heads": attn.num_kv_heads,
        "launches_per_forward": per_fwd,
        "rel_vs_unsharded": rel_diff(got, want),
        "rel_vs_plain": rel_diff(got, plain), "rtol": TP_RTOL}
    assert per_fwd == FLAGSHIP["num_layers"], per_fwd
    assert rec["scoring_f32"]["rel_vs_unsharded"] <= TP_RTOL, rec
    assert rec["scoring_f32"]["rel_vs_plain"] <= RTOL["float32"], rec
    del got, want, plain, local
    model16 = TransformerLM(**FLAGSHIP, seed=0, device="cuda", dtype=bf16)
    model16.evaluate()
    local16 = shard_model(model16, mesh)
    ids16 = torch.randint(0, vocab, (TP["score_batch"], TP["score_seq"]),
                          device="cuda", generator=g)
    with torch.inference_mode():
        before, calls0 = fa.launches, dict(C.calls)
        logits = local16(ids16)
        torch.cuda.synchronize()
        n = 1
        t0 = time.monotonic()
        for _ in range(n):
            local16(ids16)
        torch.cuda.synchronize()
        sharded_ms = (time.monotonic() - t0) / n * 1e3
        sharded_launches = fa.launches - before
        launches += sharded_launches
        msgs = {k: (v - calls0.get(k, 0)) // (n + 1)
                for k, v in C.calls.items() if v - calls0.get(k, 0)}
        want16 = model16(ids16)
        whole_ms = time_ms(torch, lambda: model16(ids16), warmup=1, iters=3)
    rec["scoring_bf16"] = {
        "batch": TP["score_batch"], "seq": TP["score_seq"],
        "sharded_forward_ms": sharded_ms, "unsharded_forward_ms": whole_ms,
        "messages_per_forward": msgs,
        "launches": sharded_launches,
        "rel_vs_unsharded": rel_diff(logits, want16), "rtol": LOGIT_RTOL}
    assert rec["scoring_bf16"]["rel_vs_unsharded"] <= LOGIT_RTOL, rec
    del logits, want16, local16, model16
    rec["engine"] = _tp_engine_rows(torch, C, mesh, leader, model32)
    rec["launches"] = launches
    return rec


def _tp_serving(torch, C, mesh):
    """tp_serving on one rank: ``run_tp_comparison`` at tp 2 on a Poisson
    workload in bf16 and in f32 (the leader's results by dtype; None on
    the follower). In bf16 each row that parts from the unsharded leg's
    gets the unsharded model's teacher-forced margin between the two
    tokens at the first difference."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serving import run_tp_comparison

    out = {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        model = TransformerLM(**FLAGSHIP, seed=0, device="cuda",
                              dtype=dtype)
        model.evaluate()
        t0 = time.monotonic()
        res = run_tp_comparison(model, tp=TP["ranks"], mesh=mesh,
                                **TP_SERVING)
        if res is None:
            continue
        for leg in ("sharded", "unsharded"):
            res[leg]["iterations"] = res[leg].pop("stats")["iterations"]
            res[leg].pop("tenants", None)
        res["seconds"] = time.monotonic() - t0
        for blk in model.blocks():      # the margins' forward: no launch
            blk.attn.use_flash = False
        for m in res["mismatches"]:
            with torch.inference_mode():
                logits = model(torch.tensor([m.pop("prefix")],
                                            device="cuda"))[0, -1].float()
            m["unsharded_margin"] = (logits[m["unsharded_token"]]
                                     - logits[m["sharded_token"]]).item()
            m["top_logit"] = logits.max().item()
        out[name] = res
        del model
    return out or None


def _tp_ckpt_run(torch, path, fault_at=None) -> dict:
    """The two-rank DistriOptimizer of sharded_ckpt on the card: one
    record a rank (every epoch the same batch), an MLP, SGD with
    momentum, f32 on the wire, sharded slot checkpoints
    (``slots_backend="orbax"``) every ``TP_CKPT["every"]`` iterations;
    ``fault_at`` kills the loop once there, and it retries from its
    newest checkpoint."""
    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample, ShardedDataSet
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils import config as bt_config

    rs = np.random.RandomState(0)
    samples = [Sample(rs.randn(512).astype(np.float32), np.float32(1 + i))
               for i in range(2)]
    model = nn.Sequential(nn.Linear(512, 2048, device="cuda"), nn.Tanh(),
                          nn.Linear(2048, 8, device="cuda"),
                          nn.LogSoftMax())
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.as_tensor(rs.randn(*p.shape).astype(np.float32)
                                    * 0.05))
    opt = DistriOptimizer(model=model, dataset=ShardedDataSet(samples),
                          criterion=nn.ClassNLLCriterion(), batch_size=2,
                          end_when=Trigger.max_iteration(
                              TP_CKPT["iterations"]),
                          compress_dtype=None)
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9,
                             dampening=0.0))
    opt.set_checkpoint(path, Trigger.several_iteration(TP_CKPT["every"]),
                       slots_backend="orbax")
    fired = []
    if fault_at is not None:
        def hook(state):
            if state["neval"] >= fault_at and not fired:
                fired.append(state["neval"])
                raise RuntimeError("injected failure")

        opt._fault_hook = hook
    bt_config.set_property("bigdl.failure.retryTimes", 3)
    try:
        t0 = time.monotonic()
        model = opt.optimize()
        secs = time.monotonic() - t0
    finally:
        bt_config.clear_property("bigdl.failure.retryTimes")
    return {"params": [p.detach().clone() for p in model.parameters()],
            "fired": fired, "seconds": secs,
            "neval": opt.optim_method.state["neval"],
            "files": sorted(os.listdir(path))}


def _tp_ckpt(torch, rank) -> dict:
    """sharded_ckpt on one rank: the uninterrupted run and the run killed
    after a checkpoint and retried, their parameters equal bit for bit;
    the slot blocks this rank wrote."""
    import tempfile

    from bigdl_tpu_torch.parallel import collectives as C

    base = os.path.join(tempfile.gettempdir(), "chip_smoke_tp_ckpt")
    if rank == 0:
        import shutil

        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base)
    C.barrier(None)
    whole = _tp_ckpt_run(torch, os.path.join(base, "whole"))
    broken = _tp_ckpt_run(torch, os.path.join(base, "broken"),
                          TP_CKPT["fault_at"])
    equal = all(torch.equal(a, b)
                for a, b in zip(whole["params"], broken["params"]))
    orbax = [f for f in broken["files"] if f.endswith(".orbax")]
    blocks = sorted(f for f in os.listdir(os.path.join(
        base, "broken", orbax[-1])) if f.endswith(".distcp")) if orbax \
        else []
    rec = {"equal_bit_for_bit": equal, "fired": broken["fired"],
           "neval": [whole["neval"], broken["neval"]],
           "seconds": [whole["seconds"], broken["seconds"]],
           "orbax_files": orbax, "block_files": blocks,
           "pickled_slots": [f for f in broken["files"]
                             if f.startswith("optimSlots.")
                             and ".orbax" not in f]}
    assert equal and broken["fired"] == [TP_CKPT["fault_at"]], rec
    assert orbax and not rec["pickled_slots"], rec
    assert len(blocks) == TP["ranks"], rec
    return rec


def tp_rank(only_slice22: bool = False) -> int:
    """One rank of the tensor-parallel phases, run by the launcher on the
    card (``chip_smoke.py --tp-rank``): tp_gate, tp_serving and
    sharded_ckpt on a 2-way model mesh, then the slice-22 checks
    (``_slice22_rank``: the sequence-sharded decode, the 2-D int8 and
    MoE shards on meshes over the same world, the convergence cases),
    then the rank's record as one JSON line, the ranks printing in turn.
    ``only_slice22`` (``--tp-rank slice22``) runs the slice-22 checks
    alone."""
    import torch

    sys.path.insert(0, ROOT)
    from bigdl_tpu_torch.ops import build
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.parallel import collectives as C

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = build.build()
    rank, world = C.group_rank(None), C.group_size(None)
    mesh = Engine.create_mesh([("model", world)])
    leader = mesh.index("model") == 0
    rec = {"rank": rank, "library": os.path.basename(str(lib)),
           "transport": C.transport(mesh.group("model"),
                                    torch.empty(1, device="cuda"))}
    if not only_slice22:
        t0 = time.monotonic()
        rec["gate"] = _tp_gate(torch, fa, C, mesh, leader)
        rec["gate_seconds"] = time.monotonic() - t0
        t0 = time.monotonic()
        fa.launches = 0
        rec["serving"] = _tp_serving(torch, C, mesh)
        rec["serving_launches"] = fa.launches
        rec["serving_seconds"] = time.monotonic() - t0
        rec["ckpt"] = _tp_ckpt(torch, rank)
    rec["slice22"] = _slice22_rank(torch, fa, C, mesh, rank, world)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for turn in range(world):
        C.barrier(None)
        if turn == rank:
            sys.stdout.write(json.dumps(rec) + "\n")
            sys.stdout.flush()
    return 0


def tp_phases(torch, fa, smi) -> int:
    """tp_gate, tp_serving and sharded_ckpt: two ranks on the one card
    through the launcher over gloo (``chip_smoke.py --tp-rank``); their
    records as four lines (tp_serving once a dtype). Returns the flash
    launches of both ranks' sharded paths."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ranks, secs = _launch(tmp, TP["ranks"],
                              [os.path.join(ROOT, "chip_smoke.py"),
                               "--tp-rank"], TP_TIMEOUT_S)
    assert [r["rank"] for r in ranks] == list(range(TP["ranks"])), ranks
    lead = ranks[0]
    gate = lead["gate"]
    emit({"phase": "tp_gate", "nvidia_smi": smi, "ranks": TP["ranks"],
          "backend": "gloo", "transport": lead["transport"],
          "libraries": sorted({r["library"] for r in ranks}),
          "launches_by_rank": [r["gate"]["launches"] for r in ranks],
          "scoring_f32": gate["scoring_f32"],
          "scoring_bf16": gate["scoring_bf16"],
          "scoring_bf16_by_rank": [r["gate"]["scoring_bf16"]
                                   for r in ranks],
          "engine": gate["engine"], "seconds": lead["gate_seconds"],
          "launch_seconds": secs,
          "peak_gb_by_rank": [r["peak_gb"] for r in ranks]})
    for dtype in ("bfloat16", "float32"):
        _tp_serving_line(smi, dtype, lead["serving"][dtype], ranks)
    emit({"phase": "sharded_ckpt", "nvidia_smi": smi,
          "by_rank": [r["ckpt"] for r in ranks]})
    assert lead["serving"]["float32"]["token_parity"] is True
    for m in lead["serving"]["bfloat16"]["mismatches"]:
        assert abs(m["unsharded_margin"]) <= BF16_NEAR_TIE, m
    assert len({r["library"] for r in ranks}) == 1
    _TP_RANKS[:] = ranks        # their slice-22 records, read by main()
    return sum(r["gate"]["launches"] + r["serving_launches"] for r in ranks)


#: the records of the --tp-rank launch, whose slice-22 checks main()
#: emits with the slice-22 phases
_TP_RANKS: list = []


def _tp_serving_line(smi, dtype, srv, ranks) -> None:
    emit({"phase": "tp_serving", "nvidia_smi": smi, "dtype": dtype,
          "token_parity": srv["token_parity"],
          "mismatches": srv["mismatches"],
          "near_tie": BF16_NEAR_TIE if dtype == "bfloat16" else None,
          "transport": srv["collectives"]["transport"],
          "leader_messages": srv["collectives"]["leader_messages"],
          "messages_per_iteration": {
              k: v / max(1, srv["sharded"]["iterations"])
              for k, v in srv["collectives"]["leader_messages"].items()},
          "ttft": {"sharded": srv["sharded"]["ttft"],
                   "unsharded": srv["unsharded"]["ttft"]},
          "inter_token": {"sharded": srv["sharded"]["inter_token"],
                          "unsharded": srv["unsharded"]["inter_token"]},
          "ttft_p50_ratio": srv["ttft_p50_ratio"],
          "inter_token_p50_ratio": srv["inter_token_p50_ratio"],
          "inter_token_p99_ratio": srv["inter_token_p99_ratio"],
          "headers_per_iteration": srv["sharded"]["mesh"]["headers"]
          / max(1, srv["sharded"]["iterations"]),
          "mesh": srv["sharded"]["mesh"], "workload": srv["workload"],
          "flash_launches_by_rank": [r["serving_launches"] for r in ranks],
          "seconds": srv["seconds"]})


def tp_one(torch, fa, smi) -> int:
    """tp_one, in the world of one over NCCL: the flagship sharded over a
    one-rank model mesh (every collective a one-rank NCCL call), its
    scoring forward through the flash kernel equal to the whole model's,
    and the engine on that mesh, rows equal to the unsharded engine's.
    Returns the sharded forward's launches."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.parallel import collectives as C
    from bigdl_tpu_torch.parallel.tp import shard_model
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    mesh = Engine.create_mesh([("model", 1)])
    model32 = TransformerLM(**FLAGSHIP, seed=0, device="cuda",
                            dtype=torch.float32)
    model32.evaluate()
    local = shard_model(model32, mesh)
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, FLAGSHIP["vocab_size"], (2, 1024),
                        device="cuda", generator=g)
    calls0 = dict(C.calls)
    with torch.inference_mode():
        before = fa.launches
        got = local(ids)
        torch.cuda.synchronize()
        launches = fa.launches - before
        want = model32(ids)
    rel = rel_diff(got, want)
    reqs = _tp_reqs()[:2]
    kw = dict(max_slots=TP["slots"], prefill_chunk=TP["chunk"])
    with ContinuousBatchingEngine(model32, mesh=mesh, **kw) as eng:
        rows = _serve_all(eng, reqs, True)
        st = eng.stats()
    with ContinuousBatchingEngine(model32, **kw) as un:
        want_rows = _serve_all(un, reqs, True)
    equal = sum(bool((a == b).all()) for a, b in zip(rows, want_rows))
    emit({"phase": "tp_one", "nvidia_smi": smi, "backend": Engine.backend(),
          "transport": st["mesh"]["transport"], "launches": launches,
          "rel_vs_unsharded": rel, "rows_equal_unsharded": equal,
          "backend_calls": {k: v - calls0.get(k, 0)
                            for k, v in C.calls.items()
                            if v - calls0.get(k, 0)}})
    assert launches == FLAGSHIP["num_layers"], launches
    assert rel <= TP_RTOL, rel
    assert equal == len(reqs), equal
    assert st["mesh"]["transport"] == "nccl", st["mesh"]
    return launches


def _longcontext_flags():
    c = LONGCONTEXT
    return ["--flash", "--rope", "--kv-heads", str(c["kv_heads"]),
            "--embed", str(c["embed"]), "--heads", str(c["heads"]),
            "--layers", str(c["layers"]), "--vocab", str(c["vocab"]),
            "--seq-len", str(c["seq_len"]), "--batch", str(c["batch"]),
            "--steps", str(c["steps"])]


def _longcontext_step1(torch, blocks: int):
    """Step 1 of the long-context main (its model, seed-1 weights and
    ``RandomState(0)`` stream) in this process with the plain attention:
    (loss, L2 norm of the gradient). ``blocks`` > 1 cuts every row into
    that many rows of its own, so that no position sees the blocks before
    its own: what a ring without its past-block launches computes (RoPE
    scores depend only on relative positions)."""
    import numpy as np

    from bigdl_tpu_torch.models.transformer import TransformerLM

    c = LONGCONTEXT
    model = TransformerLM(
        c["vocab"], embed_dim=c["embed"], num_heads=c["heads"],
        num_layers=c["layers"], max_len=c["seq_len"], causal=True,
        remat=True, use_flash=False, use_rope=True,
        num_kv_heads=c["kv_heads"], seed=1, device="cuda")
    ids = np.random.RandomState(0).randint(0, c["vocab"],
                                           (c["batch"], c["seq_len"]))
    tgt = np.roll(ids, -1, axis=1)
    shape = (c["batch"] * blocks, c["seq_len"] // blocks)
    ids_t, tgt_t = (torch.as_tensor(x.reshape(shape), device="cuda")
                    for x in (ids, tgt))
    logp = torch.log_softmax(model(ids_t).float(), -1)
    nll = -logp.gather(-1, tgt_t[..., None]).mean()
    grads = torch.autograd.grad(nll, list(model.parameters()))
    norm = torch.cat([g.reshape(-1) for g in grads]).norm()
    return float(nll), float(norm)


def longcontext_train(torch, fa, smi) -> int:
    """longcontext_train: the long-context main at the serving flagship's
    widths (embed 512, 8 heads, 2 kv heads, 8 layers, RoPE, flash, vocab
    32000, 4 x 2048 tokens, remat, f32) through the launcher over 4
    sequence-parallel ranks sharing the card (gloo), its loss and
    gradient norm held at every step to the same main alone at
    ``--seq-parallel 0`` and at step 1 to a plain-attention run here,
    with a broken ring's reading shown rejected; then ``--experts 4``
    (each rank routes its own tokens: not held to one process). Returns
    the flash launches of the launched runs (2 x 8 layers x 10 a step)."""
    import tempfile

    sp, steps = LONGCONTEXT["ranks"], LONGCONTEXT["steps"]
    main = ["-m", "bigdl_tpu_torch.example.longcontext.train",
            *_longcontext_flags()]
    timeout = LONGCONTEXT["timeout_s"]
    with tempfile.TemporaryDirectory() as tmp:
        ring, ring_s = _launch(tmp, sp, [*main, "--seq-parallel", str(sp)],
                               timeout)
        alone, alone_s = _launch(tmp, 0, [*main, "--seq-parallel", "0"],
                                 timeout)
        moe, moe_s = _launch(tmp, sp, [*main, "--seq-parallel", str(sp),
                                       "--experts", "4"], timeout)

    def rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))

    plain = _longcontext_step1(torch, 1)
    cut = _longcontext_step1(torch, sp)
    torch.cuda.empty_cache()
    step1 = (ring[0]["losses"][0], ring[0]["grad_norms"][0])
    readings = {
        "ring_vs_one_process": {
            "loss": rel(ring[0]["losses"], alone[0]["losses"]),
            "grad_norm": rel(ring[0]["grad_norms"], alone[0]["grad_norms"])},
        "ring_step1_vs_plain": {"loss": rel(step1[:1], plain[:1]),
                                "grad_norm": rel(step1[1:], plain[1:])},
        "broken_ring_step1_vs_plain": {"loss": rel(cut[:1], plain[:1]),
                                       "grad_norm": rel(cut[1:], plain[1:])}}

    def row(rs, secs):
        step_s = statistics.median(
            statistics.median(r["step_s"][1:]) for r in rs)
        return {"seconds": secs, "step_s": step_s,
                "tokens_per_s": LONGCONTEXT["batch"] * LONGCONTEXT["seq_len"]
                / step_s,
                "losses": rs[0]["losses"], "grad_norms": rs[0]["grad_norms"],
                "peak_memory_bytes_by_rank": [r["peak_memory_bytes"]
                                              for r in rs],
                "flash_launches_by_rank": [r["flash_launches"] for r in rs],
                "flash_backward_launches_by_rank": [
                    r["flash_backward_launches"] for r in rs],
                "plain_backward_cuda_calls": sum(
                    r["plain_backward_cuda_calls"] for r in rs),
                "transport": rs[0]["transport"]}

    launches = sum(r["flash_launches"] for r in ring + moe)
    emit({"phase": "longcontext_train", "nvidia_smi": smi,
          "command": "python -m bigdl_tpu_torch.tools.launch --procs "
                     f"{sp} --backend gloo " + " ".join(main)
                     + f" --seq-parallel {sp}",
          "seq_parallel": row(ring, ring_s), "one_process": row(alone,
                                                                alone_s),
          "plain_step1": {"loss": plain[0], "grad_norm": plain[1]},
          "broken_ring_step1": {"loss": cut[0], "grad_norm": cut[1]},
          "experts_4": {**row(moe, moe_s), "moe": moe[0]["moe"]},
          "max_rel_diff": readings, "rtol": LONGCONTEXT_RTOL})
    per_layer_step = 2 * LONGCONTEXT["layers"]      # remat: fwd + recompute
    assert [r["flash_launches"] for r in ring] == [
        per_layer_step * (r + 1) * steps for r in range(sp)], ring
    assert alone[0]["flash_launches"] == per_layer_step * steps, alone
    # remat: each backward call follows its recompute's forward, so a rank
    # launches the backward kernels half as often as the forward
    for r in ring + alone + moe:
        assert 2 * r["flash_backward_launches"] == r["flash_launches"], r
        assert r["plain_backward_cuda_calls"] == 0, r
    BWD_LAUNCHES["longcontext_train"] = sum(
        r["flash_backward_launches"] for r in ring + alone + moe)
    for name in ("ring_vs_one_process", "ring_step1_vs_plain"):
        assert max(readings[name].values()) <= LONGCONTEXT_RTOL, readings
    assert max(readings["broken_ring_step1_vs_plain"].values()) \
        > LONGCONTEXT_RTOL, ("the tolerance passes a ring that dropped its "
                             "past blocks", readings)
    losses = moe[0]["losses"]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert all(r["transport"] == "gloo-host" for r in ring + moe)
    return launches + alone[0]["flash_launches"]


def native_augment_check() -> dict:
    """On the card's host: the fused transform calls the C++ kernel for
    every image, and its float32 bytes equal the numpy path's."""
    import numpy as np

    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.models.perf import PIPELINE_MEANS, PIPELINE_STDS
    from bigdl_tpu_torch.transform import vision

    rs = np.random.RandomState(5)
    imgs = [rs.randint(0, 255, (PIPELINE["image"], PIPELINE["image"], 3),
                       np.uint8) for _ in range(8)]
    calls, orig = [], native.fused_augment

    def counting(*a, **k):
        out = orig(*a, **k)
        calls.append(out is not None)
        return out

    outs = {}
    for use_native in (True, False):
        t = vision.FusedCropFlipNormalize(
            PIPELINE["crop"], PIPELINE["crop"], PIPELINE_MEANS,
            PIPELINE_STDS, flip_prob=0.5, seed=3, use_native=use_native)
        native.fused_augment = counting
        try:
            outs[use_native] = [t.transform(vision.ImageFeature(
                img.copy(), label=None, preserve_dtype=True)).image()
                .tobytes() for img in imgs]
        finally:
            native.fused_augment = orig
    assert len(calls) == len(imgs) and all(calls), calls
    assert outs[True] == outs[False]
    return {"images": len(imgs), "kernel_calls": len(calls),
            "bit_equal_to_numpy": True}


# ------------------------------------------------------------- slice 15
def _get(base, path):
    """(status, body bytes) of one GET on the local metrics server."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _prometheus(body: str) -> dict:
    """``{series: value}`` of Prometheus text; every sample line must be
    ``name{labels} value`` with a float value."""
    out = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def _obs_overhead(torch, model, wl, enabled: bool) -> dict:
    """One replay of ``wl`` through a fresh engine on the default
    registry, recorder and tracer, observability on or off
    (``observability.disable()``): inter-token p50/p99 and the loop's
    host-accounted ms an iteration."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.serving.benchmark import _engine_replay

    cfg = OBS_SERVING
    if not enabled:
        obs.disable()
    try:
        res = _engine_replay(
            model, wl, wl[0]["prompt"], 4, (), lambda *a, **k: None,
            "obs_overhead", max_slots=cfg["max_slots"],
            prefill_chunk=cfg["prefill_chunk"],
            prefill_rows=cfg["prefill_rows"],
            service_name="obs_overhead_" + ("on" if enabled else "off"))
    finally:
        obs.enable()
    loop = res["stats"]["loop"]
    return {"enabled": enabled,
            "inter_token_s": res["inter_token"], "ttft_s": res["ttft"],
            "ms_per_iteration": loop["accounted_s"] / loop["iterations"]
            * 1e3, "iterations": loop["iterations"],
            "tokens_per_s": res["tokens_per_sec"]}


def obs_serving(torch, fa, smi, model) -> int:
    """obs_serving (bf16): the serving flagship's engine (8 slots, 64-token
    chunks, the prefix cache) with a registry, a recorder, the sampler at
    0.25 s, the default detectors, an incident directory and a chaos
    injector, serving ``OBS_SERVING``'s 16 Poisson requests at 20/s from
    two tenants while ``start_http_server(port=0)`` serves every route.
    Held: ``/metrics`` parses and each ``bdt_serving_*_total`` flow
    counter equals ``stats()``'s; ``bdt_serving_jit_compiles`` is flat
    over the second half of the load; in ``/debug/memory`` the KV slot
    pool's bytes equal its tensors' ``nbytes`` and the engine's pools
    (the ``*_in_use`` views of the same tensors left out) sum to at most
    ``torch.cuda.memory_allocated()``; ``stats()["cost"]`` names the H100
    row (``source`` ``"table"``) with MFU and bandwidth shares in (0, 1];
    the loop-phase fractions sum to 1 (six figures rounded to 1e-6); a
    1 s ``/debug/profile`` taken on an HTTP thread under load writes a
    trace holding CUDA kernel events; then a chaos decode crash writes
    the postmortem and a crash incident, and ``/healthz`` answers 503.
    Then the overhead A/B (observability on, off, off, on) on one seeded
    workload (a finding, no limit); ``PredictionService(registry=...)``
    over the flagship's scoring forward (8 flash launches a dispatch, the
    family's counters equal ``stats()``); a 3-step ``LocalOptimizer`` run
    at the training flagship's widths and 2 layers whose
    ``write_chrome_trace`` holds its ``train/step`` spans and whose train
    family is populated. Returns the flash launches of the scoring and
    training parts."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.dataset import MiniBatch
    from bigdl_tpu_torch.models.perf import LMLoss
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.observability import memory as obs_memory
    from bigdl_tpu_torch.optim import SGD, Optimizer, PredictionService, Trigger
    from bigdl_tpu_torch.serving import (ChaosInjector,
                                         ContinuousBatchingEngine,
                                         EngineStopped)
    from bigdl_tpu_torch.serving.benchmark import poisson_workload

    cfg = OBS_SERVING
    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="obs_serving_")
    vocab = FLAGSHIP["vocab_size"]
    reg, rec = obs.MetricRegistry(), obs.FlightRecorder()
    chaos = ChaosInjector()
    eng = ContinuousBatchingEngine(
        model, max_slots=cfg["max_slots"],
        prefill_chunk=cfg["prefill_chunk"], prefill_rows=cfg["prefill_rows"],
        registry=reg, recorder=rec, service_name="obs_serving",
        timeseries_interval_s=cfg["interval_s"],
        incident_dir=os.path.join(tmp, "incidents"),
        postmortem_path=os.path.join(tmp, "postmortem.json"), chaos=chaos)
    wl = poisson_workload(cfg["n_requests"], cfg["rate_hz"], vocab,
                          prompt_lens=cfg["prompt_lens"],
                          decode_lens=cfg["decode_lens"], seed=cfg["seed"],
                          tenants=cfg["tenants"])
    srv = obs.start_http_server(
        port=0, host="127.0.0.1", registry=reg, recorder=rec,
        healthz=eng.healthz, debug_requests=eng.debug_requests,
        debug_usage=eng.debug_usage, debug_timeseries=eng.debug_timeseries,
        dashboard=eng.dashboard, debug_incidents=eng.debug_incidents,
        debug_capacity=eng.debug_capacity)
    base = f"http://127.0.0.1:{srv.port}"
    done, jit_half, prof = [], {}, {}
    lock = threading.Lock()

    def one(req):
        h = eng.submit(req["prompt"], req["n"], tenant=req["tenant"])
        row = h.result(timeout=600)
        assert row.shape == (len(req["prompt"]) + req["n"],), row.shape
        assert ((row >= 0) & (row < vocab)).all()
        with lock:
            done.append(h)
            if len(done) == len(wl) // 2:
                jit_half["compiles"] = _prometheus(_get(
                    base, "/metrics")[1].decode())[
                    'bdt_serving_jit_compiles{service="obs_serving"}']

    def profile_under_load():
        # the capture starts on this (HTTP client) thread's request, on
        # the server's HTTP thread, while the loop thread launches
        time.sleep(0.5)
        prof["status"], prof["body"] = _get(
            base, f"/debug/profile?seconds={cfg['profile_s']}")

    with eng:
        pt = threading.Thread(target=profile_under_load, daemon=True)
        pt.start()
        threads = []
        t0 = time.monotonic()
        for req in wl:
            delay = t0 + req["arrival_s"] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=one, args=(req,), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=600)
        pt.join(timeout=120)
        load_s = time.monotonic() - t0
        assert len(done) == len(wl), len(done)
        time.sleep(2 * cfg["interval_s"])          # sampler points
        stats = eng.stats()
        routes = {}
        for path in ("/metrics", "/healthz", "/debug/events?n=64",
                     "/debug/requests", "/debug/trace", "/debug/memory",
                     "/debug/usage?n=4", "/debug/incidents?n=4",
                     "/debug/capacity", "/debug/timeseries",
                     "/debug/dashboard"):
            status, body = _get(base, path)
            assert status == 200, (path, status, body[:200])
            routes[path] = body
        allocated = torch.cuda.memory_allocated()
    metrics = _prometheus(routes["/metrics"].decode())
    flows = {}
    for k in ("admitted", "finished", "evicted", "timed_out", "cancelled"):
        got = metrics.get(f'bdt_serving_{k}_total{{service="obs_serving"}}',
                          0.0)
        flows[k] = got
        assert got == stats[k], (k, got, stats[k])
    jit_end = metrics['bdt_serving_jit_compiles{service="obs_serving"}']
    assert jit_half["compiles"] == jit_end == stats["jit_compiles"], \
        (jit_half, jit_end, stats["jit_compiles"])
    mem = json.loads(routes["/debug/memory"])
    pools = {k: v for k, v in mem["now"]["pools"].items()
             if k.startswith("serving/obs_serving/")}
    kv_key = "serving/obs_serving/kv_slots"
    kv_nbytes = obs_memory.tree_bytes(eng._caches)
    assert pools[kv_key] == kv_nbytes, (pools[kv_key], kv_nbytes)
    distinct = sum(v for k, v in pools.items() if not k.endswith("_in_use"))
    assert distinct <= allocated, (distinct, allocated)
    dev0 = mem["now"]["devices"][0]
    assert dev0["source"] == "torch.cuda" and dev0["bytes_in_use"] > 0
    cost = stats["cost"]
    assert "H100" in cost["device_kind"], cost["device_kind"]
    assert cost["peak_source"] == "table", cost["peak_source"]
    shares = {}
    for kind in ("prefill", "decode"):
        k = cost["kinds"][kind]
        assert k["flops_source"] == "analytic", k
        shares[kind] = {"mfu": k["mfu"], "membw_util": k["membw_util"],
                        "roofline": k["roofline"]}
        for key in ("mfu", "membw_util"):
            assert k[key] is not None and 0.0 < k[key] <= 1.0, (kind, k)
    loop = stats["loop"]
    frac_sum = sum(loop["fractions"].values())
    assert abs(frac_sum - 1.0) <= LOOP_FRACTION_TOL, loop["fractions"]
    assert prof.get("status") == 200, prof
    artifact = json.loads(prof["body"])["artifact"]
    traces = [f for f in os.listdir(artifact) if f.endswith(".json")]
    assert len(traces) == 1, traces
    kernels_in_trace = _trace_kernels(os.path.join(artifact, traces[0]))
    assert kernels_in_trace > 0, "the capture holds no CUDA kernel"
    ts = json.loads(routes["/debug/timeseries"])
    assert ts["metrics"]["hbm_bytes_in_use"]["points"], ts["metrics"].keys()
    hz = json.loads(routes["/healthz"])
    assert hz["status"] in ("ok", "degraded"), hz

    # the crash: a scripted dispatch fault on a fresh request
    crash_err = None
    with eng:
        chaos.fail_dispatch(nth=1)
        h = eng.submit(wl[0]["prompt"], 8, tenant="alpha")
        try:
            h.result(timeout=120)
        except EngineStopped as e:
            crash_err = e
    assert crash_err is not None, "the injected fault did not crash the loop"
    with open(os.path.join(tmp, "postmortem.json")) as f:
        pm = json.load(f)
    assert pm["error"]["type"] == "ChaosFault", pm["error"]
    inc = eng.debug_incidents()
    assert inc["by_kind"].get("crash") == 1, inc["by_kind"]
    inc_files = [f for f in os.listdir(os.path.join(tmp, "incidents"))
                 if f.startswith("incident-")]
    status, body = _get(base, "/healthz")
    assert status == 503, (status, body)
    srv.close()
    eng_s = time.monotonic() - t_phase

    # the overhead: one seeded workload, observability on / off in turns
    wl2 = poisson_workload(cfg["n_requests"], cfg["rate_hz"], vocab,
                           prompt_lens=cfg["prompt_lens"],
                           decode_lens=cfg["decode_lens"],
                           seed=cfg["seed"] + 1, tenants=cfg["tenants"])
    runs = [_obs_overhead(torch, model, wl2, on)
            for on in (True, False, False, True)]

    def med(on, key, q=None):
        vals = [(r[key][q] if q else r[key]) for r in runs
                if r["enabled"] is on]
        return statistics.median(vals)

    overhead = {
        "runs": runs,
        "inter_token_p50_s": {"on": med(True, "inter_token_s", "p50"),
                              "off": med(False, "inter_token_s", "p50")},
        "inter_token_p99_s": {"on": med(True, "inter_token_s", "p99"),
                              "off": med(False, "inter_token_s", "p99")},
        "ms_per_iteration": {"on": med(True, "ms_per_iteration"),
                             "off": med(False, "ms_per_iteration")},
        "order": "on, off, off, on; medians of the two runs each",
        "nvidia_smi": smi}
    print(f"obs_serving overhead on {smi}: inter-token p50 "
          f"{overhead['inter_token_p50_s']} p99 "
          f"{overhead['inter_token_p99_s']} ms/iteration "
          f"{overhead['ms_per_iteration']}", flush=True)

    # scoring: PredictionService over the flagship's forward
    pcfg = OBS_PREDICT
    preg = obs.MetricRegistry()
    svc = PredictionService(model, num_threads=pcfg["clients"],
                            max_batch=pcfg["max_batch"],
                            batch_timeout_ms=pcfg["timeout_ms"],
                            sample_ndim=1, registry=preg,
                            service_name="obs_predict")
    rs = np.random.RandomState(6)
    preqs = [rs.randint(0, vocab, pcfg["tokens"])
             for _ in range(pcfg["clients"])]
    outs = [None] * len(preqs)
    obs.trace.reset()
    fa.launches = 0
    pth = [threading.Thread(
        target=lambda i=i: outs.__setitem__(i, svc.predict(preqs[i])),
        daemon=True) for i in range(len(preqs))]
    for th in pth:
        th.start()
    for th in pth:
        th.join(timeout=300)
    torch.cuda.synchronize()
    score_launches = fa.launches
    pst = svc.stats()
    assert all(o is not None and o.dtype.kind == "f" for o in outs)
    assert score_launches == model.num_layers * pst["dispatches"], \
        (score_launches, pst)
    pfam = _prometheus(obs.render_prometheus(preg))

    def ser(name):
        return pfam[f'{name}{{service="obs_predict"}}']

    assert ser("bdt_serve_dispatches_total") == pst["dispatches"]
    assert ser("bdt_serve_batch_occupancy_sum") == pst["served"]
    assert ser("bdt_serve_requests_total") == len(preqs)
    assert ser("bdt_serve_errors_total") == 0
    spans = obs.trace.roots(name="serve/dispatch")
    assert len(spans) == pst["dispatches"], (len(spans), pst)
    del svc, outs

    # training: 3 LocalOptimizer steps at the training flagship's widths
    tcfg = OBS_TRAIN
    treg = obs.MetricRegistry()
    prev = obs.set_default_registry(treg)
    obs.trace.reset()
    try:
        lm = TransformerLM(TRAIN["vocab"], TRAIN["embed_dim"],
                           TRAIN["heads"], tcfg["layers"], TRAIN["seq_len"],
                           use_flash=True, seed=0, device="cuda",
                           dtype=torch.float32)
        ids = rs.randint(0, TRAIN["vocab"], (TRAIN_BATCH, TRAIN["seq_len"]))
        opt = Optimizer(model=lm, dataset=[MiniBatch(ids, ids)],
                        criterion=LMLoss(TRAIN["vocab"]),
                        batch_size=TRAIN_BATCH,
                        end_when=Trigger.max_iteration(tcfg["iterations"]))
        opt.set_optim_method(SGD(learning_rate=tcfg["lr"]))
        opt.set_compute_dtype(torch.bfloat16)
        fa.launches = 0
        bwd_start(fa)
        opt.optimize()
        torch.cuda.synchronize()
        train_launches = fa.launches
        bwd_end(fa, "obs_train", train_launches)
        trace_path = os.path.join(tmp, "train_trace.json")
        obs.write_chrome_trace(trace_path)
    finally:
        obs.set_default_registry(prev)
    assert train_launches == tcfg["layers"] * tcfg["iterations"], \
        train_launches
    with open(trace_path) as f:
        tev = json.load(f)["traceEvents"]
    steps = [e for e in tev if e.get("name") == "train/step"
             and e.get("ph") == "X"]
    assert len(steps) == tcfg["iterations"], len(steps)
    tfam = _prometheus(obs.render_prometheus(treg))
    train = {k: tfam[f"bdt_train_{k}"] for k in (
        "step_seconds_count", "records_total", "loss", "grad_norm",
        "learning_rate", "jit_compiles", "throughput_records_per_sec")}
    assert train["step_seconds_count"] == tcfg["iterations"], train
    assert train["records_total"] == TRAIN_BATCH * tcfg["iterations"]
    assert train["loss"] > 0 and train["grad_norm"] > 0, train
    assert train["jit_compiles"] == 1, train
    del lm, opt

    emit({"phase": "obs_serving", "nvidia_smi": smi, "dtype": "bfloat16",
          "config": cfg, "load_s": load_s,
          "requests": len(wl), "flows_metrics_eq_stats": flows,
          "jit_compiles": {"half": jit_half["compiles"], "end": jit_end},
          "memory": {"kv_slots_bytes": pools[kv_key],
                     "kv_slots_nbytes": kv_nbytes,
                     "engine_pools_bytes": distinct,
                     "memory_allocated": allocated, "pools": pools,
                     "device": dev0},
          "cost": {"device_kind": cost["device_kind"],
                   "peak_source": cost["peak_source"],
                   "peak_flops_per_s": cost["peak_flops_per_s"],
                   "peak_hbm_bytes_per_s": cost["peak_hbm_bytes_per_s"],
                   "kinds": shares, "overall": cost["overall"]},
          "loop": {"fractions": loop["fractions"],
                   "fraction_sum": frac_sum,
                   "device_busy_fraction": loop["device_busy_fraction"],
                   "device_idle_fraction": loop["device_idle_fraction"],
                   "iterations": loop["iterations"]},
          "profile": {"seconds": cfg["profile_s"],
                      "cuda_kernel_events": kernels_in_trace},
          "latency_s": {k: {q: v[q] for q in ("p50", "p99")}
                        for k, v in stats["latency"].items()},
          "capacity": stats["capacity"],
          "crash": {"postmortem": pm["error"]["type"],
                    "incidents": inc["by_kind"],
                    "incident_files": len(inc_files),
                    "healthz_status": status},
          "routes": sorted(routes),
          "overhead": overhead,
          "scoring": {"stats": pst, "flash_launches": score_launches,
                      "serve_dispatch_spans": len(spans)},
          "train": {**train, "flash_launches": train_launches,
                    "train_step_spans": len(steps),
                    "config": {**TRAIN, "layers": tcfg["layers"],
                               "batch": TRAIN_BATCH}},
          "engine_part_s": eng_s,
          "phase_s": time.monotonic() - t_phase})
    return score_launches + train_launches


# ------------------------------------------------------------ the fleet
def _sse_all(base, reqs, on_meta=None) -> list:
    """``sse_generate`` for every (prompt, n) from a thread each, all at
    once; the results in order."""
    from bigdl_tpu_torch.serving.fleet.benchmark import sse_generate

    outs = [None] * len(reqs)
    errs = []

    def one(i, p, n):
        try:
            outs[i] = sse_generate(base, p, n, on_meta=on_meta)
        except Exception as e:
            errs.append(e)

    threads = []
    for i, (p, n) in enumerate(reqs):
        th = threading.Thread(target=one, args=(i, p, n), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    return outs


def _fleet_row(prompt, out):
    import numpy as np

    return np.concatenate([np.asarray(prompt, np.int64),
                           np.asarray(out["tokens"], np.int64)])


def _trace_checks(base) -> dict:
    """The merged ``/debug/fleet/trace`` and ``/debug/fleet/requests``:
    the processes, negative durations, the worst hop-sum gap."""
    status, body = _get(base, "/debug/fleet/trace")
    assert status == 200, (status, body[:200])
    evs = json.loads(body)["traceEvents"]
    procs = sorted({e["args"]["name"] for e in evs
                    if e.get("name") == "process_name"})
    negative = sum(1 for e in evs if e.get("ph") == "X" and e["dur"] < 0)
    status, body = _get(base, "/debug/fleet/requests")
    assert status == 200, status
    ring = json.loads(body)["requests"]
    gaps = [abs(e["hop_sum_s"] - e["total_s"]) / e["total_s"]
            for e in ring if e["total_s"] > 0]
    return {"processes": procs, "events": len(evs),
            "negative_durations": negative, "requests": len(ring),
            "max_hop_gap": max(gaps) if gaps else None}


def _owned_by(router, rid, prompt):
    """``prompt`` with its first token moved (mod the vocabulary) until
    ``router`` gives its key to ``rid``."""
    import numpy as np

    p = np.array(prompt)
    for step in range(FLAGSHIP["vocab_size"]):
        p[0] = (int(prompt[0]) + step) % FLAGSHIP["vocab_size"]
        if router.owner(router.key_for(p)) == rid:
            return p
    raise AssertionError(f"no first token gives the key to {rid}")


def fleet_gate(torch, fa, smi, model32, reqs) -> int:
    """fleet_gate (f32, TF32 off): two spawned workers of the serving
    flagship from seed 0 (``model32``'s seed) behind a
    ``ReplicaSupervisor`` and a ``FleetFrontDoor`` on 127.0.0.1:0. The
    server phase's 8 requests go through the door as SSE; each streamed
    row is held to a lone in-process engine on ``model32`` (equal, or at
    its first difference a near tie of the lone ``generate``,
    ``NEAR_TIE``). Then an operator drain of r0 while 8 requests stream
    (the 8 with their first token moved until the ring gives them to r0,
    each held to its own lone ``generate`` the same way): every request
    finishes, the 4 sent during the drain go to r1, and ``rejoin``
    restores the ring's ownership exactly. The merged
    ``/debug/fleet/trace`` holds the processes front-door, r0 and
    r1 and no negative duration; every finished request's hops sum to
    its total within 10% (by construction: ``hop_breakdown`` takes the
    stream hop as the residual, so this guards the ring's bookkeeping).
    A worker from seed 1 fails the parity check. Returns the flash
    launches of the parent and of every worker by its own ``stats()``
    (0: engines launch none)."""
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine
    from bigdl_tpu_torch.serving.fleet import (
        FleetFrontDoor, ReplicaSupervisor, spawn_worker_fleet,
    )

    fa.launches = 0
    t_phase = time.monotonic()
    engine = dict(FLEET["engine"])
    reps = spawn_worker_fleet(2, FLAGSHIP, engine=engine, seed=0,
                              device="cuda", dtype="float32",
                              rpc_timeout=FLEET["rpc_timeout"])
    (wrong,) = spawn_worker_fleet(1, FLAGSHIP, engine=engine, seed=1,
                                  prefix="w", device="cuda",
                                  dtype="float32",
                                  rpc_timeout=FLEET["rpc_timeout"])
    for rep in (*reps, wrong):
        rep.launch()         # the three start-ups overlap the lone run
    with ContinuousBatchingEngine(model32, **engine) as lone_eng:
        lone = [h.result(timeout=300) for h in
                [lone_eng.submit(p, n) for p, n in reqs]]
    with ReplicaSupervisor(reps, chunk=FLEET["chunk"], poll_interval=0.1,
                           fleet_name="gate") as sup, \
            FleetFrontDoor(sup, host="127.0.0.1", port=0) as door:
        base = f"http://127.0.0.1:{door.port}"
        startup_s = {rep.id: rep.startup_s for rep in reps}
        outs = _sse_all(base, reqs)
        rows = [_fleet_row(p, o) for (p, _), o in zip(reqs, outs)]
        equal_engine = [bool((r == l).all()) for r, l in zip(rows, lone)]
        ties = held_to_lone(model32, reqs, rows, label="fleet")
        placed = {rid: sum(o["meta"]["replica"] == rid for o in outs)
                  for rid in ("r0", "r1")}

        # the operator drain mid-flight, then new traffic and a rejoin:
        # the storm's prompts are the 8 with their first token moved
        # until the ring gives them to r0, so r0 is busy at the drain
        before = sup.router.ownership()
        storm_reqs = [(_owned_by(sup.router, "r0", p), n) for p, n in reqs]
        drill = {}
        on_r0 = threading.Event()

        def storm():
            drill["outs"] = _sse_all(
                base, storm_reqs, on_meta=lambda m: m["replica"] == "r0"
                and on_r0.set())

        th = threading.Thread(target=storm, daemon=True)
        th.start()
        # drain as soon as r0 has accepted a request of the storm
        in_flight = on_r0.wait(60)
        sup.drain("r0", reason="operator")
        during = _sse_all(base, reqs[:4])
        th.join()
        drained = sup.drain_wait("r0", timeout=120)
        sup.rejoin("r0")
        after = sup.router.ownership()
        drill_outs = drill["outs"] + during
        drill_reqs = storm_reqs + list(reqs[:4])
        lost = sum(1 for (p, n), o in zip(drill_reqs, drill_outs)
                   if o is None or o["done"] is None
                   or len(o["tokens"]) != n)
        drill_ties = held_to_lone(
            model32, drill_reqs,
            [_fleet_row(p, o) for (p, _), o in zip(drill_reqs, drill_outs)],
            label="drain")
        trace = _trace_checks(base)
        stats = sup.stats()
        clock = {rep.id: {"offset_s": rep.clock_offset_s,
                          "rtt_s": rep.clock_rtt_s} for rep in reps}

        # the wrong-seed worker: its rows must fail the parity rule
        wrong.start()
        wrong_rejected = 0
        for p, n in reqs[:2]:
            row = _fleet_row(p, {"tokens": wrong.submit(p, n).result(
                timeout=300)})
            try:
                lone_mismatch(model32, p, n, row)
            except AssertionError:
                wrong_rejected += 1
        worker_launches = {
            rid: r["flash_launches"]
            for rid, r in [*stats["replicas"].items(),
                           (wrong.id, wrong.stats())]}
        wrong.stop()
    launches = fa.launches + sum(worker_launches.values())
    rec = {"phase": "fleet_gate", "dtype": "float32",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "nvidia_smi": smi, "replicas": 2, "engine": engine,
           "chunk": FLEET["chunk"], "requests": len(reqs),
           "startup_s": startup_s, "placed": placed,
           "rows_equal_lone_engine": sum(equal_engine),
           "near_ties": ties, "near_tie_limit": NEAR_TIE,
           "drain": {"lost": lost, "drained": drained,
                     "storm_replicas": sorted(
                         {o["meta"]["replica"] for o in drill["outs"]}),
                     "r0_in_flight_at_drain": in_flight,
                     "during_replicas": sorted(
                         {o["meta"]["replica"] for o in during}),
                     "ring_restored": before == after,
                     "near_ties": drill_ties,
                     "routing": stats["routing"]["decisions"]},
           "trace": trace, "clock": clock,
           "wrong_seed_rejected": wrong_rejected,
           "flash_launches": launches,
           "worker_flash_launches": worker_launches,
           "seconds": time.monotonic() - t_phase}
    emit(rec)
    assert launches == 0, launches
    assert all(o["done"] is not None for o in outs)
    assert lost == 0, lost
    assert in_flight, "r0 took no request of the drain storm"
    assert rec["drain"]["during_replicas"] == ["r1"], rec["drain"]
    assert before == after
    assert trace["processes"] == ["front-door", "r0", "r1"], trace
    assert trace["negative_durations"] == 0, trace
    assert trace["max_hop_gap"] is not None and \
        trace["max_hop_gap"] <= 0.10, trace
    assert wrong_rejected == 2, wrong_rejected
    return launches


def _leg_block(leg: dict) -> dict:
    """A ``run_fleet_comparison`` leg as fleet_serving reports it."""
    f = leg["fleet"]
    return {"ttft": leg["ttft"], "inter_token": leg["inter_token"],
            "latency": leg["latency"],
            "tokens_per_s": leg["tokens_per_sec"],
            "wall_s": leg["wall_s"], "hit_rate": f["hit_rate"],
            "prefix_cache": f["prefix_cache"],
            "routing": f["routing"]["decisions"],
            "per_replica": f["routing"]["per_replica"],
            "hops_mean_s": leg["hops"], "startup_s": f["startup_s"],
            "clock": f["clock"], "control_ms": f["control_ms"],
            "peak_memory_bytes": f["peak_memory_bytes"],
            "worker_flash_launches": f["flash_launches"]}


def fleet_serving(torch, fa, smi, model16) -> int:
    """fleet_serving (bf16): ``run_fleet_comparison`` on the serving
    flagship (``model16``'s seed and dtype) through the front door, two
    spawned workers a leg under ``FLEET_SERVING``'s shared-prefix storm,
    an affinity leg and a round-robin leg: client TTFT and inter-token
    p50/p99, the fleet hit rate, the routing tallies, the per-hop means,
    each worker's start-up seconds, clock offset and RTT, the ms of one
    control round trip and each worker's peak memory from its own
    ``stats()``. Every row of both legs is held to a lone bf16 engine's
    replay of the storm: a row that parts does so where ``model16``'s
    teacher-forced logits of the two tokens lie within
    ``BF16_NEAR_TIE``. The replicas share one card: these numbers
    measure routing and prefix reuse, not scaling. Then
    ``run_fleet_comparison(n_replicas=2)`` on the card at JAX's model
    recipe (f32): ``token_parity`` true and a drain drill losing 0.
    Returns the flash launches of the parent and of every worker."""
    from bigdl_tpu_torch.serving.fleet import run_fleet_comparison

    fa.launches = 0
    t_phase = time.monotonic()
    quiet = lambda *a: None  # noqa: E731
    flag = run_fleet_comparison(
        n_replicas=2, model=FLAGSHIP, model_seed=0, dtype="bfloat16",
        device="cuda", front_door=True, drain_drill=False,
        rpc_timeout=FLEET["rpc_timeout"], log=quiet, **FLEET_SERVING)
    flag_s = time.monotonic() - t_phase
    t_cmp = time.monotonic()
    cmp_ = run_fleet_comparison(n_replicas=2, device="cuda", log=quiet)
    cmp_s = time.monotonic() - t_cmp
    worker_launches = sum(
        n for res in (flag, cmp_)
        for leg in ("affinity", "round_robin")
        for n in res[leg]["fleet"]["flash_launches"].values())
    launches = fa.launches + worker_launches
    # where a bf16 row parts from the lone engine's: model16's
    # teacher-forced margin between the two tokens (its forward without
    # the flash kernel, so the phase's launch count stays the fleet's)
    flash = [blk.attn.use_flash for blk in model16.blocks()]
    for blk in model16.blocks():
        blk.attn.use_flash = False
    for m in flag["mismatches"]:
        with torch.inference_mode():
            logits = model16(torch.tensor([m.pop("prefix")],
                                          device="cuda"))[0, -1].float()
        m["margin"] = None if m["fleet_token"] is None else (
            logits[m["reference_token"]]
            - logits[m["fleet_token"]]).item()
    for blk, on in zip(model16.blocks(), flash):
        blk.attn.use_flash = on
    aff, rr = flag["affinity"], flag["round_robin"]
    a50, r50 = aff["ttft"]["p50"], rr["ttft"]["p50"]
    rec = {"phase": "fleet_serving", "dtype": "bfloat16",
           "nvidia_smi": smi, "replicas": 2, "workload": flag["workload"],
           "note": "the replicas share one card: routing and prefix "
                   "reuse, not scaling",
           "affinity": _leg_block(aff), "round_robin": _leg_block(rr),
           "ttft_p50_speedup": (r50 / a50) if a50 and r50 else None,
           "hit_rate_gain": flag["hit_rate_gain"],
           "rows_equal_between_legs": flag["rows_equal_between_legs"],
           "rows_equal_lone_engine": 2 * FLEET_SERVING["n_requests"]
           - len(flag["mismatches"]),
           "near_ties": flag["mismatches"],
           "near_tie_limit": BF16_NEAR_TIE,
           "flagship_seconds": flag_s,
           "comparison": {
               "seconds": cmp_s,
               "token_parity": cmp_["token_parity"],
               "ttft_p50_speedup": cmp_["ttft_p50_speedup"],
               "hit_rate_gain": cmp_["hit_rate_gain"],
               "drain": {k: cmp_["drain"][k] for k in
                         ("completed", "lost", "token_parity",
                          "drained")},
               "affinity": {k: cmp_["affinity"][k] for k in
                            ("ttft", "inter_token", "tokens_per_sec")},
               "round_robin": {k: cmp_["round_robin"][k] for k in
                               ("ttft", "inter_token",
                                "tokens_per_sec")},
               "hit_rate": {
                   "affinity": cmp_["affinity"]["fleet"]["hit_rate"],
                   "round_robin":
                       cmp_["round_robin"]["fleet"]["hit_rate"]},
               "startup_s": cmp_["affinity"]["fleet"]["startup_s"],
               "capacity": cmp_["capacity"],
               "slo_budget": cmp_["slo_budget"],
               "workload": cmp_["workload"]},
           "flash_launches": launches,
           "seconds": time.monotonic() - t_phase}
    emit(rec)
    assert launches == 0, launches
    for m in flag["mismatches"]:
        assert m["margin"] is not None and \
            abs(m["margin"]) <= BF16_NEAR_TIE, m
    assert cmp_["token_parity"] is True, cmp_["mismatches"]
    assert cmp_["drain"]["lost"] == 0 and \
        cmp_["drain"]["token_parity"], cmp_["drain"]
    for leg in (aff, rr):
        assert leg["ttft"]["p50"] is not None
        assert leg["requests"] == FLEET_SERVING["n_requests"]
    return launches


def serve_example(torch, fa, smi) -> int:
    """serve_example: ``example.serving.serve.main`` with its default
    steps on the card (generate, sampling, beam, ragged, the int8 draft,
    ``GenerationService``, the engine with its ops surface), its rows
    held as the JAX test holds them (exactly prompt + n tokens each);
    then ``--fleet 2``, each streamed row equal to the lone greedy
    ``generate`` of the walkthrough's model or parting at a near tie.
    Returns the parent's flash launches (0: the walkthrough's model has
    flash off)."""
    import contextlib
    import io

    import numpy as np

    from bigdl_tpu_torch.example.serving.serve import main as serve_main
    from bigdl_tpu_torch.models.transformer import TransformerLM

    fa.launches = 0
    t0 = time.monotonic()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rows = serve_main(["--device", "cuda"])
    steps_s = time.monotonic() - t0
    n = 24
    shapes = [int(r.shape[0]) for r in rows]
    want = [t0_ + n_ for t0_, n_ in ((5, n), (9, n // 2), (12, n),
                                    (7, n // 2))]
    t1 = time.monotonic()
    with contextlib.redirect_stdout(log):
        frows = serve_main(["--device", "cuda", "--fleet", "2"])
    fleet_s = time.monotonic() - t1
    model = TransformerLM(128, embed_dim=32, num_heads=4, num_kv_heads=2,
                          num_layers=2, max_len=96, use_rope=True, seed=0,
                          device="cuda")
    model.evaluate()
    ties = held_to_lone(
        model, [(np.asarray(r["prompt"]), 8) for r in frows],
        [_fleet_row(r["prompt"], r) for r in frows], label="fleet")
    launches = fa.launches
    rec = {"phase": "serve_example", "nvidia_smi": smi,
           "default_steps_s": steps_s, "row_lengths": shapes,
           "want_lengths": want, "fleet_s": fleet_s,
           "fleet_rows": len(frows),
           "fleet_replicas": sorted({r["meta"]["replica"]
                                     for r in frows}),
           "fleet_near_ties": ties,
           "log_lines": len(log.getvalue().splitlines()),
           "flash_launches": launches}
    emit(rec)
    assert shapes == want, (shapes, want)
    assert len(frows) == 5 and frows[-1]["meta"]["replica"] == "r1"
    assert launches == 0, launches
    return launches


# ------------------------------------------------------------- slice 17
#: sequence_gate: the unrolls at the mains' sequence lengths (SimpleRNN's
#: 32, the language model's 20) over the JAX sweep's widths
SEQ_GATE = dict(batch=2, rnn_t=32, lstm_t=20)
#: graph_train: the NCF main at its defaults (64 users, 128 items, 4096
#: synthetic ratings, 12 epochs) and build_ncf at MovieLens-1M's tables
NCF_MAIN = ["--ratings", "4096", "--max-epoch", "12"]
NCF_FULL = dict(users=6040, items=3706, ratings=65536, batch=64,
                iterations=40)
#: the JAX test's bar: held-out accuracy above the majority baseline + 0.1
NCF_MARGIN = 0.1
#: rnn_train: the SimpleRNN main at its default widths on a written
#: corpus (its 30 epochs cut to RNN_EPOCHS), then the language model at
#: PTB "small" widths on its synthetic corpus
RNN_CORPUS = dict(words=4500, sentences=500, sentence_len=12)
RNN_EPOCHS = 3
LM_PTB_SMALL = ["--vocab", "10000", "--embed", "200", "--hidden", "200",
                "--num-steps", "20", "--batch-size", "20", "--max-epoch",
                "1"]
#: epochs of the language model's second run, where its windows repeat
LM_EPOCHS = 5
#: train steps in each main's torch.profiler window
SEQ_PROFILE_STEPS = 3
#: tree_train: the JAX test's sizes (root accuracy >= 0.7), then the
#: reference's widths (its 30 epochs cut to 10)
TREE_TEST = ["--samples", "16", "--leaves", "2", "--embed-dim", "4",
             "--hidden", "8", "--epochs", "15", "--lr", "0.3"]
TREE_ACC_MIN = 0.7
TREE_WIDE = ["--embed-dim", "300", "--hidden", "150", "--leaves", "8",
             "--epochs", "10"]
#: trees in tree_train's profiler window (the profiler's own processing
#: of a full 32-tree step's ~44,500 launches takes ~40 s)
TREE_PROFILE_SAMPLES = 4


def _seq_cases(tnn, torch, Table):
    """(name, CPU module factory, input builder) of every class of slice
    17: the JAX sweep's widths at the mains' sequence lengths."""
    import numpy as np

    cpu = dict(device="cpu")
    b = SEQ_GATE["batch"]
    rt, lt = SEQ_GATE["rnn_t"], SEQ_GATE["lstm_t"]

    def f(*shape):
        return lambda: _sweep_input(torch, *shape)

    def ids():
        t = torch.tensor(np.random.RandomState(5).randint(1, 11, (3, lt)))
        t[0, :3] = 4                      # the padding value
        return t

    def graph():
        inp = tnn.Input()
        shared = tnn.Linear(6, 6, **cpu)
        a = shared.inputs(tnn.Tanh().inputs(shared.inputs(inp)))
        b_ = tnn.Linear(6, 6, **cpu).set_name("stopped").inputs(inp)
        return tnn.Graph(inp, tnn.CAddTable().inputs(a, b_)).stop_gradient(
            ["stopped"])

    def tree_input():
        trees = torch.tensor([[[2, 3, 0], [4, 5, 0], [0, 0, 3], [0, 0, 1],
                               [0, 0, 2]],
                              [[2, 3, 0], [0, 0, 2], [0, 0, 3], [0, 0, 0],
                               [0, 0, 0]]], dtype=torch.float32)
        return Table(_sweep_input(torch, 2, 3, 6), trees)

    return [
        ("LookupTable_max_norm_padding", lambda: tnn.LookupTable(
            10, 6, padding_value=4, max_norm=1.5, **cpu), ids),
        ("Recurrent_RnnCell", lambda: tnn.Recurrent(tnn.RnnCell(
            5, 7, tnn.Tanh(), **cpu)), f(b, rt, 5)),
        ("Recurrent_LSTM", lambda: tnn.Recurrent(tnn.LSTM(4, 6, **cpu)),
         f(b, lt, 4)),
        ("Recurrent_LSTMPeephole", lambda: tnn.Recurrent(
            tnn.LSTMPeephole(4, 6, **cpu)), f(b, lt, 4)),
        ("Recurrent_GRU", lambda: tnn.Recurrent(tnn.GRU(4, 6, **cpu)),
         f(b, lt, 4)),
        ("Recurrent_MultiRNNCell", lambda: tnn.Recurrent(tnn.MultiRNNCell(
            [tnn.LSTM(4, 5, **cpu), tnn.GRU(5, 6, **cpu)])), f(b, lt, 4)),
        ("BiRecurrent", lambda: tnn.BiRecurrent(cell=tnn.RnnCell(
            4, 4, tnn.Tanh(), **cpu)), f(b, rt, 4)),
        ("RecurrentDecoder", lambda: tnn.RecurrentDecoder(
            lt, cell=tnn.LSTM(4, 4, **cpu)), f(b, 4)),
        ("Recurrent_ConvLSTMPeephole", lambda: tnn.Recurrent(
            tnn.ConvLSTMPeephole(2, 3, kernel_i=4, **cpu)),
         f(1, 3, 2, 6, 6)),
        ("Recurrent_ConvLSTMPeephole3D", lambda: tnn.Recurrent(
            tnn.ConvLSTMPeephole3D(2, 3, **cpu)), f(1, 2, 2, 4, 6, 6)),
        ("Graph_shared_and_stopped", graph, f(3, 6)),
        ("BinaryTreeLSTM_padded", lambda: tnn.BinaryTreeLSTM(6, 5, **cpu),
         tree_input),
    ]


def sequence_gate(torch, fa, smi) -> int:
    """sequence_gate (f32, TF32 off): every class of slice 17 on the card
    against the same module on the CPU, parameters drawn from a seed:
    ``LookupTable`` with ``max_norm`` and ``padding_value``, each cell
    under ``Recurrent``, ``MultiRNNCell``, ``BiRecurrent``,
    ``RecurrentDecoder``, both convolutional cells (an even input kernel),
    a two-branch ``Graph`` with a shared module and a stopped branch, and
    ``BinaryTreeLSTM`` on a padded tree; the forward and, for one random
    cotangent, the gradients of every float input and parameter, each
    within ``VARIANTS_RTOL`` of its largest |value|. Returns the flash
    launches (0)."""
    import copy

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.nn.module import (activity_tensors, tree_leaves,
                                           with_tensors)
    from bigdl_tpu_torch.utils.table import Table

    fa.launches = 0
    g = torch.Generator().manual_seed(31)
    results, classes = [], set()
    worst, worst_case = 0.0, None
    t0 = time.monotonic()
    for name, factory, build in _seq_cases(tnn, torch, Table):
        cpu_m = factory()
        cpu_m.evaluate()
        with torch.no_grad():
            for _, p in tree_leaves(cpu_m.params_dict()):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        card_m = copy.deepcopy(cpu_m).cuda()
        classes |= {type(m).__name__ for m in cpu_m.modules()}
        x = build()
        outs = []
        for m, dev in ((cpu_m, "cpu"), (card_m, "cuda")):
            leaves = [t.to(dev).requires_grad_(t.is_floating_point())
                      for t in activity_tensors(x)]
            got = activity_tensors(m(with_tensors(x, iter(leaves))))
            wrt = ([t for t in leaves if t.requires_grad]
                   + [p for _, p in tree_leaves(m.params_dict())])
            cg = torch.Generator().manual_seed(32)
            cots = [torch.randn(o.shape, generator=cg).to(dev) for o in got]
            grads = torch.autograd.grad(got, wrt, cots, allow_unused=True)
            outs.append([o.detach() for o in got] + [
                torch.zeros_like(w) if d is None else d
                for w, d in zip(wrt, grads)])
        errs = [_rel_err(torch, ref, got) for ref, got in zip(*outs)]
        case_worst = max(errs)
        if case_worst > worst:
            worst, worst_case = case_worst, name
        results.append({"case": name, "tensors": len(errs),
                        "worst": case_worst})
    emit({"phase": "sequence_gate", "nvidia_smi": smi, "dtype": "float32",
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "cases": len(results), "classes": sorted(classes),
          "rtol": VARIANTS_RTOL, "worst": worst, "worst_case": worst_case,
          "worst_excess": worst / VARIANTS_RTOL,
          "seconds": time.monotonic() - t0, "results": results,
          "flash_launches": fa.launches})
    assert worst <= VARIANTS_RTOL, (worst_case, worst)
    assert fa.launches == 0, fa.launches
    return fa.launches


def _main_summary(torch, main, argv):
    """(the main's return, its last printed JSON line, the loop's (loss,
    records/s) rows, seconds) of one main run on the card."""
    import contextlib
    import io

    out, box = io.StringIO(), {}
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rows = logged("bigdl_tpu_torch.optim",
                      lambda: box.setdefault("ret", main(argv)))
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    text = out.getvalue().strip()
    summary = json.loads(text.splitlines()[-1]) if text.endswith("}") \
        else {}
    return box["ret"], summary, rows, seconds


def _rows_block(rows, dropped: int = 2) -> dict:
    """The loop's rows in short: the first and last losses, the median
    records/s past the first ``dropped`` (warm-up) iterations."""
    import numpy as np

    losses = [float(r[0]) for r in rows]
    rates = [float(r[1]) for r in rows]
    rates = rates[dropped:] or rates
    k = max(1, min(4, len(losses) // 4))
    return {"iterations": len(rows), "loss_first": losses[:k],
            "loss_last": losses[-k:],
            "loss_first_mean": float(np.mean(losses[:k])),
            "loss_last_mean": float(np.mean(losses[-k:])),
            "records_per_s_median": float(np.median(rates))}


def _step_profile(torch, model, criterion, method, x, y) -> dict:
    """A torch.profiler window over ``SEQ_PROFILE_STEPS`` train steps of
    ``model`` on one batch (the loop's own step, without the loop):
    kernel launches a step, the device's busy share, the top kernels."""
    from bigdl_tpu_torch.optim import make_train_step
    from bigdl_tpu_torch.utils.profiling import device_profile

    step = make_train_step(model, criterion, method)
    params, buffers = model.params_dict(), model.buffers_dict()
    slots = step.init_slots(params)
    lrs = step.current_lrs()
    step.step(params, buffers, slots, x, y, lrs, None)     # warm-up
    n = SEQ_PROFILE_STEPS
    prof = device_profile(lambda: [step.step(params, buffers, slots, x, y,
                                             lrs, None) for _ in range(n)],
                          top=6)
    return {"steps": n, "launches_per_step": prof["kernel_launches"] / n,
            "ms_per_step": prof["wall_ms"] / n,
            "device_busy_ms_per_step": prof["device_busy_ms"] / n,
            "device_busy_share": 1.0 - prof["device_idle_share"],
            "top_kernels_ms": prof["top_kernels_ms"],
            "top_ops_ms": prof["top_ops_ms"][:6]}


def graph_train(torch, fa, smi) -> int:
    """graph_train: LeNet-5's and the autoencoder's graph forms against
    their Sequential forms on the card (the same weights: equal forwards
    and one equal SGD step, under cuDNN's deterministic algorithms), the
    NCF main at its defaults (held-out
    accuracy above the majority baseline + ``NCF_MARGIN``), and
    ``build_ncf`` at MovieLens-1M's tables (6040 users x 3706 items) over
    ``synthetic_movielens`` ratings for ``NCF_FULL["iterations"]``
    LocalOptimizer steps: ms a step and records/s. Returns the flash
    launches (0)."""
    import numpy as np

    from bigdl_tpu_torch import models as tmodels
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset.movielens import synthetic_movielens
    from bigdl_tpu_torch.example.recommendation import ncf
    from bigdl_tpu_torch.nn.module import tree_leaves
    from bigdl_tpu_torch.optim import (SGD, Adam, Optimizer, Trigger,
                                       make_train_step)

    fa.launches = 0
    t0 = time.monotonic()
    forms = []
    rs = np.random.RandomState(17)
    # cuDNN's default weight-gradient algorithms reduce in a run-dependent
    # order: the two forms are compared under deterministic algorithms,
    # where the same kernels on the same inputs give the same bits
    cudnn_flags = (torch.backends.cudnn.deterministic,
                   torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for name, model_cls, crit, y in (
            ("lenet5", tmodels.LeNet5, tnn.ClassNLLCriterion(),
             torch.tensor(rs.randint(1, 11, 16), dtype=torch.float32)),
            ("autoencoder", tmodels.Autoencoder, tnn.MSECriterion(),
             torch.tensor(rs.rand(16, 784), dtype=torch.float32))):
        # from one seed the two forms draw the same weights in the same
        # order; their parameters (each of its own shape) pair by shape
        seq = model_cls(seed=3, device="cuda")
        graph = model_cls.graph(seed=3, device="cuda")
        x = torch.tensor(rs.rand(16, 28, 28), dtype=torch.float32,
                         device="cuda")
        yc = y.cuda()
        seq.evaluate()
        graph.evaluate()
        init = max(_rel_err(torch, a, b) for a, b in zip(*[
            [t for _, t in sorted(tree_leaves(m.params_dict()),
                                  key=lambda kv: tuple(kv[1].shape))]
            for m in (seq, graph)]))
        with torch.no_grad():
            fwd = _rel_err(torch, seq(x), graph(x))
        losses, news = [], []
        for m in (seq, graph):
            step = make_train_step(m, crit, SGD(learning_rate=0.1))
            p = m.params_dict()
            loss, new, _, _ = step.step(p, {}, step.init_slots(p), x, yc,
                                        step.current_lrs(), None)
            losses.append(loss)
            news.append([t for _, t in sorted(
                tree_leaves(new), key=lambda kv: tuple(kv[1].shape))])
        step_err = max(_rel_err(torch, a, b) for a, b in zip(*news))
        loss_err = _rel_err(torch, losses[0], losses[1])
        forms.append({"model": name, "initial_weights": init,
                      "forward": fwd, "sgd_step": step_err,
                      "loss": loss_err, "parameters": len(news[0])})
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = cudnn_flags
    forms_s = time.monotonic() - t0

    (_, acc, base), main_summary, main_rows, main_s = _main_summary(
        torch, ncf.main, NCF_MAIN + ["--device", "cuda"])

    cfg = NCF_FULL
    data = synthetic_movielens(n_users=cfg["users"], n_items=cfg["items"],
                               n_ratings=cfg["ratings"])
    samples = ncf.ratings_to_samples(data)
    model = ncf.build_ncf(cfg["users"], cfg["items"], device="cuda")
    opt = Optimizer(model=model, dataset=samples,
                    criterion=tnn.BCECriterion(), batch_size=cfg["batch"],
                    end_when=Trigger.max_iteration(cfg["iterations"]))
    opt.set_optim_method(Adam(learning_rate=0.02))
    t1 = time.monotonic()
    full_rows = logged("bigdl_tpu_torch.optim", opt.optimize)
    torch.cuda.synchronize()
    full_s = time.monotonic() - t1
    full = _rows_block(full_rows)
    n_params = sum(t.numel() for t in model.parameters())
    emit({"phase": "graph_train", "nvidia_smi": smi, "forms": forms,
          "forms_s": forms_s, "rtol": VARIANTS_RTOL,
          "ncf_main": {"argv": NCF_MAIN, "seconds": main_s,
                       "held_out_accuracy": acc, "majority_baseline": base,
                       "margin_min": NCF_MARGIN, **main_summary,
                       **_rows_block(main_rows)},
          "ncf_ml1m_tables": {**cfg, "parameters": n_params,
                              "seconds": full_s,
                              "ms_per_step": 1e3 * cfg["batch"]
                              / full["records_per_s_median"], **full},
          "flash_launches": fa.launches})
    for rec in forms:
        assert rec["initial_weights"] == 0.0, rec
        assert max(rec["forward"], rec["sgd_step"],
                   rec["loss"]) <= VARIANTS_RTOL, rec
    assert acc > base + NCF_MARGIN, (acc, base)
    assert full["iterations"] == cfg["iterations"], full
    assert math.isfinite(full["loss_last_mean"]), full
    assert fa.launches == 0, fa.launches
    return fa.launches


def _rnn_corpus(folder) -> int:
    """Writes ``train.txt``: ``RNN_CORPUS["sentences"]`` sentences over
    ``RNN_CORPUS["words"]`` distinct words, each word used at least once,
    the rest drawn Zipf-like. Returns the distinct words written."""
    import numpy as np

    cfg = RNN_CORPUS
    rs = np.random.RandomState(4)
    n, length = cfg["sentences"], cfg["sentence_len"]
    words = [f"w{i}" for i in range(cfg["words"])]
    tokens = list(range(cfg["words"]))
    p = 1.0 / np.arange(1, cfg["words"] + 1)
    tokens += list(rs.choice(cfg["words"], n * length - len(tokens),
                             p=p / p.sum()))
    rs.shuffle(tokens)
    with open(os.path.join(folder, "train.txt"), "w") as f:
        for i in range(n):
            f.write(" ".join(words[t] for t in
                             tokens[i * length:(i + 1) * length]) + ". ")
    return len(set(tokens))


def rnn_train(torch, fa, smi) -> int:
    """rnn_train: the SimpleRNN main at its default widths (vocab 4000,
    hidden 40, sequence 32, batch 8; ``RNN_EPOCHS`` epochs) on a corpus
    written to a temporary folder with more than 4000 distinct words, and
    the language-model main at PTB "small" widths on its synthetic
    corpus, for one epoch (the given flags) and for ``LM_EPOCHS``: ms a
    step, records/s, the loss (falling over the epochs), and each
    model's train step in a ``torch.profiler`` window (launches a step,
    the device's busy share). Returns the flash launches (0)."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset.minibatch import MiniBatch
    from bigdl_tpu_torch.example.languagemodel import train as lm
    from bigdl_tpu_torch.models.rnn import train as rnn
    from bigdl_tpu_torch.optim import SGD, Adagrad

    fa.launches = 0
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        distinct = _rnn_corpus(tmp)
        argv = ["-f", tmp, "-e", str(RNN_EPOCHS), "--device", "cuda"]
        model, _, rows, seconds = _main_summary(torch, rnn.main, argv)
        samples, dictionary = rnn.build_samples(tmp, 4000, 32)
    batch = MiniBatch.from_samples(samples[:8])
    x = torch.tensor(batch.get_input(), device="cuda")
    y = torch.tensor(batch.get_target(), device="cuda")
    crit = tnn.TimeDistributedCriterion(tnn.CrossEntropyCriterion(),
                                        size_average=True)
    block = _rows_block(rows)
    runs["simple_rnn"] = {
        "argv": argv[2:], "corpus": RNN_CORPUS,
        "distinct_words": distinct, "vocab": dictionary.vocab_size(),
        "sentences": len(samples), "seconds": seconds, **block,
        "ms_per_step": 1e3 * 8 / block["records_per_s_median"],
        "profile": _step_profile(torch, model, crit,
                                 SGD(learning_rate=0.1), x, y)}
    assert distinct >= 4000 and dictionary.vocab_size() >= 4000
    assert block["loss_last_mean"] < block["loss_first_mean"], block

    # the main at PTB-small's flags: one epoch of its 4000-token stream
    # (one rolled progression: no window repeats within the epoch)
    _, summary, rows, seconds = _main_summary(
        torch, lm.main, LM_PTB_SMALL + ["--device", "cuda"])
    runs["ptb_small_lm"] = {"argv": LM_PTB_SMALL, "seconds": seconds,
                            **summary, **_rows_block(rows, dropped=1)}
    assert all(np.isfinite(r[0]) for r in rows)
    # the same flags for LM_EPOCHS epochs: the windows repeat, the loss
    # must fall
    argv = LM_PTB_SMALL[:-1] + [str(LM_EPOCHS)]
    model, summary, rows, seconds = _main_summary(
        torch, lm.main, argv + ["--device", "cuda"])
    stream, _ = lm.load_tokens(None, 10000)
    batch = MiniBatch.from_samples(lm.windows(stream, 20)[:20])
    x = torch.tensor(batch.get_input(), device="cuda")
    y = torch.tensor(batch.get_target(), device="cuda")
    crit = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                        size_average=True)
    per_epoch = len(rows) // LM_EPOCHS
    block = _rows_block(rows, dropped=1)
    block.update(
        loss_first_epoch_mean=float(np.mean([r[0] for r in
                                             rows[:per_epoch]])),
        loss_last_epoch_mean=float(np.mean([r[0] for r in
                                            rows[-per_epoch:]])))
    runs["ptb_small_lm_epochs"] = {
        "argv": argv, "seconds": seconds, **summary, **block,
        "profile": _step_profile(torch, model, crit,
                                 Adagrad(learning_rate=0.1), x, y)}
    assert block["loss_last_epoch_mean"] < block["loss_first_epoch_mean"], \
        block
    assert all(np.isfinite(r[0]) for r in rows)
    emit({"phase": "rnn_train", "nvidia_smi": smi, "runs": runs,
          "flash_launches": fa.launches})
    assert fa.launches == 0, fa.launches
    return fa.launches


def tree_train(torch, fa, smi) -> int:
    """tree_train: the tree-LSTM sentiment main on the card at the JAX
    test's sizes (root accuracy at least ``TREE_ACC_MIN``) and at the
    reference's widths (embeddings 300, hidden 150, 8 leaves, 10 of its
    30 epochs): seconds, the first and last loss; then one hand-driven
    step at those widths over ``TREE_PROFILE_SAMPLES`` trees in a
    ``torch.profiler`` window (launches a tree, the device's busy share).
    Returns the flash launches (0)."""
    from bigdl_tpu_torch.example.treeLSTMSentiment import train as tree
    from bigdl_tpu_torch.utils.profiling import device_profile

    fa.launches = 0
    runs = {}
    for name, argv in (("jax_test_sizes", TREE_TEST),
                       ("reference_widths", TREE_WIDE)):
        (loss, _), summary, _, seconds = _main_summary(
            torch, tree.main, argv + ["--device", "cuda"])
        runs[name] = {"argv": argv, "seconds": seconds, **summary}
        assert math.isfinite(loss) and summary["last_loss"] == loss
    args = tree.parser().parse_args(TREE_WIDE + ["--device", "cuda"])
    x, trees, labels = tree.synthetic_trees(TREE_PROFILE_SAMPLES,
                                            args.leaves, args.embed_dim)
    tree_mod, head = tree.build(args.embed_dim, args.hidden, device="cuda")
    tree.train(tree_mod, head, x, trees, labels, 1, args.lr)   # warm-up
    prof = device_profile(lambda: tree.train(tree_mod, head, x, trees,
                                             labels, 1, args.lr), top=6)
    runs["reference_widths"]["profile_one_step"] = {
        "trees": TREE_PROFILE_SAMPLES,
        "launches_per_tree": prof["kernel_launches"] / TREE_PROFILE_SAMPLES,
        "launches": prof["kernel_launches"], "wall_ms": prof["wall_ms"],
        "device_busy_share": 1.0 - prof["device_idle_share"],
        "top_kernels_ms": prof["top_kernels_ms"]}
    emit({"phase": "tree_train", "nvidia_smi": smi, "runs": runs,
          "acc_min": TREE_ACC_MIN, "flash_launches": fa.launches})
    assert runs["jax_test_sizes"]["root_accuracy"] >= TREE_ACC_MIN, runs
    wide = runs["reference_widths"]
    assert wide["last_loss"] < wide["first_loss"], wide
    assert fa.launches == 0, fa.launches
    return fa.launches


# ------------------------------------------------------------- slice 18
#: sparse_train: the Criteo Display Advertising layout (13 integer and 26
#: categorical fields) in the Wide & Deep shape of Cheng et al. 2016 §4
#: (32-dim embeddings, a 1024-512-256 ReLU tower): a wide SparseLinear
#: over 2^20 hashed columns (26 categorical values and 13 bucketed
#: integers: 39 active a row), the embeddings' mean over the 26 ids in a
#: 2^18-row table; cut to synthetic rows from a seed with a planted
#: sparse rule (``vocab`` values a field) and 64 steps of batch 512
SPARSE_TRAIN = dict(wide=1 << 20, ids=1 << 18, embed=32, fields=26,
                    dense=13, tower=(1024, 512, 256), batch=512, steps=64,
                    rows=8192, vocab=1000, lr=1e-3, parity_steps=3)
#: detection_infer: SSD300 on VOC (Liu et al. 2016, the deploy
#: prototxt): the six source maps, their steps, min and max sizes and
#: aspect ratios (flipped), variances 0.1/0.1/0.2/0.2: 8732 priors
SSD300 = dict(maps=(38, 19, 10, 5, 3, 1), steps=(8, 16, 32, 64, 100, 300),
              min_sizes=(30, 60, 111, 162, 213, 264),
              max_sizes=(60, 111, 162, 213, 264, 315),
              ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
              classes=21, nms=0.45, topk=400, keep=200, conf=0.01)
#: Faster R-CNN VGG16 at py-faster-rcnn's TEST settings
#: (lib/fast_rcnn/config.py): a 600 x 1000 image, conv5 at 38 x 63, 9
#: anchors, 6000 / 300 proposals at NMS 0.7, rois pooled 7 x 7 at 1/16
#: from 512 channels, the output head at NMS 0.3, 100 a image, score 0.05
FRCNN = dict(image=(600, 1000), conv5=(38, 63), channels=512,
             ratios=(0.5, 1.0, 2.0), scales=(8, 16, 32), pre_nms=6000,
             post_nms=300, rpn_nms=0.7, min_size=16, pooled=7,
             classes=21, nms=0.3, max_per_image=100, thresh=0.05)
#: RoiPooling's peak allocation a call, bytes
ROI_PEAK_LIMIT = 2 << 30
#: a kept set may part from the CPU's only at a near tie: an IoU within
#: this of the threshold
NEAR_TIE_IOU = 1e-5


def _sparse_cases(tnn, torch, Table):
    """(name, CPU module factory, input builder, eager backward) of every
    class of slice 18 at the JAX tests' sizes."""
    import numpy as np

    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.nn.sparse import SparseMiniBatch, SparseTensor

    cpu = dict(device="cpu")
    rs = np.random.RandomState(41)

    def dense(*shape):
        x = rs.rand(*shape).astype(np.float32)
        x[x < 0.6] = 0.0
        return torch.tensor(x)

    x46, x235 = dense(4, 6), dense(2, 3, 5)
    nnz = int((x46 != 0).sum())
    a, b = dense(2, 2) + 1.0, dense(2, 3)
    dup = ([[0, 0, 1, 1, 3], [2, 2, 0, 3, 5]], [1.5, -0.5, 2.0, 1.0, 4.0])
    id_at = [[0, 0, 0, 1, 2], [0, 0, 2, 1, 0]]
    ids = SparseTensor.coo(id_at, [3, 5, 2, 7, 10], (3, 3))
    wts = SparseTensor.coo(id_at, [1.0, 2.0, 0.5, 1.5, 0.25], (3, 3))
    batch = SparseMiniBatch.from_samples([
        Sample([SparseTensor.coo([[0, 1]], [4, 5], (3,)),
                SparseTensor.coo([[1, 3, 3]], [0.5, 1.0, 2.0], (4,))],
               np.asarray([1.0])),
        Sample([SparseTensor.coo([[0]], [6], (3,)),
                SparseTensor.coo([[0]], [3.0], (4,))], np.asarray([0.0]))])
    return [
        ("DenseToSparse_counted", lambda: tnn.DenseToSparse(),
         lambda: x46, False),
        ("DenseToSparse_padded", lambda: tnn.DenseToSparse(nse=nnz + 5),
         lambda: x46, False),
        ("DenseToSparse_truncated", lambda: tnn.DenseToSparse(nse=4),
         lambda: x46, False),
        ("SparseLinear_padded", lambda: tnn.SparseLinear(6, 3, **cpu),
         lambda: SparseTensor.from_dense(x46, nse=nnz + 4), False),
        ("SparseLinear_duplicates_out_of_bounds", lambda: tnn.SparseLinear(
            5, 3, **cpu), lambda: SparseTensor.coo(*dup, (3, 5)), False),
        ("SparseLinear_3d", lambda: tnn.SparseLinear(5, 4, **cpu),
         lambda: SparseTensor.from_dense(x235), False),
        ("SparseLinear_backward_slice", lambda: tnn.SparseLinear(
            6, 2, backward_start=3, backward_length=2, **cpu),
         lambda: SparseTensor.from_dense(x46, nse=nnz + 2), True),
        ("LookupTableSparse_sum_dense_ids", lambda: tnn.LookupTableSparse(
            10, 4, "sum", **cpu),
         lambda: torch.tensor([[1, 3, -1], [2, -1, -1], [9, 9, 0]]), False),
        ("LookupTableSparse_mean_duplicates_weights", lambda:
         tnn.LookupTableSparse(11, 4, "mean", **cpu),
         lambda: Table(ids, wts), False),
        ("LookupTableSparse_sqrtn_max_norm", lambda: tnn.LookupTableSparse(
            11, 4, "sqrtn", max_norm=0.5, **cpu), lambda: ids, False),
        ("SparseJoinTable_dim2_padded", lambda: tnn.SparseJoinTable(2),
         lambda: Table(SparseTensor.from_dense(a, nse=6),
                       SparseTensor.from_dense(b, nse=7)), False),
        ("SparseJoinTable_dim1", lambda: tnn.SparseJoinTable(1),
         lambda: Table(SparseTensor.from_dense(b, nse=4),
                       SparseTensor.from_dense(b)), False),
        ("SparseMiniBatch_ids", lambda: tnn.LookupTableSparse(
            7, 3, "sum", **cpu), lambda: batch.get_input()[1], False),
        ("SparseMiniBatch_wide", lambda: tnn.SparseLinear(4, 2, **cpu),
         lambda: batch.get_input()[2], False),
    ]


def _sparse_outputs(out):
    """(float tensors, index tensors) of an output: a SparseTensor gives
    its values, its dense form and its indices."""
    from bigdl_tpu_torch.nn.sparse import SparseTensor

    if isinstance(out, SparseTensor):
        return [out.values, out.to_dense()], [out.indices]
    return [out], []


def sparse_gate(torch, fa, smi) -> int:
    """sparse_gate (f32, TF32 off): every sparse class on the card against
    the same module on the CPU (``_sparse_cases``), parameters drawn from
    a seed: the output's indices equal, its values (and dense form), and
    for one random cotangent the gradients of every float input and
    parameter, each within ``VARIANTS_RTOL`` of its largest |value| (the
    ``backward_start`` case through the eager ``backward``). Returns the
    flash launches (0)."""
    import copy

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.nn.module import (activity_tensors, tree_leaves,
                                           with_tensors)
    from bigdl_tpu_torch.optim.evaluator import batch_to_device
    from bigdl_tpu_torch.utils.table import Table

    fa.launches = 0
    g = torch.Generator().manual_seed(43)
    results, classes = [], set()
    worst, worst_case, index_mismatch = 0.0, None, []
    t0 = time.monotonic()
    for name, factory, build, eager in _sparse_cases(tnn, torch, Table):
        cpu_m = factory()
        with torch.no_grad():
            for _, p in tree_leaves(cpu_m.params_dict()):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        card_m = copy.deepcopy(cpu_m).cuda()
        classes.add(type(cpu_m).__name__)
        x = build()
        outs, idxs = [], []
        for m, dev in ((cpu_m, "cpu"), (card_m, "cuda")):
            xd = batch_to_device(x, torch.device(dev))
            leaves = [t.detach().requires_grad_(t.is_floating_point())
                      for t in activity_tensors(xd)]
            xd = with_tensors(xd, iter(leaves))
            floats, ints = _sparse_outputs(m(xd))
            cg = torch.Generator().manual_seed(44)
            cot = torch.randn(floats[0].shape, generator=cg).to(dev)
            params = [p for _, p in tree_leaves(m.params_dict())]
            if eager:
                m.zero_grad_parameters()
                grads = [m.backward(xd, cot)] + [p.grad for p in params]
            else:
                wrt = [t for t in leaves if t.requires_grad] + params
                grads = [torch.zeros_like(w) if d is None else d
                         for w, d in zip(wrt, torch.autograd.grad(
                             floats[0], wrt, cot, allow_unused=True))] \
                    if wrt else []
            outs.append([f.detach() for f in floats] + grads)
            idxs.append([i.cpu() for i in ints])
        if not all(torch.equal(a, b) for a, b in zip(*idxs)):
            index_mismatch.append(name)
        errs = [_rel_err(torch, ref, got) for ref, got in zip(*outs)]
        case_worst = max(errs)
        if case_worst > worst:
            worst, worst_case = case_worst, name
        results.append({"case": name, "tensors": len(errs),
                        "worst": case_worst})
    emit({"phase": "sparse_gate", "nvidia_smi": smi, "dtype": "float32",
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "cases": len(results), "classes": sorted(classes),
          "rtol": VARIANTS_RTOL, "worst": worst, "worst_case": worst_case,
          "index_mismatch": index_mismatch,
          "seconds": time.monotonic() - t0, "results": results,
          "flash_launches": fa.launches})
    assert not index_mismatch, index_mismatch
    assert worst <= VARIANTS_RTOL, (worst_case, worst)
    assert fa.launches == 0, fa.launches
    return fa.launches


def _criteo_samples(cfg, seed: int):
    """``cfg["rows"]`` Samples of the wide-and-deep model: a SparseTensor
    of the 39 hashed wide columns (value 1), one of the 26 1-based hashed
    ids, 13 dense features (log1p of exponential counts) and a label from
    a planted rule: a sparse set of (field, value) weights plus a dense
    projection, thresholded at its median."""
    import numpy as np

    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.nn.sparse import SparseTensor

    rs = np.random.RandomState(seed)
    n, fields, vocab = cfg["rows"], cfg["fields"], cfg["vocab"]
    cats = rs.randint(0, vocab, (n, fields))
    dense = np.log1p(rs.exponential(2.0, (n, cfg["dense"]))).astype(
        np.float32)
    rule = rs.randn(fields, vocab) * (rs.rand(fields, vocab) < 0.1)
    logit = rule[np.arange(fields), cats].sum(1) + dense @ rs.randn(
        cfg["dense"])
    labels = (logit > np.median(logit)).astype(np.float32)
    key = np.arange(fields) * vocab + cats                       # (n, 26)
    buckets = (np.minimum(dense * 4, 9).astype(np.int64)
               + 10 * np.arange(cfg["dense"]) + fields * vocab)  # (n, 13)
    mix = np.uint64(2654435761)
    wide = (np.concatenate([key, buckets], 1).astype(np.uint64) * mix
            % np.uint64(cfg["wide"])).astype(np.int64)
    ids = (key.astype(np.uint64) * mix % np.uint64(cfg["ids"])).astype(
        np.int64) + 1
    ones = np.ones(wide.shape[1], np.float32)
    field_at = np.arange(fields)[None]
    return [Sample([SparseTensor.coo(wide[i][None], ones, (cfg["wide"],)),
                    SparseTensor.coo(field_at, ids[i], (fields,)),
                    dense[i]], labels[i:i + 1]) for i in range(n)]


def _wide_deep(tnn, cfg, device):
    """The wide-and-deep Graph of ``SPARSE_TRAIN`` on ``device``."""
    wide_in, ids_in, dense_in = tnn.Input(), tnn.Input(), tnn.Input()
    wide = tnn.SparseLinear(cfg["wide"], 1, device=device).inputs(wide_in)
    h = tnn.JoinTable(2).inputs(tnn.LookupTableSparse(
        cfg["ids"], cfg["embed"], "mean", device=device).inputs(ids_in),
        dense_in)
    width = cfg["embed"] + cfg["dense"]
    for n in cfg["tower"]:
        h = tnn.ReLU().inputs(tnn.Linear(width, n, device=device).inputs(h))
        width = n
    deep = tnn.Linear(width, 1, device=device).inputs(h)
    return tnn.Graph([wide_in, ids_in, dense_in],
                     tnn.Sigmoid().inputs(tnn.CAddTable().inputs(wide,
                                                                  deep)))


def sparse_train(torch, fa, smi) -> int:
    """sparse_train: the wide-and-deep ``Graph`` of ``SPARSE_TRAIN``
    trained by the ``LocalOptimizer`` (Adam, BCE) from sparse Samples for
    ``steps`` steps on the card; the same initial weights through the
    same loop on the CPU for ``parity_steps`` steps: their losses within
    ``VARIANTS_RTOL`` relative; the loss must fall; ms a step, records/s
    and a profiler window over the train step (launches a step, the
    device's busy share). Returns the flash launches (0)."""
    import copy

    import numpy as np

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset import SampleToMiniBatch
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
    from bigdl_tpu_torch.optim.evaluator import batch_to_device

    fa.launches = 0
    cfg = SPARSE_TRAIN
    t0 = time.monotonic()
    samples = _criteo_samples(cfg, seed=18)
    data_s = time.monotonic() - t0
    init = _wide_deep(tnn, cfg, "cpu")

    def run(model, steps):
        opt = Optimizer(model=model, dataset=samples,
                        criterion=tnn.BCECriterion(), batch_size=cfg["batch"],
                        end_when=Trigger.max_iteration(steps))
        opt.set_optim_method(Adam(learning_rate=cfg["lr"]))
        t = time.monotonic()
        rows = logged("bigdl_tpu_torch.optim", opt.optimize)
        if next(model.parameters()).is_cuda:
            torch.cuda.synchronize()
        return rows, time.monotonic() - t

    card = copy.deepcopy(init).cuda()
    rows, card_s = run(card, cfg["steps"])
    cpu_rows, cpu_s = run(copy.deepcopy(init), cfg["parity_steps"])
    k = cfg["parity_steps"]
    card_losses = [float(r[0]) for r in rows[:k]]
    cpu_losses = [float(r[0]) for r in cpu_rows]
    parity = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                     cpu_losses))
    block = _rows_block(rows)
    batch = next(SampleToMiniBatch(cfg["batch"])(iter(samples)))
    x = batch_to_device(batch.get_input(), torch.device("cuda"))
    y = torch.tensor(batch.get_target(), device="cuda")
    prof = _step_profile(torch, card, tnn.BCECriterion(),
                         Adam(learning_rate=cfg["lr"]), x, y)
    n_params = sum(p.numel() for p in card.parameters())
    emit({"phase": "sparse_train", "nvidia_smi": smi, "config": cfg,
          "dtype": "float32", "parameters": n_params,
          "active_wide_a_row": int(batch.get_input()[1].nse
                                   // cfg["batch"]),
          "data_seconds": data_s, "card_seconds": card_s,
          "cpu_seconds": cpu_s, "card_losses": card_losses,
          "cpu_losses": cpu_losses, "loss_parity": parity,
          "rtol": VARIANTS_RTOL, **block,
          "ms_per_step": 1e3 * cfg["batch"] / block["records_per_s_median"],
          "profile": prof, "flash_launches": fa.launches})
    assert len(rows) == cfg["steps"] and len(cpu_rows) == k
    assert parity <= VARIANTS_RTOL, (card_losses, cpu_losses)
    assert all(np.isfinite(r[0]) for r in rows)
    assert block["loss_last_mean"] < block["loss_first_mean"], block
    assert fa.launches == 0, fa.launches
    return fa.launches


def _host_syncs(torch, fn) -> int:
    """Host waits of ``fn()`` on the card: the warnings of CUDA's sync
    debug mode (stream and device synchronizes, blocking copies, reads of
    a device value)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _head_figures(torch, fn, calls: int = 5) -> dict:
    """ms a call (host clock over ``calls`` synchronized calls after one
    warm-up), kernel launches and the device's busy share of one call
    (``torch.profiler``), and host syncs a call."""
    from bigdl_tpu_torch.utils.profiling import device_profile

    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3 / calls
    prof = device_profile(fn, top=4)
    return {"ms_per_call": ms, "launches_per_call": prof["kernel_launches"],
            "device_busy_share": 1.0 - prof["device_idle_share"],
            "top_kernels_ms": prof["top_kernels_ms"],
            "host_syncs_per_call": _host_syncs(torch, fn)}


def _rows_apart(torch, card_rows, cpu_rows, thresh) -> dict:
    """Card rows against CPU rows, each ``[label, score, x1, y1, x2, y2]``:
    equal kept sets (labels and scores equal, boxes within
    ``VARIANTS_RTOL`` of the largest |coordinate|, row for row); else,
    for each row the other side has not (no row of its label and score
    with a box that close), the least distance from ``thresh`` of its
    IoU with another box of its label on either side (``near_tie``: the
    largest of those)."""
    import numpy as np

    from bigdl_tpu_torch.nn import bbox_iou

    a, b = (np.asarray(r, np.float64).reshape(-1, 6)
            for r in (card_rows, cpu_rows))
    both = np.concatenate([a, b])
    scale = max(np.abs(both[:, 2:]).max(initial=0.0), 1e-30)
    tol = VARIANTS_RTOL * scale
    if a.shape == b.shape and np.array_equal(a[:, :2], b[:, :2]):
        err = np.abs(a[:, 2:] - b[:, 2:]).max(initial=0.0) / scale
        if err <= VARIANTS_RTOL:
            return {"kept": len(b), "equal_sets": True,
                    "box_rel_err": float(err)}

    def close(r, rows):
        return (rows[:, :2] == r[:2]).all(1) & (
            np.abs(rows[:, 2:] - r[2:]).max(1) <= tol)

    lone = [r for x, y in ((a, b), (b, a)) for r in x if not close(r, y).any()]
    near = 0.0
    for r in lone:
        others = both[(both[:, 0] == r[0]) & ~close(r, both)]
        if not len(others):
            near = math.inf
            continue
        iou = bbox_iou(torch.tensor(r[None, 2:]),
                       torch.tensor(others[:, 2:]))[0].numpy()
        near = max(near, float(np.abs(iou - thresh).min()))
    return {"kept": [len(a), len(b)], "equal_sets": False,
            "only_one_side": len(lone), "near_tie": near}


def detection_infer(torch, fa, smi) -> int:
    """detection_infer on seeded random inputs: SSD300's VOC head
    (``SSD300``: six ``PriorBox`` layers, 8732 priors, softmaxed
    confidences, ``DetectionOutputSSD``) and Faster R-CNN VGG16's test
    path (``FRCNN``: ``Proposal`` over 21,546 anchors, ``RoiPooling`` of
    its rois over a ReLU'd 512 x 38 x 63 map, ``DetectionOutputFrcnn``),
    each head held to the port on the CPU on the same inputs (kept sets
    by ``_rows_apart``, pooled values within ``VARIANTS_RTOL``), with ms,
    launches and host syncs a call, and RoiPooling's peak allocation
    (under ``ROI_PEAK_LIMIT``). Returns the flash launches (0)."""
    import numpy as np

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.utils.table import Table

    fa.launches = 0
    t0 = time.monotonic()
    rs = np.random.RandomState(18)
    heads = {}

    def on(dev, *arrays):
        return Table(*[torch.tensor(np.asarray(a, np.float32), device=dev)
                       for a in arrays])

    def softmax(logits):
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    # ------------------------------------------------ SSD300 on VOC
    cfg = SSD300
    priors = {}
    for dev in ("cpu", "cuda"):
        parts = [tnn.PriorBox([mn], [mx], list(ar), is_flip=True,
                              variances=[0.1, 0.1, 0.2, 0.2], img_size=300,
                              step=st)(torch.zeros(1, 1, m, m, device=dev))
                 for m, st, mn, mx, ar in zip(
                     cfg["maps"], cfg["steps"], cfg["min_sizes"],
                     cfg["max_sizes"], cfg["ratios"])]
        priors[dev] = torch.cat(parts, dim=2)
    n_priors = priors["cuda"].shape[-1] // 4
    prior_err = _rel_err(torch, priors["cpu"], priors["cuda"])
    loc = (0.5 * rs.randn(1, 4 * n_priors)).astype(np.float32)
    conf = softmax(rs.randn(n_priors, cfg["classes"]) * 2).reshape(1, -1)
    ssd = tnn.DetectionOutputSSD(cfg["classes"], nms_thresh=cfg["nms"],
                                 nms_topk=cfg["topk"],
                                 keep_top_k=cfg["keep"],
                                 conf_thresh=cfg["conf"])
    ins = {dev: Table(*on(dev, loc, conf).values(), priors[dev])
           for dev in ("cpu", "cuda")}
    out = ssd(ins["cuda"])
    ref = ssd(ins["cpu"])
    heads["ssd300_detection_output"] = {
        "priors": n_priors, "prior_rel_err": prior_err,
        **_rows_apart(torch, out[0, 0, :, 1:].cpu().numpy(),
                      ref[0, 0, :, 1:].numpy(), cfg["nms"]),
        **_head_figures(torch, lambda: ssd(ins["cuda"]))}

    # ----------------------------------- Faster R-CNN VGG16, test time
    cfg = FRCNN
    (ih, iw), (fh, fw) = cfg["image"], cfg["conv5"]
    n_anchor = len(cfg["ratios"]) * len(cfg["scales"])
    rpn = softmax(rs.randn(fh, fw, n_anchor, 2) * 2)
    rpn = rpn.transpose(3, 2, 0, 1).reshape(1, 2 * n_anchor, fh, fw)
    rpn_deltas = (0.2 * rs.randn(1, 4 * n_anchor, fh, fw)).astype(
        np.float32)
    im_info = np.asarray([ih, iw, 1.0, 1.0], np.float32)
    prop = tnn.Proposal(cfg["pre_nms"], cfg["post_nms"],
                        list(cfg["ratios"]), list(cfg["scales"]),
                        min_size=cfg["min_size"], nms_thresh=cfg["rpn_nms"])
    prop.evaluate()
    p_in = {dev: on(dev, rpn, rpn_deltas, im_info) for dev in ("cpu",
                                                                "cuda")}
    rois = prop(p_in["cuda"])
    rois_cpu = prop(p_in["cpu"])

    def roi_rows(r):        # [0, 0, x1, y1, x2, y2]: one label, no score
        r = r.cpu().numpy()
        return np.concatenate([r[:, :1], r], 1)

    heads["frcnn_proposal"] = {
        "anchors": fh * fw * n_anchor, "rois": int(rois.shape[0]),
        **_rows_apart(torch, roi_rows(rois), roi_rows(rois_cpu),
                      cfg["rpn_nms"]),
        **_head_figures(torch, lambda: prop(p_in["cuda"]))}

    fmap = np.maximum(rs.randn(1, cfg["channels"], fh, fw), 0).astype(
        np.float32)
    pool = tnn.RoiPooling(cfg["pooled"], cfg["pooled"], 1.0 / 16)
    f_in = {"cuda": Table(torch.tensor(fmap, device="cuda"), rois),
            "cpu": Table(torch.tensor(fmap), rois.cpu())}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pooled = pool(f_in["cuda"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    heads["frcnn_roi_pooling"] = {
        "rois": int(rois.shape[0]), "out_shape": list(pooled.shape),
        "rel_err": _rel_err(torch, pool(f_in["cpu"]), pooled),
        "peak_bytes_over_base": peak - base, "peak_bytes": peak,
        "base_bytes": base, "peak_limit": ROI_PEAK_LIMIT,
        **_head_figures(torch, lambda: pool(f_in["cuda"]))}

    n_rois = int(rois.shape[0])
    scores = softmax(rs.randn(n_rois, cfg["classes"]) * 3)
    deltas = (0.1 * rs.randn(n_rois, 4 * cfg["classes"])).astype(np.float32)
    head = tnn.DetectionOutputFrcnn(cfg["nms"], cfg["classes"],
                                    max_per_image=cfg["max_per_image"],
                                    thresh=cfg["thresh"])
    head.evaluate()
    h_in = {dev: Table(torch.tensor(im_info[None], device=dev),
                       rois.to(dev), *on(dev, deltas, scores).values())
            for dev in ("cpu", "cuda")}

    def flat_rows(out):
        out = out.cpu().numpy()[0]
        return out[1:1 + int(out[0]) * 6].reshape(-1, 6)

    heads["frcnn_detection_output"] = {
        **_rows_apart(torch, flat_rows(head(h_in["cuda"])),
                      flat_rows(head(h_in["cpu"])), cfg["nms"]),
        **_head_figures(torch, lambda: head(h_in["cuda"]))}

    emit({"phase": "detection_infer", "nvidia_smi": smi, "ssd300": SSD300,
          "frcnn": FRCNN, "heads": heads, "rtol": VARIANTS_RTOL,
          "near_tie_iou": NEAR_TIE_IOU, "seconds": time.monotonic() - t0,
          "flash_launches": fa.launches})
    assert n_priors == 8732, n_priors
    assert prior_err == 0.0, prior_err
    for name, rec in heads.items():
        if "equal_sets" in rec:
            assert rec["kept"] and (rec["equal_sets"] and rec[
                "box_rel_err"] <= VARIANTS_RTOL or not rec["equal_sets"]
                and rec["near_tie"] < NEAR_TIE_IOU), (name, rec)
    pool_rec = heads["frcnn_roi_pooling"]
    assert pool_rec["rel_err"] <= VARIANTS_RTOL, pool_rec
    assert pool_rec["peak_bytes_over_base"] < ROI_PEAK_LIMIT, pool_rec
    assert fa.launches == 0, fa.launches
    return fa.launches


# ------------------------------------------------------------ slice 19
#: ops_gate's timed ops at realistic shapes (f32, TF32 off): BatchMatMul
#: of attention scores, MobileNetV1's first depthwise layer, an image
#: resized to ResNet's input, top 5 of LM logits, a segment sum over 2**20
#: rows, a 3 x 3 dilation over a 224 x 224 image
OPS_TIMED = dict(bmm=(64, 512, 512), depthwise=(1, 112, 112, 32),
                 resize=((1, 480, 640, 3), (224, 224)), topk=(64, 32000, 5),
                 segment=(2 ** 20, 16, 4096), dilation=(1, 224, 224, 3))
#: control_flow: a WhileLoop of ``iterations`` whose body is a Graph
#: (Linear width -> width, Tanh) over a (batch, width) state
CONTROL_FLOW = dict(iterations=256, batch=64, width=512)
#: widedeep_train: the main's defaults; the held-out accuracy must beat
#: the majority baseline by the JAX test's margin
WIDEDEEP_MARGIN = 0.08
WIDEDEEP_PARITY_STEPS = 3


def _public_names(module):
    import inspect

    return {name for name, obj in vars(module).items()
            if not name.startswith("_")
            and (inspect.isclass(obj) or inspect.isfunction(obj))
            and getattr(obj, "__module__", None) == module.__name__}


def _ops_cases(torch):
    """(name, classes it runs, ``run(device) -> output``) of every class
    of ``nn.ops`` and ``nn.tf_ops`` at the JAX tests' sizes, with the
    edge cases where torch's plain call parts from JAX: ties, ids out of
    range, NaN and -0.0, saturating casts, values on a boundary. Each
    ``run`` builds its inputs from a seed on the host and moves them to
    ``device``."""
    import numpy as np

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.nn import ops as o
    from bigdl_tpu_torch.nn import tf_ops as tf
    from bigdl_tpu_torch.utils import protowire as pw
    from bigdl_tpu_torch.utils.table import Table

    rs = np.random.RandomState(19)
    f32, i32 = np.float32, np.int32
    x34, y34 = rs.randn(3, 4).astype(f32), rs.randn(3, 4).astype(f32)
    x234 = rs.randn(2, 3, 4).astype(f32)
    halves = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 1.2, -3.7], f32)
    special = np.asarray([1.0, np.inf, -np.inf, np.nan, -0.0, 0.0], f32)
    gamma_x = np.asarray([0.5, 1.0, 2.5, 10.0, -0.5, -2.5, 0.0, -1.0], f32)
    sat = np.asarray([1e10, -1e10, np.nan, np.inf, -np.inf, 300.0, -1.5,
                      2.7, 255.9, -129.0], f32)
    ia = np.asarray([-7, 7, 9, -9, 0, 5], i32)
    ib = np.asarray([3, -3, 2, 4, 5, -2], i32)
    fb = np.asarray([3.0, -3.0, 2.5, 0.7, 5.0, -2.0], f32)
    ba, bb = np.asarray([1, 0, 1, 0], bool), np.asarray([1, 1, 0, 0], bool)
    ties = np.asarray([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0], [5, 1, 5, 1, 4]],
                      f32)
    nhwc = rs.randn(2, 7, 6, 3).astype(f32)
    hwim = rs.randn(3, 3, 3, 2).astype(f32)
    img = rs.rand(1, 8, 8, 2).astype(f32)
    words = np.asarray(["engineer", "teacher", "farmer", "artist", "clerk"])

    def t(a, d):
        return torch.from_numpy(np.asarray(a).copy()).to(d)

    cases = []

    def case(name, run, classes=None):
        cases.append((name, classes or [name.split("_")[0]], run))

    def op(cls, *args, x, **kw):
        """``cls(*args, **kw)`` on a Table of the inputs ``x`` (a tuple)
        or on the one input."""
        def run(d, cls=cls, args=args, kw=kw, x=x):
            m = getattr(o, cls)(*args, **kw)
            return m(Table(*[t(v, d) for v in x]) if isinstance(x, tuple)
                     else t(x, d))
        case(f"{cls}_{len(cases)}", run, [cls])

    for cls, x in [("Ceil", halves), ("Floor", halves), ("Round", halves),
                   ("Rint", halves), ("Exp", x34), ("Expm1", x34 * 1e-3),
                   ("Inv", gamma_x[:4]), ("Sign", special), ("Erf", x34),
                   ("Erfc", x34), ("Lgamma", gamma_x), ("Digamma", gamma_x),
                   ("IsFinite", special), ("IsInf", special),
                   ("IsNan", special), ("LogicalNot", ba)]:
        op(cls, x=x)
    for cls, x in [("Pow", (np.abs(fb) + 0.5, fb)), ("FloorDiv", (ia, ib)),
                   ("FloorDiv", (ia * 1.5, fb)), ("FloorMod", (ia, ib)),
                   ("Mod", (ia, ib)), ("Mod", (ia * 1.5, fb)),
                   ("TruncateDiv", (ia, np.asarray([0, 0, 0, 2, 5, -2],
                                                   i32))),
                   ("TruncateDiv", (ia * 1.5, fb)),
                   ("SquaredDifference", (x34, y34)),
                   ("Maximum", (special, np.zeros(6, f32))),
                   ("Minimum", (x234, y34[0])),
                   ("Minimum", (special, -np.zeros(6, f32))),
                   ("Maximum", (-np.zeros(6, f32), special)),
                   ("Equal", (ia, -ib)),
                   ("NotEqual", (ia, -ib)), ("Greater", (x34, y34)),
                   ("GreaterEqual", (ia, ib)), ("Less", (x34, y34)),
                   ("LessEqual", (ia, ib)), ("LogicalAnd", (ba, bb)),
                   ("LogicalOr", (ba, bb))]:
        op(cls, x=x)
    for dt in (np.int32, np.int8, np.uint8, np.float32, bool):
        op("Cast", dt, x=sat)
    op("ApproximateEqual", 0.5, x=(x34, y34))
    op("All", (0,), x=x234 > -1.0)
    op("Any", (0, 2), True, x=x234 > 1.0)
    op("Max", (1,), x=x234)
    op("Max", x=special)
    op("Prod", (0, 2), x=x234)
    op("Sum", (-1,), True, x=x234)
    op("ArgMax", 1, x=ties)
    op("ArgMax", x=(x234, np.asarray(2, i32)))
    op("BatchMatMul", True, True, x=(rs.randn(2, 4, 3).astype(f32),
                                     rs.randn(2, 5, 4).astype(f32)))
    op("Gather", 1, x=(x34, np.asarray([-1, 4, -5, 0, 3], i32)))
    op("Gather", x=(ia, np.asarray([-1, 6, 2], i32)))
    op("OneHot", 3, 2.0, -1.0, axis=0, x=np.asarray([[-1, 3], [1, 2]], i32))
    op("TopK", 2, x=ties)
    op("InTopK", 1, x=(ties, np.asarray([7, -1, 0], i32)))
    op("Rank", x=x234)
    op("Shape", x=x234)
    op("Select", x=(x34 > 0, x34, y34))
    op("Slice", [0, 1, 1], [2, -1, 2], x=x234)
    op("Tile", [2, 1, 3], x=x234)
    op("Tile", x=(x34, np.asarray([1, 2], i32)))
    op("Pad", [[1, 0], [0, 2], [1, 1]], 0.5, x=x234)
    op("L2Loss", x=x234)
    op("SegmentSum", x=(x34, np.asarray([0, 0, 2], i32)))
    op("SegmentSum", 3, x=(np.ones(4, f32), np.asarray([0, 1, 5, -1], i32)))
    op("CrossEntropy", x=(x34, np.asarray([4, -1, 1], i32)))
    op("ResizeBilinearOp", 13, 11, x=img)
    op("ResizeBilinearOp", 3, 5, x=img)
    op("ResizeBilinearOp", 13, 5, True, x=img)
    op("ResizeBilinear", 4, 4, x=img)
    op("BucketizedCol", [25.0, 35.0, 45.0, 55.0, 65.0],
       x=np.asarray([18.0, 25.0, 34.9, 35.0, 45.0, 65.0, 70.0], f32))
    op("IndicatorCol", 5, x=np.asarray([[0, 2, 2], [4, 7, -1]], i32))
    op("DepthwiseConv2D", 2, 1, 1, 0, x=(nhwc, hwim))
    op("DepthwiseConv2D", 1, 2, 0, 1, "NCHW",
       x=(np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2)), hwim))
    op("Dilation2D", (1, 2, 2, 1), (1, 1, 1, 1), x=(nhwc, hwim[..., 0]))
    op("Dilation2D", (1, 1, 2, 1), (1, 2, 1, 1), "VALID",
       x=(nhwc, hwim[:2, :2, :, 0]))
    case("RangeOps", lambda d: Table(o.RangeOps(2, 11, 3, device=d)(),
                                     o.RangeOps(0.0, 1.0, 0.25, device=d)()))
    case("hash_columns", lambda d: Table(
        o.CategoricalColHashBucket(32, device=d)(words),
        o.CategoricalColHashBucket(7, device=d)(t(ia, d)),
        o.CrossCol(64, device=d)([words, t(ia[:5], d)]),
        o.Kv2Tensor(",", ":", 6, device=d)(
            np.asarray(["0:1.5,3:2", "", "5:-1,1:0.25"]))),
        ["CategoricalColHashBucket", "CrossCol", "Kv2Tensor"])
    case("CategoricalColVocaList", lambda d: Table(
        o.CategoricalColVocaList(["a", "b", "c"], device=d)(
            np.asarray(["a,b", "c", "zzz", "c,q,a"])),
        o.CategoricalColVocaList(["a", "b"], ";", True, device=d)(
            np.asarray(["zzz;a", "b"])),
        o.CategoricalColVocaList(["a", "b"], num_oov_buckets=4, device=d)(
            np.asarray(["zzz,a,qq", "b,yy"]))))
    case("host_strings", lambda d: Table(
        o.MkString("|")(t(ia.reshape(2, 3), d)),
        o.Substr()(Table("abcdef", t(1, d), t(3, d)))),
        ["MkString", "Substr"])

    class GreaterPlus(o.Compare):
        compare_fn = staticmethod(lambda a, b: a > b)

    case("op_wrappers", lambda d: Table(
        ((((o.TensorOp() + 2.0) * 3.0 - 1.0) / 2.0) ** 2)(t(x34, d)),
        o.TensorOp().abs().sqrt().log().exp().sigmoid().tanh()(t(x34, d)),
        o.ModuleToOperation(tnn.Tanh())(t(x34, d)),
        GreaterPlus()(Table(t(x34, d), t(y34, d)))),
        ["TensorOp", "ModuleToOperation", "Compare", "Operation"])

    # ---- tf_ops: control flow, state, TensorArray, parsing
    def control(d):
        loop = tf.WhileLoop(lambda i, acc: i < 10,
                            lambda i, acc: (i + 1, acc * 0.5 + i))
        capped = tf.WhileLoop(lambda v: v.sum() < 1e9, tnn.Tanh(),
                              max_iterations=3)
        branch = tf.If(lambda a, b: a * b, lambda a, b: a - b)
        x, y = t(np.arange(3, dtype=f32), d), t(np.full(3, 2.0, f32), d)
        f_, t_, pred = tf.Switch()(Table(x, t(False, d)))
        ident = [getattr(tf, c)()(x) for c in (
            "Exit", "NextIteration", "NoOp", "ControlDependency")]
        cn = tf.ControlNodes
        sw = cn.switch(x, t(True, d))
        return Table(*loop(Table(t(np.int32(0), d), t(np.ones(3, f32), d))),
                     capped(x), branch(Table(t(True, d), x, y)),
                     branch(Table(t(False, d), x, y)),
                     tf.Merge()(Table(f_ * 2.0, t_ + 1.0, pred)),
                     tf.Merge()(Table(x * 3, x)), tf.Enter("f")(x), *ident,
                     tf.Assert("never")(Table(t(True, d), x)),
                     cn.while_loop(lambda v: v.sum() < 100.0,
                                   lambda v: v * 2.0, [x + 1], name="dbl"),
                     cn.merge(sw[1] * 2, sw[2], sw[3]))

    case("control", control, ["WhileLoop", "If", "Switch", "Merge", "Enter",
                              "Exit", "NextIteration", "NoOp",
                              "ControlDependency", "Assert", "ControlNodes"])

    def state(d):
        v = tf.Variable(np.zeros(3, f32), device=d)
        first = tf.Assign(v)(Table(None, t([1.0, 2.0, 3.0], d))) * 1.0
        tf.AssignAdd(v)(t(np.full(3, 0.5, f32), d))
        added = v.value * 1.0
        tf.AssignSub(v)(t(np.full(3, 2.0, f32), d))
        return Table(first, added, v(None) * 1.0)

    case("state", state, ["Variable", "Assign", "AssignAdd", "AssignSub"])

    def tensor_array(d):
        ta = tf.TensorArray(3, element_shape=(2,), device=d)
        for i in range(3):
            ta.write(i, t(np.full(2, i + 1.0, f32), d))
        ta.write(t(5, d), t(np.full(2, 9.0, f32), d))
        ta.write(t(-3, d), t(np.full(2, 7.0, f32), d))
        lazy = tf.TensorArrayCreator(device=d)(t(4, d))
        lazy = tf.TensorArrayScatter()(Table(lazy, t([0, 9, -1], d),
                                             t(np.arange(6, dtype=f32)
                                               .reshape(3, 2), d)))
        lazy = tf.TensorArrayWrite()(Table(lazy, 1, t([5.0, 6.0], d)))
        split = tf.TensorArraySplit()(Table(
            tf.TensorArray(2, device=d),
            t(np.arange(10, dtype=f32).reshape(5, 2), d), [2, 3]))
        return Table(ta.stack(), tf.TensorArrayRead()(Table(ta, t(-1, d))),
                     tf.TensorArrayGather()(Table(ta, t([2, -1, 3], d))),
                     tf.TensorArrayConcat()(Table(ta)), lazy.stack(),
                     split.stack(), tf.TensorArraySize()(Table(split)),
                     tf.TensorArrayClose()(Table(split)))

    case("tensor_array", tensor_array, [
        "TensorArray", "TensorArrayCreator", "TensorArrayWrite",
        "TensorArrayRead", "TensorArrayGather", "TensorArrayScatter",
        "TensorArrayConcat", "TensorArraySize", "TensorArraySplit",
        "TensorArrayClose"])

    def parsing(d):
        def example(feats):
            return pw.enc_bytes(1, b"".join(
                pw.enc_bytes(1, pw.enc_string(1, k) + pw.enc_bytes(2, fv))
                for k, fv in feats.items()))

        recs = [example({"x": pw.enc_bytes(2, pw.enc_packed_floats(
                    1, [1.5, -2.0])), "n": pw.enc_bytes(
                    3, pw.enc_packed_varints(1, [5, 2 ** 40]))}),
                example({"n": pw.enc_bytes(3, pw.enc_varint(1, 7)
                                           + pw.enc_varint(1, -3))})]
        assert tf.parse_example_bytes(recs[0])["n"].tolist() == [5, 2 ** 40]
        pe = tf.ParseExample(2, [np.float32, np.int64], [(2,), (2,)],
                             device=d)
        return pe(Table(np.asarray(recs, object), None, "x", "n",
                        np.asarray([8.0, 9.0], f32),
                        np.asarray([-1, -1], np.int64)))

    case("parsing", parsing, ["ParseExample", "parse_example_bytes"])
    return cases


def _ops_tensors(out):
    """The tensors and host values of an op's output, in order (a
    SparseTensor gives its indices, values and dense form)."""
    from bigdl_tpu_torch.nn.sparse import SparseTensor
    from bigdl_tpu_torch.utils.table import Table

    if isinstance(out, (Table, list, tuple)):
        return [x for v in out for x in _ops_tensors(v)]
    if isinstance(out, SparseTensor):
        return [out.indices, out.values, out.to_dense()]
    return [out]


def _ops_apart(torch, ref, got):
    """(exact, relative error) of a card output against the CPU's: the
    dtype, shape, non-finite entries and signs of zeros equal, integers
    and bools equal, floats within a share of the largest |finite ref|;
    host values (strings) equal."""
    if not torch.is_tensor(ref):
        import numpy as np

        return bool(np.array_equal(np.asarray(ref), np.asarray(got))), 0.0
    got = got.cpu()
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False, math.inf
    if not ref.is_floating_point():
        return bool(torch.equal(ref, got)), 0.0
    fin = torch.isfinite(ref)
    same_special = (torch.equal(fin, torch.isfinite(got))
                    and torch.equal(ref.isnan(), got.isnan())
                    and torch.equal(ref[torch.isinf(ref)],
                                    got[torch.isinf(ref)]))
    zero = ref == 0
    same_zero_sign = torch.equal(torch.signbit(ref[zero & (got == 0)]),
                                 torch.signbit(got[zero & (got == 0)]))
    if not fin.any():
        return same_special and same_zero_sign, 0.0
    err = _rel_err(torch, ref[fin], got[fin])
    return same_special and same_zero_sign, err


def _op_timings(torch) -> list:
    """ms a call (CUDA events, eager) of the ops that carry arithmetic at
    the ``OPS_TIMED`` shapes, each beside its bound: the bytes it must
    move (inputs once, output once) over the HBM rate or its f32 FLOPs
    over the f32 peak (TF32 off), whichever is larger."""
    from bigdl_tpu_torch.nn import ops as o
    from bigdl_tpu_torch.utils.table import Table

    g = torch.Generator(device="cuda").manual_seed(7)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    b, m, k = OPS_TIMED["bmm"]
    a1, a2 = r(b, m, k), r(b, k, m)
    ih = OPS_TIMED["depthwise"]
    xd, fd = r(*ih), r(3, 3, ih[3], 1)
    (src, (oh, ow)) = OPS_TIMED["resize"]
    im = torch.rand(*src, device="cuda", generator=g)
    rows, vocab, top = OPS_TIMED["topk"]
    logits = r(rows, vocab)
    n, width, segs = OPS_TIMED["segment"]
    xs = r(n, width)
    ids = torch.sort(torch.randint(0, segs, (n,), device="cuda",
                                   generator=g)).values
    dil_in = r(*OPS_TIMED["dilation"])
    dil_f = r(3, 3, OPS_TIMED["dilation"][3])
    specs = [
        ("BatchMatMul", o.BatchMatMul(), Table(a1, a2), 2.0 * b * m * m * k),
        ("DepthwiseConv2D", o.DepthwiseConv2D(1, 1, 1, 1), Table(xd, fd),
         2.0 * xd.numel() * 9),
        ("ResizeBilinearOp", o.ResizeBilinearOp(oh, ow), im,
         2.0 * src[0] * oh * ow * src[3] * 4),
        ("TopK", o.TopK(top), logits, 0.0),
        ("SegmentSum", o.SegmentSum(segs), Table(xs, ids), 1.0 * xs.numel()),
        ("Dilation2D", o.Dilation2D((1, 1, 1, 1), (1, 1, 1, 1)),
         Table(dil_in, dil_f), 2.0 * dil_in.numel() * 9),
    ]
    out = []
    for name, m_, x, flops in specs:
        y = m_(x)
        ins = [t for t in (x.values() if isinstance(x, Table) else [x])]
        outs = list(y.values()) if isinstance(y, Table) else [y]
        nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        bound = max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS["float32"]) * 1e3
        ms = time_ms(torch, lambda m_=m_, x=x: m_(x), warmup=3, iters=20)
        out.append({"op": name, "shape": [list(t.shape) for t in ins],
                    "ms": ms, "bound_ms": bound,
                    "bound_by": "bytes" if nbytes / PEAK_BYTES
                    >= flops / PEAK_FLOPS["float32"] else "operations",
                    "bound_share": bound / ms})
    return out


def _random_op_check(torch) -> dict:
    """RandomUniform and TruncatedNormal on the card over 2**20 draws:
    range, truncation at +-2 sigma and moments within sampling error
    (their values differ from the CPU's: Philox against Mersenne)."""
    from bigdl_tpu_torch.nn import ops as o

    shape = torch.tensor([1024, 1024])
    u = o.RandomUniform(-2.0, 3.0, seed=3, device="cuda")(shape)
    z = o.TruncatedNormal(1.0, 2.0, seed=3, device="cuda")(shape)
    n = u.numel()
    sd_u, sd_z = 5.0 / math.sqrt(12.0), 2.0 * 0.8796
    res = {"uniform": [float(u.min()), float(u.max()), float(u.mean()),
                       float(u.std())],
           "truncated_normal": [float(z.min()), float(z.max()),
                                float(z.mean()), float(z.std())]}
    ok = (u.is_cuda and z.is_cuda
          and -2.0 <= res["uniform"][0] and res["uniform"][1] <= 3.0
          and abs(res["uniform"][2] - 0.5) < 5 * sd_u / math.sqrt(n)
          and abs(res["uniform"][3] - sd_u) < 0.01 * sd_u
          and -3.0 <= res["truncated_normal"][0]
          and res["truncated_normal"][1] <= 5.0
          and abs(res["truncated_normal"][2] - 1.0) < 5 * sd_z / math.sqrt(n)
          and abs(res["truncated_normal"][3] - sd_z) < 0.01 * sd_z)
    res["ok"] = bool(ok)
    return res


def ops_gate(torch, fa, smi) -> int:
    """ops_gate (f32, TF32 off): every class of ``nn.ops`` and
    ``nn.tf_ops`` (``_ops_cases``) on the card against the port on the
    CPU: indices, masks, hash buckets, strings and the specials (NaN, inf,
    the sign of zero) equal, floats within ``VARIANTS_RTOL`` of the
    largest |value|; the random ops by their distributions; the card's
    CUDA state checked once at the end (a device-side assert would
    surface there); then the ops that carry arithmetic timed at
    ``OPS_TIMED``. Returns the flash launches (0)."""
    from bigdl_tpu_torch.nn import ops as tops
    from bigdl_tpu_torch.nn import tf_ops as ttf

    fa.launches = 0
    t0 = time.monotonic()
    results, covered, mismatch = [], set(), []
    worst, worst_case = 0.0, None
    for name, classes, run in _ops_cases(torch):
        covered.update(classes)
        ref, got = _ops_tensors(run("cpu")), _ops_tensors(run("cuda"))
        placed = all(g.is_cuda for g in got if torch.is_tensor(g))
        checks = [_ops_apart(torch, a, b) for a, b in zip(ref, got)]
        exact = len(ref) == len(got) and placed and all(c[0] for c in checks)
        err = max((c[1] for c in checks), default=0.0)
        if not exact:
            mismatch.append(name)
        if err > worst:
            worst, worst_case = err, name
        results.append({"case": name, "tensors": len(ref), "worst": err})
    rand = _random_op_check(torch)
    covered |= {"RandomUniform", "TruncatedNormal"}
    torch.cuda.synchronize()          # raises if a device-side assert fired
    missing = sorted((_public_names(tops) | _public_names(ttf)
                      | {"ResizeBilinear"}) - covered)
    gate_s = time.monotonic() - t0
    timings = _op_timings(torch)
    torch.cuda.synchronize()
    emit({"phase": "ops_gate", "nvidia_smi": smi, "dtype": "float32",
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "cases": len(results), "classes": len(covered),
          "missing_classes": missing, "rtol": VARIANTS_RTOL,
          "worst": worst, "worst_case": worst_case, "mismatch": mismatch,
          "random": rand, "gate_seconds": gate_s,
          "seconds": time.monotonic() - t0, "timed": timings,
          "results": results, "flash_launches": fa.launches})
    assert not missing, missing
    assert not mismatch, mismatch
    assert worst <= VARIANTS_RTOL, (worst_case, worst)
    assert rand["ok"], rand
    assert fa.launches == 0, fa.launches
    return fa.launches


def _loop_run(torch, dev, h0):
    """``CONTROL_FLOW``'s loop on ``dev``: a ``WhileLoop`` whose body runs
    the Graph and writes each state into a ``TensorArray``; (the loop
    module, the stacked states)."""
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.utils.random import RandomGenerator
    from bigdl_tpu_torch.utils.table import Table

    cfg = CONTROL_FLOW
    n, width = cfg["iterations"], cfg["width"]
    inp = tnn.Input()
    graph = tnn.Graph(inp, tnn.Tanh().inputs(tnn.Linear(
        width, width, rng=RandomGenerator(19), device=dev).inputs(inp)))
    ta = tnn.TensorArray(n, element_shape=(cfg["batch"], width), device=dev)

    def body(i, h):
        h = graph(h)
        ta.write(i, h)
        return i + 1, h

    loop = tnn.WhileLoop(lambda i, h: i < n, body)
    with torch.no_grad():
        loop(Table(torch.tensor(0, device=dev), h0.to(dev)))
    return loop, ta.stack()


def control_flow(torch, fa, smi) -> int:
    """control_flow (f32, TF32 off): ``CONTROL_FLOW``'s ``WhileLoop`` on the
    card against the CPU (the stacked states within ``VARIANTS_RTOL`` of
    the largest |value|), its host syncs (the module's count and CUDA's
    sync debug mode) and ms an iteration; ``If`` on a device predicate
    (one sync), ``Switch`` / ``Merge`` (no sync); ``Assign`` into a
    ``Variable`` that a ``torch.optim.SGD`` built before it then updates
    from the assigned value. Returns the flash launches (0)."""
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.utils.table import Table

    fa.launches = 0
    cfg = CONTROL_FLOW
    t0 = time.monotonic()
    h0 = torch.randn(cfg["batch"], cfg["width"],
                     generator=torch.Generator().manual_seed(23))
    _loop_run(torch, "cuda", h0)                       # warm-up
    torch.cuda.synchronize()
    t = time.monotonic()
    loop, card = _loop_run(torch, "cuda", h0)
    torch.cuda.synchronize()
    loop_s = time.monotonic() - t
    measured = _host_syncs(torch, lambda: _loop_run(torch, "cuda", h0))
    _, cpu = _loop_run(torch, "cpu", h0)
    err = _rel_err(torch, cpu, card)
    n = cfg["iterations"]

    x = torch.arange(4.0, device="cuda")
    branch = tnn.If(lambda a: a * 2.0, lambda a: a - 1.0)
    taken = [branch(Table(torch.tensor(p, device="cuda"), x)).tolist()
             for p in (True, False)]
    sw, mg = tnn.tf_ops.Switch(), tnn.tf_ops.Merge()
    pred = torch.tensor(False, device="cuda")

    def switch_merge():
        f, t_, p = sw(Table(x, pred))
        return mg(Table(f * 2.0, t_ + 1.0, p))

    merge_syncs = _host_syncs(torch, switch_merge)
    merged = switch_merge().tolist()

    v = tnn.Variable(torch.zeros(512), device="cuda")
    p = v.value
    sgd = torch.optim.SGD(v.parameters(), lr=0.25)
    target = torch.linspace(-1.0, 1.0, 512, device="cuda")
    tnn.Assign(v)(target)
    (v(None) ** 2).sum().backward()
    sgd.step()
    assign_err = float((v.value.detach() - 0.5 * target).abs().max())
    emit({"phase": "control_flow", "nvidia_smi": smi, "config": cfg,
          "dtype": "float32", "loop_seconds": loop_s,
          "ms_per_iteration": 1e3 * loop_s / n,
          "host_syncs_counted": loop.host_syncs,
          "host_syncs_measured": measured, "iterations": loop.iterations,
          "stack_rel_err": err, "rtol": VARIANTS_RTOL,
          "if_branches": taken, "if_host_syncs": branch.host_syncs,
          "switch_merge": merged, "switch_merge_host_syncs": merge_syncs,
          "assign_same_parameter": v.value is p,
          "assign_then_sgd_max_err": assign_err,
          "seconds": time.monotonic() - t0, "flash_launches": fa.launches})
    assert loop.iterations == n and loop.host_syncs == n + 1
    assert measured >= n + 1, measured
    assert err <= VARIANTS_RTOL, err
    assert taken == [[0.0, 2.0, 4.0, 6.0], [-1.0, 0.0, 1.0, 2.0]], taken
    assert branch.host_syncs == 2
    assert merged == [0.0, 2.0, 4.0, 6.0] and merge_syncs == 0, merge_syncs
    assert v.value is p and assign_err == 0.0, assign_err
    assert fa.launches == 0, fa.launches
    return fa.launches


def _example_records(wide, deep):
    """Each row as a serialized tf.Example: a float feature "wide" and an
    int64 feature "deep", written with the port's protowire."""
    from bigdl_tpu_torch.utils import protowire as pw

    def entry(name, feat):
        return pw.enc_bytes(1, pw.enc_string(1, name) + pw.enc_bytes(2, feat))

    return [pw.enc_bytes(1, entry("wide", pw.enc_bytes(
        2, pw.enc_packed_floats(1, w))) + entry("deep", pw.enc_bytes(
            3, pw.enc_packed_varints(1, d)))) for w, d in zip(wide, deep)]


def widedeep_train(torch, fa, smi) -> int:
    """widedeep_train: the wide-and-deep main at its defaults on the card
    (held-out accuracy above the majority baseline + ``WIDEDEEP_MARGIN``);
    the same initial weights through the same loop on the card and the
    CPU for ``WIDEDEEP_PARITY_STEPS`` steps (losses within
    ``VARIANTS_RTOL``); a profiler window over one train step started on
    this thread; then the held-out rows serialized as tf.Example records,
    parsed by ``ParseExample`` onto the card and fed to the trained model:
    the predictions equal those from the directly preprocessed features;
    the parse rate. Returns the flash launches (0)."""
    import copy

    import numpy as np

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset.dataset import LocalDataSet
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.example.widedeep import train as wd
    from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
    from bigdl_tpu_torch.optim import make_train_step
    from bigdl_tpu_torch.utils.profiling import device_profile
    from bigdl_tpu_torch.utils.table import Table

    fa.launches = 0
    t0 = time.monotonic()
    (model, acc, base), summary, rows, main_s = _main_summary(
        torch, wd.main, ["--device", "cuda"])

    samples_n = wd.parser().parse_args([]).samples
    census, labels = wd.synthetic_census(samples_n)
    wide, deep = wd.preprocess(census)
    split = int(0.9 * len(census))
    samples = [Sample([wide[i], deep[i]], labels[i:i + 1])
               for i in range(split)]
    init = wd.build_wide_deep(wide.shape[1], device="cpu")

    def run(m):
        opt = Optimizer(model=m, dataset=LocalDataSet(samples),
                        criterion=tnn.BCECriterion(), batch_size=64,
                        end_when=Trigger.max_iteration(WIDEDEEP_PARITY_STEPS))
        opt.set_optim_method(Adam(learning_rate=0.01))
        return [float(r[0]) for r in logged("bigdl_tpu_torch.optim",
                                            opt.optimize)]

    card_losses = run(copy.deepcopy(init).cuda())
    cpu_losses = run(copy.deepcopy(init))
    parity = max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                     cpu_losses))

    step = make_train_step(model, tnn.BCECriterion(), Adam(learning_rate=0.01))
    params, buffers = model.params_dict(), model.buffers_dict()
    slots = step.init_slots(params)
    lrs = step.current_lrs()
    x = Table(torch.from_numpy(wide[:64]).cuda(),
              torch.from_numpy(deep[:64]).cuda())
    y = torch.from_numpy(labels[:64, None]).cuda()
    model.training_mode()
    step.step(params, buffers, slots, x, y, lrs, None)        # warm-up
    prof = device_profile(lambda: step.step(params, buffers, slots, x, y,
                                            lrs, None), top=6)
    model.evaluate()

    held_w, held_d = wide[split:], deep[split:]
    recs = _example_records(wide, deep)
    pe = tnn.ParseExample(2, [np.float32, np.int64],
                          [(wide.shape[1],), (3,)], device="cuda")
    keys = (None, "wide", "deep", np.zeros(wide.shape[1], np.float32),
            np.zeros(3, np.int64))
    torch.cuda.synchronize()
    t = time.monotonic()
    all_w, all_d = pe(Table(np.asarray(recs, object), *keys))
    torch.cuda.synchronize()
    parse_s = time.monotonic() - t
    with torch.no_grad():
        direct = model(Table(torch.from_numpy(held_w).cuda(),
                             torch.from_numpy(held_d).cuda()))
        parsed = model(Table(all_w[split:], all_d[split:]))
    features_equal = bool(
        torch.equal(all_w.cpu(), torch.from_numpy(wide))
        and torch.equal(all_d.cpu(), torch.from_numpy(deep).long()))
    preds_equal = bool(torch.equal(direct, parsed))
    emit({"phase": "widedeep_train", "nvidia_smi": smi, "dtype": "float32",
          "main": summary, "main_seconds": main_s,
          "held_out_accuracy": acc, "majority_baseline": base,
          "margin": WIDEDEEP_MARGIN, "loop": _rows_block(rows),
          "card_losses": card_losses, "cpu_losses": cpu_losses,
          "loss_parity": parity, "rtol": VARIANTS_RTOL,
          "profile": {"launches_per_step": prof["kernel_launches"],
                      "ms_per_step": prof["wall_ms"],
                      "device_busy_ms": prof["device_busy_ms"],
                      "device_busy_share": 1.0 - prof["device_idle_share"],
                      "top_kernels_ms": prof["top_kernels_ms"],
                      "top_ops_ms": prof["top_ops_ms"][:6]},
          "parse_records": len(recs), "parse_seconds": parse_s,
          "parse_records_per_s": len(recs) / parse_s,
          "parsed_features_equal": features_equal,
          "parsed_predictions_equal": preds_equal,
          "seconds": time.monotonic() - t0, "flash_launches": fa.launches})
    assert acc > base + WIDEDEEP_MARGIN, (acc, base)
    assert len(card_losses) == len(cpu_losses) == WIDEDEEP_PARITY_STEPS
    assert parity <= VARIANTS_RTOL, (card_losses, cpu_losses)
    assert prof["kernel_launches"] > 0, prof
    assert features_equal and preds_equal
    assert fa.launches == 0, fa.launches
    return fa.launches


# -------------------------- the serializer and model interop (slice 20)
# the image main's images: 64 seeded 32 x 32 HWC arrays in [0, 1), 8 a batch
IMAGECLASS = dict(images=64, batch=8, seed=7)
# ResNet-50 as bench.py builds it, at the batch of its eval check
SERIALIZE_RESNET_BATCH = 32
# caffe-loaded VGG-16 against the original: the same cuDNN convolutions
# on the same weights; only the flatten/InnerProduct wiring differs
INTEROP_RTOL = 1e-6


def _files_equal(a: str, b: str) -> bool:
    """Whether the files ``a`` and ``b`` hold the same bytes."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa_, open(b, "rb") as fb_:
        while True:
            x, y = fa_.read(1 << 24), fb_.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def _timed(torch, fn):
    """(result, seconds) of ``fn()`` with the card synced on both sides."""
    torch.cuda.synchronize()
    t = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t


def _body(torch, model):
    """The zoo model's layers without its last ``LogSoftMax``, as one
    Sequential sharing them (the exporters' linear pipeline)."""
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.nn.container import flatten_sequential

    layers = flatten_sequential(model)
    assert isinstance(layers[-1], tnn.LogSoftMax), layers[-1]
    return tnn.Sequential(*layers[:-1])


def _t7_tree(torch, body):
    """``body``'s layers as a Lua Torch ``nn.Sequential`` TorchObject
    tree, its tensors still on the card (the .t7 writer copies them)."""
    import numpy as np

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.utils.torchfile import TorchObject

    mods = {}
    for i, m in enumerate(body.children(), 1):
        if isinstance(m, tnn.SpatialConvolution):
            cls, f = "nn.SpatialConvolution", {
                "weight": m.weight, "bias": m.bias,
                "nInputPlane": m.n_input_plane,
                "nOutputPlane": m.n_output_plane, "kW": m.kernel_w,
                "kH": m.kernel_h, "dW": m.stride_w, "dH": m.stride_h,
                "padW": m.pad_w, "padH": m.pad_h}
        elif isinstance(m, tnn.SpatialMaxPooling):
            cls, f = "nn.SpatialMaxPooling", {
                "kW": m.kw, "kH": m.kh, "dW": m.dw, "dH": m.dh,
                "padW": m.pad_w, "padH": m.pad_h, "ceil_mode": m.ceil_mode}
        elif isinstance(m, tnn.Linear):
            cls, f = "nn.Linear", {"weight": m.weight, "bias": m.bias}
        elif isinstance(m, tnn.View):
            cls, f = "nn.View", {"size": np.asarray(m.sizes, np.float64)}
        elif isinstance(m, tnn.Dropout):
            cls, f = "nn.Dropout", {"p": m.p}
        elif isinstance(m, tnn.ReLU):
            cls, f = "nn.ReLU", {}
        else:
            raise TypeError(f"no .t7 form for {type(m).__name__}")
        mods[i] = TorchObject(cls, f)
    return TorchObject("nn.Sequential", {"modules": mods})


def serialize_gate(torch, fa, smi) -> int:
    """serialize_gate: the serving flagship (bf16, full width) saved from
    the card with ``save_module`` and loaded with ``load_module(device=
    "cuda")``: scoring logits over 4 x 2048 tokens equal to the
    original's (``torch.equal``), every weight bf16 on the card, 8 flash
    launches a forward; then ResNet-50 as ``bench.py`` builds it (NHWC,
    random BN state) through the same round trip, its eval forward at
    batch ``SERIALIZE_RESNET_BATCH`` equal to the original's (f32,
    deterministic cuDNN). Archive bytes, save and load seconds. Returns
    the flash launches."""
    import tempfile

    from bigdl_tpu_torch.models import ResNet, TransformerLM
    from bigdl_tpu_torch.nn.module import Module

    fa.launches = 0
    t0 = time.monotonic()
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        lm = TransformerLM(**FLAGSHIP, seed=0, device="cuda",
                           dtype=torch.bfloat16)
        lm.evaluate()
        g = torch.Generator(device="cuda").manual_seed(20)
        ids = torch.randint(0, FLAGSHIP["vocab_size"], (4, 2048),
                            device="cuda", generator=g)
        path = os.path.join(tmp, "flagship.bigdl")
        with torch.inference_mode():
            before = fa.launches
            want = lm(ids)
            torch.cuda.synchronize()
            per_fwd = fa.launches - before
        _, save_s = _timed(torch, lambda: lm.save_module(path))
        back, load_s = _timed(torch, lambda: Module.load_module(
            path, device="cuda"))
        back.evaluate()
        with torch.inference_mode():
            before = fa.launches
            got = back(ids)
            torch.cuda.synchronize()
            loaded_per_fwd = fa.launches - before
        params = list(back.parameters())
        lm_ok = {
            "logits_equal": bool(torch.equal(got, want)),
            "params": sum(p.numel() for p in params),
            "all_bf16_on_card": all(p.dtype == torch.bfloat16 and p.is_cuda
                                    for p in params),
            "weights_equal": all(torch.equal(a, b) for a, b in zip(
                params, lm.parameters(), strict=True))}
        rows["flagship"] = {"bytes": os.path.getsize(path),
                            "save_s": save_s, "load_s": load_s,
                            "launches_per_forward": per_fwd,
                            "loaded_launches_per_forward": loaded_per_fwd,
                            **lm_ok}
        del lm, back, want, got

        cudnn_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            net = ResNet(1000, {"depth": 50, "dataSet": "ImageNet",
                                "format": "NHWC"}, seed=0, device="cuda")
            randomize_bn(torch, net, seed=21)
            net.evaluate()
            gx = torch.Generator().manual_seed(22)
            x = torch.randn((SERIALIZE_RESNET_BATCH, 224, 224, 3),
                            generator=gx).cuda()
            path = os.path.join(tmp, "resnet50.bigdl")
            with torch.inference_mode():
                want = net(x)
            _, save_s = _timed(torch, lambda: net.save_module(path))
            back, load_s = _timed(torch, lambda: Module.load_module(
                path, device="cuda"))
            back.evaluate()
            with torch.inference_mode():
                got = back(x)
            buffers = list(back.named_buffers())
            rows["resnet50_nhwc"] = {
                "bytes": os.path.getsize(path), "save_s": save_s,
                "load_s": load_s, "batch": SERIALIZE_RESNET_BATCH,
                "forward_equal": bool(torch.equal(got, want)),
                "buffers": len(buffers),
                "buffers_equal": all(torch.equal(a, b) for (_, a), (_, b)
                                     in zip(buffers, net.named_buffers(),
                                            strict=True))}
        finally:
            torch.backends.cudnn.deterministic = cudnn_det
    emit({"phase": "serialize_gate", "nvidia_smi": smi, "format":
          "module.json + tensors.npz (the JAX package's archive)",
          "rows": rows, "seconds": time.monotonic() - t0,
          "flash_launches": fa.launches})
    lm_row, rn = rows["flagship"], rows["resnet50_nhwc"]
    assert lm_row["logits_equal"] and lm_row["weights_equal"], lm_row
    assert lm_row["all_bf16_on_card"], lm_row
    assert per_fwd == loaded_per_fwd == FLAGSHIP["num_layers"], lm_row
    assert rn["forward_equal"] and rn["buffers_equal"], rn
    assert fa.launches == 2 * FLAGSHIP["num_layers"], fa.launches
    return fa.launches


def interop_gate(torch, fa, smi) -> int:
    """interop_gate (f32, TF32 off): VGG-16's body at ImageNet widths
    (the zoo's ``Vgg16`` without its ``LogSoftMax``) through
    ``save_caffe`` from the card and ``load_caffe`` onto it, its forward
    on 8 x 3 x 224 x 224 within ``INTEROP_RTOL`` of the original's and
    the caffemodel the bytes of a CPU copy's export; the same body as a
    Lua Torch ``nn.Sequential`` through the port's .t7 writer and
    ``load_torch`` (an equal forward); a GraphDef of an NHWC convolutional
    net at the JAX sweep's widths, from the card, the bytes of its CPU
    copy's. Seconds and bytes by format. Returns the flash launches (0)."""
    import copy
    import tempfile

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.models import Vgg16
    from bigdl_tpu_torch.utils import torchfile
    from bigdl_tpu_torch.utils.caffe import load_caffe
    from bigdl_tpu_torch.utils.caffe_export import save_caffe
    from bigdl_tpu_torch.utils.tf_export import save_tf

    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    fa.launches = 0
    t0 = time.monotonic()
    rows = {}
    body = _body(torch, Vgg16(1000, seed=0, device="cuda"))
    body.evaluate()
    n_params = sum(p.numel() for p in body.parameters())
    gx = torch.Generator().manual_seed(23)
    x = torch.randn((8, 3, 224, 224), generator=gx).cuda()
    with torch.inference_mode():
        want = body(x)
    with tempfile.TemporaryDirectory() as tmp:
        proto, cm = os.path.join(tmp, "vgg16.prototxt"), \
            os.path.join(tmp, "vgg16.caffemodel")
        _, save_s = _timed(torch, lambda: save_caffe(
            body, proto, cm, input_shape=(3, 224, 224)))
        cproto, ccm = os.path.join(tmp, "cpu.prototxt"), \
            os.path.join(tmp, "cpu.caffemodel")
        save_caffe(copy.deepcopy(body).cpu(), cproto, ccm,
                   input_shape=(3, 224, 224))
        same_bytes = _files_equal(cm, ccm) and _files_equal(proto, cproto)
        back, load_s = _timed(torch, lambda: load_caffe(proto, cm,
                                                        device="cuda"))
        back.evaluate()
        with torch.inference_mode():
            got = back(x)
        caffe_rel = rel_diff(got, want)
        rows["caffe"] = {"bytes": os.path.getsize(cm) + os.path.getsize(proto),
                         "save_s": save_s, "load_s": load_s,
                         "bytes_equal_cpu_export": same_bytes,
                         "forward_max_rel": caffe_rel,
                         "on_card": all(p.is_cuda for p in back.parameters())}
        del back

        t7 = os.path.join(tmp, "vgg16.t7")
        _, save_s = _timed(torch, lambda: torchfile.save(
            t7, _t7_tree(torch, body)))
        back, load_s = _timed(torch, lambda: torchfile.load_torch(
            t7, device="cuda"))
        back.evaluate()
        with torch.inference_mode():
            got = back(x)
        rows["torch_t7"] = {"bytes": os.path.getsize(t7), "save_s": save_s,
                            "load_s": load_s,
                            "forward_equal": bool(torch.equal(got, want)),
                            "forward_max_rel": rel_diff(got, want)}
        del back, got

        def conv_net(device):
            return (tnn.Sequential()
                    .add(tnn.SpatialConvolution(3, 8, 3, 3, 1, 1, -1, -1,
                                                format="NHWC", device=device))
                    .add(tnn.SpatialBatchNormalization(8, format="NHWC",
                                                       device=device))
                    .add(tnn.ReLU())
                    .add(tnn.SpatialMaxPooling(2, 2, format="NHWC"))
                    .add(tnn.View(8 * 8 * 8))
                    .add(tnn.Linear(8 * 8 * 8, 5, device=device)))

        net = conv_net("cuda")
        randomize_bn(torch, net, seed=24)
        net.evaluate()
        cpu_net = conv_net("cpu")
        cpu_net.load_params_dict(net.params_dict())
        cpu_net.load_buffers_dict(net.buffers_dict())
        pb, cpb = os.path.join(tmp, "conv.pb"), os.path.join(tmp, "cpu.pb")
        _, save_s = _timed(torch, lambda: save_tf(net, (16, 16, 3), pb))
        save_tf(cpu_net, (16, 16, 3), cpb)
        rows["tf_graphdef"] = {"bytes": os.path.getsize(pb), "save_s": save_s,
                               "bytes_equal_cpu_export": _files_equal(pb, cpb)}
    emit({"phase": "interop_gate", "nvidia_smi": smi, "dtype": "float32",
          "model": "Vgg16(1000) without its LogSoftMax", "params": n_params,
          "batch": 8, "rtol": INTEROP_RTOL, "rows": rows,
          "seconds": time.monotonic() - t0, "flash_launches": fa.launches})
    assert rows["caffe"]["bytes_equal_cpu_export"], rows["caffe"]
    assert rows["caffe"]["on_card"], rows["caffe"]
    assert caffe_rel <= INTEROP_RTOL, rows["caffe"]
    assert rows["torch_t7"]["forward_max_rel"] <= INTEROP_RTOL, rows
    assert rows["tf_graphdef"]["bytes_equal_cpu_export"], rows
    assert fa.launches == 0, fa.launches
    return fa.launches


def imageclass_predict(torch, fa, smi) -> int:
    """imageclass_predict: ``VggForCifar10``'s body (f32, its BN
    statistics calibrated on the images) exported to Caffe, then the
    port's image-classification main over ``IMAGECLASS`` seeded 32 x 32
    ``.npy`` images with ``--model-type caffe`` on the card: its classes
    equal the original body's ``predict_class`` through the main's own
    pipeline, except where the original's two best scores lie within
    ``NEAR_TIE`` (each such image is printed). Returns the flash
    launches (0)."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch.example.imageclassification import predict as ic
    from bigdl_tpu_torch.models import VggForCifar10
    from bigdl_tpu_torch.utils.caffe_export import save_caffe

    fa.launches = 0
    t0 = time.monotonic()
    body = _body(torch, VggForCifar10(10, seed=0, device="cuda"))
    body.evaluate()
    rng = np.random.RandomState(IMAGECLASS["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(IMAGECLASS["images"]):
            np.save(os.path.join(tmp, f"img{i:03d}.npy"),
                    rng.rand(32, 32, 3).astype(np.float32))
        images = os.path.join(tmp, "img*.npy")
        x = torch.cat(list(_image_batches(torch, images))).cuda()
        _calibrate_bn(torch, body, x)
        proto, cm = os.path.join(tmp, "vgg.prototxt"), \
            os.path.join(tmp, "vgg.caffemodel")
        save_caffe(body, proto, cm, input_shape=(3, 32, 32))
        batch = str(IMAGECLASS["batch"])
        got, main_s = _timed(torch, lambda: ic.main(
            ["--model", cm, "--model-type", "caffe", "--prototxt", proto,
             "--images", images, "--batch-size", batch, "--device", "cuda"]))
        want = ic.predict(body, images, batch_size=IMAGECLASS["batch"])
        with torch.inference_mode():
            scores = body(x).float().cpu()
    top2 = scores.topk(2, dim=1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    parted = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    near = [{"image": i, "caffe": got[i], "original": want[i],
             "gap": gaps[i]} for i in parted if gaps[i] <= NEAR_TIE]
    emit({"phase": "imageclass_predict", "nvidia_smi": smi,
          "model": "VggForCifar10(10) without its LogSoftMax, via caffe",
          "images": len(got), "batch": IMAGECLASS["batch"],
          "class_counts": np.bincount(want, minlength=11)[1:].tolist(),
          "main_seconds": main_s, "classes_equal": len(parted) == 0,
          "parted": parted, "near_ties": near, "near_tie": NEAR_TIE,
          "min_gap": min(gaps), "seconds": time.monotonic() - t0,
          "flash_launches": fa.launches})
    assert len(got) == len(want) == IMAGECLASS["images"]
    assert len(set(want)) > 1, want
    assert len(near) == len(parted), (parted, near)
    assert fa.launches == 0, fa.launches
    return fa.launches


def _calibrate_bn(torch, model, x) -> None:
    """Each BN layer's running statistics set to those of its input over
    ``x``, layer by layer, and a random gain: an untrained deep net with
    unit statistics maps every image to about the same scores, while
    calibrated it tells them apart as a trained one does."""
    from bigdl_tpu_torch.nn import BatchNormalization

    g = torch.Generator().manual_seed(25)
    h = x
    with torch.no_grad():
        for layer in model.children():
            if isinstance(layer, BatchNormalization):
                dims = [d for d in range(h.dim()) if d != 1]
                n = h.shape[1]
                layer.running_mean = h.mean(dims).clone()
                layer.running_var = h.var(dims, unbiased=False).clone()
                layer.weight.copy_(torch.rand(n, generator=g) + 0.5)
                layer.bias.copy_(0.1 * torch.randn(n, generator=g))
            h = layer(h)


def _image_batches(torch, images, side=32):
    """The main's preprocessed batches of ``images`` resized to ``side``
    (CHW tensors in [0, 1) need no rescaling)."""
    from bigdl_tpu_torch.transform.vision import (ChannelNormalize,
                                                  ImageFeatureToBatch,
                                                  ImageFrame, Resize)

    frame = ImageFrame.read(images).transform(Resize(side, side)).transform(
        ChannelNormalize((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)))
    for mb in ImageFeatureToBatch(IMAGECLASS["batch"], partial_batch=True)(
            iter(frame.features)):
        yield torch.as_tensor(mb.get_input())


# ------------------------------------------ TF import and keras (slice 21)
TF_ORACLE_TOL = dict(rtol=2e-4, atol=2e-5)
TF_FIXTURES = os.path.join(ROOT, "tests", "data", "torch_tf")
TF_PREDICT = dict(images=64, batch=8, side=224, seed=11)
TF_SESSION = dict(samples=64, epochs=40, batch=16, lr=0.2)
KERAS_MNIST = dict(train=2560, test=512, batch=128, epochs=2, seed=21,
                   lr=1e-3)
KERAS_IMDB = dict(train=1024, test=256, batch=32, epochs=3, maxlen=80,
                  vocab=20000, signal_tokens=100, seed=22, lr=3e-3)
PROFILE_CAPTURE_S = 1.0
#: profiler_hosting's requests: enough new tokens that a batch of three
#: outlasts ``profiler.HANDOFF_S`` on the f32 flagship
PROFILE_NEW_TOKENS = 64
#: Keras 1.2.2's examples/mnist_cnn.py as the port builds it (the
#: activations inline), for ``DefinitionLoader``
MNIST_CNN_JSON = json.dumps({"class_name": "Sequential", "config": [
    {"class_name": "Convolution2D", "config": {
        "nb_filter": 32, "nb_row": 3, "nb_col": 3, "activation": "relu",
        "border_mode": "valid", "dim_ordering": "th",
        "batch_input_shape": [None, 1, 28, 28]}},
    {"class_name": "Convolution2D", "config": {
        "nb_filter": 32, "nb_row": 3, "nb_col": 3, "activation": "relu",
        "border_mode": "valid", "dim_ordering": "th"}},
    {"class_name": "MaxPooling2D", "config": {"pool_size": [2, 2]}},
    {"class_name": "Dropout", "config": {"p": 0.25}},
    {"class_name": "Flatten", "config": {}},
    {"class_name": "Dense", "config": {"output_dim": 128,
                                       "activation": "relu"}},
    {"class_name": "Dropout", "config": {"p": 0.5}},
    {"class_name": "Dense", "config": {"output_dim": 10,
                                       "activation": "softmax"}}]})


def _vgg16_nhwc(torch, body):
    """``body`` (the zoo's NCHW VGG-16 without its LogSoftMax) rebuilt
    channels-last for the TF exporter, the same weights: SAME 3x3
    convolutions, and fc6's input columns reordered from (C, H, W) to
    (H, W, C) so the NHWC body computes the NCHW one's function."""
    from bigdl_tpu_torch import nn as tnn

    out = tnn.Sequential()
    first_linear, c_last = True, None
    for m in body.children():
        if isinstance(m, tnn.SpatialConvolution):
            c_last = m.n_output_plane
            c = tnn.SpatialConvolution(m.n_input_plane, m.n_output_plane, 3,
                                       3, 1, 1, -1, -1, format="NHWC",
                                       device="cuda")
            with torch.no_grad():
                c.weight.copy_(m.weight)
                c.bias.copy_(m.bias)
            out.add(c)
        elif isinstance(m, tnn.SpatialMaxPooling):
            out.add(tnn.SpatialMaxPooling(2, 2, 2, 2, format="NHWC"))
        elif isinstance(m, tnn.Linear):
            lin = tnn.Linear(m.weight.shape[1], m.weight.shape[0],
                             device="cuda")
            w = m.weight
            if first_linear:
                w = w.reshape(w.shape[0], c_last, 7, 7).permute(
                    0, 2, 3, 1).reshape(w.shape[0], -1)
                first_linear = False
            with torch.no_grad():
                lin.weight.copy_(w)
                lin.bias.copy_(m.bias)
            out.add(lin)
        else:
            out.add(m)
    return out


def _fixture_checks(torch, load_tf):
    """Every committed GraphDef of ``tests/data/torch_tf`` loaded on the
    card against TF's stored outputs; the TF1 while frame's host syncs an
    iteration."""
    import glob

    import numpy as np

    from bigdl_tpu_torch.nn.tf_ops import WhileLoop

    rows = {}
    for spec_path in sorted(glob.glob(os.path.join(TF_FIXTURES, "*.json"))):
        with open(spec_path) as f:
            spec = json.load(f)
        name = os.path.basename(spec_path)[:-5]
        data = np.load(os.path.join(TF_FIXTURES, spec["io"]))
        m = load_tf(os.path.join(TF_FIXTURES, spec["graph"]), spec["inputs"],
                    spec["outputs"], device="cuda")
        m.evaluate()
        loops = [mod for mod in m.modules() if isinstance(mod, WhileLoop)]
        worst, syncs, reads = 0.0, None, None
        for case in range(spec["cases"]):
            x = torch.from_numpy(data[f"x{case}"]).cuda()
            with torch.no_grad():
                out = m(x)
                before = sum(lp.host_syncs for lp in loops)
                syncs = _host_syncs(torch, lambda: m(x))
                reads = sum(lp.host_syncs for lp in loops) - before
            outs = list(out) if not torch.is_tensor(out) else [out]
            for j, o in enumerate(outs):
                want = data[f"y{case}_{j}"]
                got = o.float().cpu().numpy()
                np.testing.assert_allclose(got, want, **TF_ORACLE_TOL,
                                           err_msg=name)
                worst = max(worst, float(np.abs(got - want).max()))
        rows[name] = {"cases": spec["cases"], "max_abs_err": worst,
                      "on_card": all(p.is_cuda for p in m.parameters()),
                      "host_syncs_a_call": syncs}
        if loops:
            rows[name]["iterations"] = loops[0].iterations
            rows[name]["condition_reads_a_call"] = reads
            rows[name]["host_syncs_an_iteration"] = (
                syncs / max(loops[0].iterations, 1))
    return rows


def tf_import_gate(torch, fa, smi) -> int:
    """tf_import_gate (f32, TF32 off): VGG-16's body at ImageNet widths
    (the zoo's ``Vgg16`` without its ``LogSoftMax``, rebuilt NHWC with
    the same weights) exported by ``save_tf`` from the card and loaded
    back onto it by ``load_tf(device="cuda")``: its forward on
    8 x 224 x 224 x 3 within ``INTEROP_RTOL`` of the original's; the
    imported graph captured in a CUDA graph, its replay equal to eager
    (the counterpart of the JAX ``test_imported_graph_is_jittable``);
    every committed fixture against TF's stored outputs. Returns the
    flash launches (0)."""
    import tempfile

    from bigdl_tpu_torch.models import Vgg16
    from bigdl_tpu_torch.utils.tf_export import save_tf
    from bigdl_tpu_torch.utils.tf_import import load_tf

    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    fa.launches = 0
    t0 = time.monotonic()
    nchw = _body(torch, Vgg16(1000, seed=0, device="cuda"))
    nchw.evaluate()
    body = _vgg16_nhwc(torch, nchw)
    body.evaluate()
    gx = torch.Generator().manual_seed(26)
    x = torch.randn((8, 224, 224, 3), generator=gx).cuda()
    with torch.inference_mode():
        want = body(x)
        layout_rel = rel_diff(want, nchw(x.permute(0, 3, 1, 2)))
    del nchw
    with tempfile.TemporaryDirectory() as tmp:
        pb = os.path.join(tmp, "vgg16.pb")
        _, save_s = _timed(torch, lambda: save_tf(body, (224, 224, 3), pb))
        pb_bytes = os.path.getsize(pb)
        imported, load_s = _timed(torch, lambda: load_tf(
            pb, ["input"], ["output"], device="cuda"))
    imported.evaluate()
    with torch.inference_mode():
        got = imported(x)
    forward_rel = rel_diff(got, want)
    on_card = all(p.is_cuda for p in imported.parameters())
    ms_imported = time_ms(torch, lambda: imported(x), warmup=2, iters=5)
    ms_original = time_ms(torch, lambda: body(x), warmup=2, iters=5)
    # the CUDA-graph capture of the imported graph, replay against eager
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode():
        with torch.cuda.stream(side):
            for _ in range(2):
                imported(static_x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = imported(static_x)
        graph.replay()
        torch.cuda.synchronize()
        replay_equal = bool(torch.equal(static_out, got))
        replay_diff = float((static_out - got).abs().max())
    ms_replay = time_ms(torch, graph.replay, warmup=2, iters=5)
    del graph, static_out
    fixtures = _fixture_checks(torch, load_tf)
    emit({"phase": "tf_import_gate", "nvidia_smi": smi, "dtype": "float32",
          "model": "Vgg16(1000) without its LogSoftMax, NHWC, via save_tf",
          "batch": 8, "graphdef_bytes": pb_bytes, "save_s": save_s,
          "load_s": load_s, "forward_max_rel": forward_rel,
          "rtol": INTEROP_RTOL, "nhwc_vs_nchw_rel": layout_rel,
          "on_card": on_card, "ms_imported": ms_imported,
          "ms_original": ms_original, "ms_graph_replay": ms_replay,
          "graph_replay_equal": replay_equal,
          "graph_replay_max_abs": replay_diff, "fixtures": fixtures,
          "seconds": time.monotonic() - t0, "flash_launches": fa.launches})
    del imported, body
    assert on_card
    assert forward_rel <= INTEROP_RTOL, forward_rel
    assert replay_equal, replay_diff
    assert len(fixtures) >= 4, fixtures
    tf1 = fixtures["tf1_while"]
    assert tf1["iterations"] == 8, tf1
    assert fa.launches == 0, fa.launches
    return fa.launches


def _nchw_input(pb_in: str, pb_out: str, name: str = "input") -> str:
    """``pb_in`` with its NHWC placeholder ``name`` fed by a Transpose of
    a new NCHW placeholder (the image pipeline's batches); returns the
    new input's name."""
    import numpy as np

    from bigdl_tpu_torch.utils import protowire as pw

    def node(nm, op, inputs=(), attrs=b""):
        out = pw.enc_string(1, nm) + pw.enc_string(2, op)
        for i in inputs:
            out += pw.enc_string(3, i)
        return pw.enc_bytes(1, out + attrs)

    perm = np.asarray([0, 2, 3, 1], np.int32)
    tensor = (pw.enc_varint(1, 3)
              + pw.enc_bytes(2, pw.enc_bytes(2, pw.enc_varint(1, 4)))
              + pw.enc_bytes(4, perm.tobytes()))
    value = pw.enc_bytes(5, pw.enc_string(1, "value")
                         + pw.enc_bytes(2, pw.enc_bytes(8, tensor)))
    with open(pb_in, "rb") as f:
        nodes = pw.decode(f.read()).get(1, [])
    kept = [pw.enc_bytes(1, nb) for nb in nodes
            if pw.as_string(pw.decode(nb)[1][0]) != name]
    assert len(kept) == len(nodes) - 1
    new = name + "_nchw"
    with open(pb_out, "wb") as f:
        f.write(node(new, "Placeholder") + node(name + "_perm", "Const",
                                                attrs=value)
                + node(name, "Transpose", [new, name + "_perm"])
                + b"".join(kept))
    return new


def tf_predict_main(torch, fa, smi) -> int:
    """tf_predict_main (f32, TF32 off): tf_import_gate's VGG-16 body
    (the zoo's ``Vgg16`` without its ``LogSoftMax``, rebuilt NHWC)
    exported by ``save_tf`` with an NCHW input Transpose, then
    ``convert_model --from tf --to bigdl`` and the image-classification
    main over ``TF_PREDICT`` seeded 224 x 224 images with ``--model-type
    tf`` and with ``bigdl`` on the converted file: equal classes, and
    equal to the original NCHW body's on the main's own batches except
    where the original's two best scores lie within ``NEAR_TIE`` (each
    such image is printed). Returns the flash launches (0)."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch.example.imageclassification import predict as ic
    from bigdl_tpu_torch.models import Vgg16
    from bigdl_tpu_torch.utils import convert_model
    from bigdl_tpu_torch.utils.tf_export import save_tf

    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    fa.launches = 0
    t0 = time.monotonic()
    nchw = _body(torch, Vgg16(1000, seed=0, device="cuda"))
    nchw.evaluate()
    body = _vgg16_nhwc(torch, nchw)
    body.evaluate()
    side = TF_PREDICT["side"]
    rng = np.random.RandomState(TF_PREDICT["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(TF_PREDICT["images"]):
            # blocks of 32 x 32 pixels, each image its own pattern
            img = np.kron(rng.rand(side // 32, side // 32, 3),
                          np.ones((32, 32, 1)))
            np.save(os.path.join(tmp, f"img{i:03d}.npy"),
                    img.astype(np.float32))
        images = os.path.join(tmp, "img*.npy")
        x = torch.cat(list(_image_batches(torch, images, side))).cuda()
        raw = os.path.join(tmp, "vgg16_nhwc.pb")
        save_tf(body, (side, side, 3), raw)
        del body
        pb = os.path.join(tmp, "vgg16.pb")
        inp = _nchw_input(raw, pb)
        os.remove(raw)
        dst = os.path.join(tmp, "vgg16.bigdl")
        _, convert_s = _timed(torch, lambda: convert_model.main(
            ["--from", "tf", "--to", "bigdl", "--input", pb, "--tf-inputs",
             inp, "--tf-outputs", "output", "--output", dst, "--device",
             "cuda"]))
        batch, resize = str(TF_PREDICT["batch"]), f"{side},{side}"
        got, tf_s = _timed(torch, lambda: ic.main(
            ["--model", pb, "--model-type", "tf", "--tf-inputs", inp,
             "--tf-outputs", "output", "--images", images, "--batch-size",
             batch, "--resize", resize, "--device", "cuda"]))
        want, bigdl_s = _timed(torch, lambda: ic.main(
            ["--model", dst, "--model-type", "bigdl", "--images", images,
             "--batch-size", batch, "--resize", resize, "--device",
             "cuda"]))
        with torch.inference_mode():
            scores = torch.cat([nchw(x[i:i + TF_PREDICT["batch"]])
                                for i in range(0, len(x),
                                               TF_PREDICT["batch"])])
    direct = (scores.argmax(1) + 1).tolist()
    top2 = scores.topk(2, dim=1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    parted = [i for i, (a, b) in enumerate(zip(got, direct)) if a != b]
    near = [{"image": i, "tf": got[i], "original": direct[i],
             "gap": gaps[i]} for i in parted if gaps[i] <= NEAR_TIE]
    counts = np.bincount(got, minlength=1001)[1:]
    emit({"phase": "tf_predict_main", "nvidia_smi": smi,
          "model": "Vgg16(1000) without its LogSoftMax, NHWC, via save_tf "
                   "+ an NCHW Transpose",
          "images": len(got), "side": side, "batch": TF_PREDICT["batch"],
          "distinct_classes": int((counts > 0).sum()),
          "largest_class_count": int(counts.max()),
          "classes_equal": got == want, "convert_s": convert_s,
          "main_tf_s": tf_s, "main_bigdl_s": bigdl_s,
          "parted_from_the_original": parted, "near_ties": near,
          "near_tie": NEAR_TIE, "min_gap": min(gaps),
          "seconds": time.monotonic() - t0, "flash_launches": fa.launches})
    assert len(got) == TF_PREDICT["images"]
    assert got == want, (got, want)
    assert len(near) == len(parted), (parted, near)
    assert len(set(got)) > 1, got
    assert fa.launches == 0, fa.launches
    return fa.launches


def tf_session_train(torch, fa, smi) -> int:
    """tf_session_train: ``Session.train`` on the card over the committed
    unfrozen TF1 linear graph (``VariableV2`` + ``Assign``, the JAX
    ``tests/test_tf_session.py`` model): mse < 0.01 and ``w`` within 0.15
    of the target, the Variables updated in place. Returns the flash
    launches (0)."""
    import numpy as np

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.utils.tf_session import Session

    fa.launches = 0
    t0 = time.monotonic()
    cfg = TF_SESSION
    w_true = np.asarray([[1.0], [-2.0], [0.5]], np.float32)
    rng = np.random.RandomState(0)
    x = rng.randn(cfg["samples"], 3).astype(np.float32)
    y = x @ w_true + 0.25
    sess = Session(os.path.join(TF_FIXTURES, "tf1_linear.pb"), ["x"],
                   ["pred"], device="cuda")
    w_param = sess._loader.variables["w"].value
    assert w_param.is_cuda
    _, train_s = _timed(torch, lambda: sess.train(
        [Sample(x[i], y[i]) for i in range(cfg["samples"])],
        tnn.MSECriterion(), optim_method=SGD(learning_rate=cfg["lr"]),
        end_when=Trigger.max_epoch(cfg["epochs"]), batch_size=cfg["batch"]))
    pred = sess.predict(x).float().cpu().numpy()
    mse = float(np.mean((pred - y) ** 2))
    w = w_param.detach().float().cpu().numpy()
    steps = cfg["epochs"] * cfg["samples"] // cfg["batch"]
    emit({"phase": "tf_session_train", "nvidia_smi": smi,
          "graph": "tests/data/torch_tf/tf1_linear.pb", "mse": mse,
          "w": w.reshape(-1).tolist(), "w_true": w_true.reshape(-1).tolist(),
          "b": sess._loader.variables["b"].value.detach().cpu().tolist(),
          "steps": steps, "train_s": train_s,
          "ms_a_step": 1000.0 * train_s / steps,
          "in_place": sess._loader.variables["w"].value is w_param,
          "seconds": time.monotonic() - t0, "flash_launches": fa.launches})
    assert mse < 0.01, mse
    assert float(np.abs(w - w_true).max()) <= 0.15, w
    assert sess._loader.variables["w"].value is w_param
    assert fa.launches == 0, fa.launches
    return fa.launches


def _mnist_like(seed, n_train, n_test):
    """28 x 28 images: one of 10 fixed random templates plus noise, the
    label its template (one-hot and 1-based)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    templates = rng.rand(10, 1, 28, 28).astype(np.float32)
    n = n_train + n_test
    labels = rng.randint(0, 10, n)
    x = (0.6 * templates[labels]
         + 0.8 * rng.rand(n, 1, 28, 28)).astype(np.float32)
    return x, labels


def _imdb_like(cfg):
    """Token sequences of ``maxlen`` ids below ``vocab``: 70% of a
    positive one's tokens come from the lower half of ``signal_tokens``
    ids, a negative one's from the upper half, the rest from the whole
    vocabulary."""
    import numpy as np

    rng = np.random.RandomState(cfg["seed"])
    n, t, v = cfg["train"] + cfg["test"], cfg["maxlen"], cfg["vocab"]
    k = cfg["signal_tokens"] // 2
    y = rng.randint(0, 2, n)
    half = rng.randint(0, k, (n, t)) + np.where(y[:, None] == 1, 0, k)
    noise = rng.randint(0, v, (n, t))
    x = np.where(rng.rand(n, t) < 0.7, half, noise)
    return x.astype(np.float32), y.astype(np.float32)


def _keras_fit(torch, model, x, y, batch, epochs):
    t = time.monotonic()
    model.fit(x, y, batch_size=batch, nb_epoch=epochs)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t
    steps = epochs * -(-len(x) // batch)
    return {"steps": steps, "fit_s": seconds,
            "ms_a_step": 1000.0 * seconds / steps,
            "records_a_s": epochs * len(x) / seconds}


def keras_train(torch, fa, smi) -> int:
    """keras_train: two Keras examples at their published widths on the
    card, trained on synthetic data from a fixed seed whose labels can
    be learnt: Keras 1.2.2's ``mnist_cnn.py`` (compile / fit / evaluate,
    batch 128; Adam where the example takes Adadelta, whose first steps
    with eps 1e-10 barely move in two epochs) and ``imdb_lstm.py`` (Embedding 20000 x 128, LSTM 128,
    Dense 1 sigmoid, maxlen 80, batch 32, binary cross-entropy); each
    beats chance on held-out data and runs ``predict_classes``. The
    mnist topology then goes through ``DefinitionLoader`` from
    ``MNIST_CNN_JSON`` with the trained weights set from numpy: equal
    classes. Returns the flash launches (0)."""
    import numpy as np

    from bigdl_tpu_torch import keras as K
    from bigdl_tpu_torch.keras.converter import DefinitionLoader
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.utils.weights import (load_jax_params,
                                               params_to_numpy)

    fa.launches = 0
    t0 = time.monotonic()
    rows = {}
    cfg = KERAS_MNIST
    torch.manual_seed(cfg["seed"])
    x, labels = _mnist_like(cfg["seed"], cfg["train"], cfg["test"])
    onehot = np.eye(10, dtype=np.float32)[labels]
    xtr, ytr, xte = x[:cfg["train"]], onehot[:cfg["train"]], x[cfg["train"]:]
    cuda = {"device": "cuda"}
    m = K.Sequential()
    m.add(K.Convolution2D(32, 3, 3, activation="relu",
                          input_shape=(1, 28, 28), **cuda))
    m.add(K.Convolution2D(32, 3, 3, activation="relu", **cuda))
    m.add(K.MaxPooling2D((2, 2), **cuda))
    m.add(K.Dropout(0.25, **cuda))
    m.add(K.Flatten(**cuda))
    m.add(K.Dense(128, activation="relu", **cuda))
    m.add(K.Dropout(0.5, **cuda))
    m.add(K.Dense(10, activation="softmax", **cuda))
    m.compile(optimizer=Adam(learning_rate=cfg["lr"]),
              loss="categorical_crossentropy", metrics=["accuracy"])
    row = _keras_fit(torch, m, xtr, ytr, cfg["batch"], cfg["epochs"])
    (_, acc), = m.evaluate(xte, labels[cfg["train"]:, None] + 1.0,
                           batch_size=cfg["batch"])
    classes = m.predict_classes(xte, batch_size=cfg["batch"])
    pc_acc = float(np.mean(classes == labels[cfg["train"]:]))
    json_model = DefinitionLoader.from_json_str(MNIST_CNN_JSON, device="cuda")
    load_jax_params(json_model, params_to_numpy(m))
    json_model.evaluate()
    json_classes = json_model.predict_classes(xte, batch_size=cfg["batch"])
    rows["mnist_cnn"] = dict(row, evaluate_accuracy=acc,
                             predict_classes_accuracy=pc_acc, chance=0.1,
                             json_reload_classes_equal=bool(
                                 np.array_equal(json_classes, classes)))

    cfg = KERAS_IMDB
    torch.manual_seed(cfg["seed"])
    x, y = _imdb_like(cfg)
    n = cfg["train"]
    lm = K.Sequential()
    lm.add(K.Embedding(cfg["vocab"], 128, input_length=cfg["maxlen"], **cuda))
    lm.add(K.LSTM(128, **cuda))
    lm.add(K.Dense(1, activation="sigmoid", **cuda))
    lm.compile(optimizer=Adam(learning_rate=cfg["lr"]),
               loss="binary_crossentropy")
    row = _keras_fit(torch, lm, x[:n], y[:n, None], cfg["batch"],
                     cfg["epochs"])
    prob = np.asarray(lm.predict(x[n:], batch_size=cfg["batch"])).reshape(-1)
    acc = float(np.mean((prob > 0.5) == (y[n:] > 0.5)))
    lm_classes = lm.predict_classes(x[n:], batch_size=cfg["batch"])
    rows["imdb_lstm"] = dict(row, held_out_accuracy=acc, chance=0.5,
                             predict_classes_rows=int(len(lm_classes)))
    emit({"phase": "keras_train", "nvidia_smi": smi, "rows": rows,
          "seconds": time.monotonic() - t0, "flash_launches": fa.launches})
    assert rows["mnist_cnn"]["evaluate_accuracy"] > 0.5, rows
    assert rows["mnist_cnn"]["json_reload_classes_equal"], rows
    assert rows["imdb_lstm"]["held_out_accuracy"] > 0.7, rows
    assert fa.launches == 0, fa.launches
    return fa.launches


def _capture_kernels(torch, name_of_loop, tmp):
    """A ``PROFILE_CAPTURE_S`` capture asked for on this thread while
    ``run`` (already going on another thread) launches: the CUDA kernel
    events in the trace and the thread that started the session."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.observability import profiler
    from bigdl_tpu_torch.observability.events import FlightRecorder

    rec = FlightRecorder()
    prev = obs.set_default_recorder(rec)
    t_ask = time.monotonic()
    try:
        path = profiler.capture(PROFILE_CAPTURE_S, out_dir=tmp)
    finally:
        obs.set_default_recorder(prev)
    took = time.monotonic() - t_ask
    traces = [f for f in os.listdir(path) if f.endswith(".pt.trace.json")]
    ts = {e.kind: e.ts for e in rec.tail()}
    starts = [e.attrs["thread"] for e in rec.tail()
              if e.kind == "profiler/capture_start"]
    return {"kernels": sum(_trace_kernels(os.path.join(path, t))
                           for t in traces),
            "started_on": starts, "loop": name_of_loop,
            "wait_s": ts["profiler/capture_start"] - t_ask,
            "held_s": ts["profiler/capture_done"]
            - ts["profiler/capture_start"], "took_s": took}


def profiler_hosting(torch, fa, smi) -> int:
    """profiler_hosting: 1 s ``capture`` calls asked for on the main
    thread while a ``GenerationService`` at phase 6's server settings
    (the f32 flagship, ``max_batch`` 8, a 500 ms window, three clients so
    that every batch waits out its window, ``PROFILE_NEW_TOKENS`` a
    request) and then a ``LocalOptimizer``
    (its step loop) launch on threads of their own: one capture asked for
    while the batcher's drain thread waits out a window, one while it
    runs a batch (longer than ``profiler.HANDOFF_S``), one during
    training. Each trace holds CUDA kernel events and each session
    started on the launching thread; ``wait_s`` is how long the capture
    waited from the ask to the session's start, ``held_s`` the session
    from start to its trace written. Returns the flash launches of the
    generation requests."""
    import tempfile
    import threading

    import numpy as np

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.optim.generation_service import GenerationService

    from bigdl_tpu_torch.observability import profiler

    fa.launches = 0
    t0 = time.monotonic()
    rows = {}
    # the profiler's first start in a process initialises CUPTI: pay it
    # here, with no loop running, so that wait_s is the wait for a host
    with tempfile.TemporaryDirectory() as tmp:
        _, warm_s = _timed(torch, lambda: profiler.capture(0.05,
                                                           out_dir=tmp))
    lm = TransformerLM(**FLAGSHIP, seed=0, device="cuda",
                       dtype=torch.float32)
    lm.evaluate()
    svc = GenerationService(lm, max_batch=8, batch_timeout_ms=500.0,
                            bucket_tokens=32, prompt_bucket=64,
                            service_name="gen-profile")
    g = torch.Generator().manual_seed(28)
    prompts = torch.randint(0, FLAGSHIP["vocab_size"], (8, 256), generator=g)
    stop = threading.Event()
    served = []

    def client(c):
        i = c
        while not stop.is_set():
            n = SERVER_LENGTHS[i % 8]
            served.append(svc.generate(prompts[i % 8, :n].numpy(),
                                       PROFILE_NEW_TOKENS))
            i += 3

    clients = [threading.Thread(target=client, args=(c,), name=f"client{c}")
               for c in range(3)]
    for c in clients:
        c.start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            time.sleep(0.1)                    # inside the first window
            rows["generation_window"] = _capture_kernels(
                torch, "gen-profile-drain", os.path.join(tmp, "a"))
            # the next batch: asked for just after its dispatch starts
            seen = svc.stats()["dispatches"]
            deadline = time.monotonic() + 120
            while svc.stats()["dispatches"] == seen:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            rows["generation_mid_batch"] = _capture_kernels(
                torch, "gen-profile-drain", os.path.join(tmp, "b"))
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=120)
    rows["generation_mid_batch"]["requests_served"] = len(served)
    gen_launches = fa.launches
    del svc, lm

    rs = np.random.RandomState(30)
    samples = [Sample(rs.randn(512).astype(np.float32), float(i % 10 + 1))
               for i in range(2048)]
    model = tnn.Sequential(tnn.Linear(512, 1024, device="cuda"), tnn.ReLU(),
                           tnn.Linear(1024, 10, device="cuda"),
                           tnn.LogSoftMax())
    opt = Optimizer(model=model, dataset=samples,
                    criterion=tnn.ClassNLLCriterion(), batch_size=64,
                    end_when=Trigger.max_iteration(10 ** 7))
    opt.set_optim_method(SGD(learning_rate=0.01))
    trainer = threading.Thread(target=opt.optimize, name="local-train")
    trainer.start()
    try:
        deadline = time.monotonic() + 120
        while opt.optim_method.state.get("neval", 1) < 5:
            assert time.monotonic() < deadline and trainer.is_alive()
            time.sleep(0.01)
        with tempfile.TemporaryDirectory() as tmp:
            rows["local_optimizer"] = _capture_kernels(
                torch, "local-train", tmp)
    finally:
        opt.end_when = Trigger.max_iteration(0)
        trainer.join(timeout=120)
    rows["local_optimizer"]["steps"] = opt.optim_method.state.get("neval")
    emit({"phase": "profiler_hosting", "nvidia_smi": smi,
          "capture_s": PROFILE_CAPTURE_S, "first_capture_s": warm_s,
          "rows": rows,
          "seconds": time.monotonic() - t0, "flash_launches": gen_launches})
    for key, row in rows.items():
        assert row["kernels"] > 0, ("the capture holds no CUDA kernel", key,
                                    row)
        assert row["started_on"] == [row["loop"]], (key, row)
    # the mid-batch capture really waited out a batch past the handoff
    assert rows["generation_mid_batch"]["wait_s"] > profiler.HANDOFF_S, rows
    return gen_launches



# --------------------------------------------- the last modules (slice 22)
_GLYPHS = {  # 3 x 5 digit bitmaps, the JAX convergence test's font
    0: ["111", "101", "101", "101", "111"],
    1: ["010", "110", "010", "010", "111"],
    2: ["111", "001", "111", "100", "111"],
    3: ["111", "001", "111", "001", "111"],
    4: ["101", "101", "111", "001", "001"],
    5: ["111", "100", "111", "001", "111"],
    6: ["111", "100", "111", "101", "111"],
    7: ["111", "001", "010", "010", "010"],
    8: ["111", "101", "111", "101", "111"],
    9: ["111", "101", "111", "001", "111"],
}


def _draw_digits(n, seed):
    """28 x 28 uint8 digit images (rendered glyphs at random places, with
    sensor noise) and their 0-based labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    imgs = np.zeros((n, 28, 28), np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    for i, c in enumerate(labels):
        glyph = np.array([[int(ch) for ch in row] for row in _GLYPHS[c]],
                         np.float32)
        up = np.kron(glyph, np.ones((4, 5), np.float32))    # (20, 15)
        dy, dx = rng.randint(0, 28 - 20), rng.randint(0, 28 - 15)
        canvas = np.zeros((28, 28), np.float32)
        canvas[dy:dy + 20, dx:dx + 15] = up * 255.0
        canvas += rng.randn(28, 28) * 16.0
        imgs[i] = np.clip(canvas, 0, 255).astype(np.uint8)
    return imgs, labels


def _digit_frames(np):
    """(train, test) pandas frames of normalized rendered digits as
    28 x 28 features and 1-based float labels, and the test labels."""
    import pandas as pd

    from bigdl_tpu_torch.dataset.mnist import TRAIN_MEAN, TRAIN_STD

    cfg = DLFRAMES
    imgs, labels = _draw_digits(cfg["train"] + cfg["test"], 7)
    x = (imgs.astype(np.float32) - TRAIN_MEAN) / TRAIN_STD
    y = labels.astype(np.float32) + 1
    n = cfg["train"]
    train = pd.DataFrame({"features": list(x[:n]), "label": list(y[:n])})
    test = pd.DataFrame({"features": list(x[n:]), "label": list(y[n:])})
    return train, test, y[n:]


def dlframes_train(torch, fa, smi) -> int:
    """dlframes_train: the reference's DLClassifierLeNet example on the
    card: a ``DLClassifier`` over the port's LeNet-5 fitted on rendered
    digits (its first ``first_iters`` losses held to the same fit on the
    CPU from the same weights), held-out accuracy from ``transform``,
    then ``make_udf`` over the test rows from threads with
    micro-batching, its classes equal to ``transform``'s but at near
    ties. No flash launch."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dlframes import DLClassifier
    from bigdl_tpu_torch.example.udfpredictor.predict import make_udf
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.visualization import TrainSummary

    cfg = DLFRAMES
    fa.launches = 0
    t_phase = time.monotonic()
    train, test, y_test = _digit_frames(np)

    def fit(device, end, summary=None, seed=1):
        clf = (DLClassifier(LeNet5(10, seed=seed, device=device),
                            nn.ClassNLLCriterion(), [28, 28])
               .set_batch_size(cfg["batch"]).set_end_when(end)
               .set_optim_method(SGD(learning_rate=cfg["lr"],
                                     momentum=0.9)))
        if summary is not None:
            clf.set_train_summary(summary)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.monotonic()
        fitted = clf.fit(train)
        if device == "cuda":
            torch.cuda.synchronize()
        return fitted, time.monotonic() - t0

    first = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cpu", "cuda"):
            summ = TrainSummary(tmp, dev)
            fit(dev, Trigger.max_iteration(cfg["first_iters"]), summ)
            first[dev] = [v for _, _, v in summ.read_scalar("Loss")]
            summ.close()
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(first["cuda"], first["cpu"]))
    fitted, fit_s = fit("cuda", Trigger.max_epoch(cfg["epochs"]))
    t0 = time.monotonic()
    out = fitted.transform(test)
    transform_s = time.monotonic() - t0
    preds = np.asarray(out["prediction"].tolist())
    acc = float((preds == y_test).mean())
    raw = fitted._forward_all(test)
    udf = make_udf(fitted.model, concurrent=True, sample_ndim=2)
    rows = test["features"].tolist()
    t0 = time.monotonic()
    with ThreadPoolExecutor(cfg["udf_threads"]) as ex:
        udf_preds = np.asarray(list(ex.map(udf, rows)))
    udf_s = time.monotonic() - t0
    apart = np.nonzero(udf_preds != preds)[0]
    top2 = np.sort(raw, -1)[:, -2:]
    margins = [float(top2[i, 1] - top2[i, 0]) for i in apart]
    rec = {"phase": "dlframes_train", "nvidia_smi": smi,
           "train_rows": cfg["train"], "test_rows": cfg["test"],
           "batch": cfg["batch"], "epochs": cfg["epochs"],
           "first_losses": first, "first_loss_max_rel": loss_rel,
           "rtol": DLFRAMES_LOSS_RTOL, "fit_seconds": fit_s,
           "iterations": cfg["epochs"] * cfg["train"] // cfg["batch"],
           "ms_per_iteration": fit_s * 1e3 * cfg["batch"] / (
               cfg["epochs"] * cfg["train"]),
           "transform_seconds": transform_s,
           "transform_tail_rows": cfg["test"] % cfg["batch"],
           "held_out_accuracy": acc,
           "udf_rows": len(rows), "udf_seconds": udf_s,
           "udf_apart": len(apart), "udf_apart_margins": margins,
           "seconds": time.monotonic() - t_phase,
           "flash_launches": fa.launches}
    emit(rec)
    assert len(first["cpu"]) == len(first["cuda"]) == cfg["first_iters"]
    assert preds.shape == (cfg["test"],), rec
    assert loss_rel <= DLFRAMES_LOSS_RTOL, rec
    assert acc >= 0.9, rec
    assert all(m < DLFRAMES_NEAR_TIE for m in margins), rec
    assert fa.launches == 0, rec
    return fa.launches


def _bucket_seam(root):
    """``utils/file.py``'s ``_epath`` seam over ``root``: ``gs://b/x``
    becomes the ``pathlib`` path ``root/x`` (with epath's ``rmtree``).
    The remote code path runs: no ``os.*`` call sees the URL."""
    import pathlib
    import shutil

    class _Path(type(pathlib.Path())):
        def rmtree(self):
            shutil.rmtree(self)

    def seam(path):
        s = str(path)
        assert "://" in s, f"_epath must only see remote paths, got {s}"
        tail = s.split("://", 1)[1].split("/", 1)
        return _Path(os.path.join(root, tail[1] if len(tail) > 1 else ""))

    return seam


def _bucket_run(torch, path, async_write):
    """A LocalOptimizer on the card checkpointing to ``path`` every
    ``BUCKET["every"]`` iterations; the trained model and the newest
    checkpoint loaded back on the card, and the file names."""
    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer,
                                                 load_latest_checkpoint)
    from bigdl_tpu_torch.utils import file as bt_file

    rs = np.random.RandomState(3)
    samples = [Sample(rs.randn(256).astype(np.float32),
                      np.float32(1 + i % 4)) for i in range(64)]
    model = nn.Sequential(nn.Linear(256, 1024, device="cuda"), nn.Tanh(),
                          nn.Linear(1024, 4, device="cuda"),
                          nn.LogSoftMax())
    opt = LocalOptimizer(model=model, training_set=samples,
                         criterion=nn.ClassNLLCriterion(), batch_size=16,
                         end_when=Trigger.max_iteration(BUCKET["iterations"]))
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    opt.set_checkpoint(path, Trigger.several_iteration(BUCKET["every"]),
                       async_write=async_write)
    t0 = time.monotonic()
    trained = opt.optimize()
    secs = time.monotonic() - t0
    back, method, tag = load_latest_checkpoint(path, device="cuda")
    equal = all(torch.equal(a, b) for a, b in zip(back.parameters(),
                                                   trained.parameters()))
    return {"equal_bit_for_bit": equal, "tag": tag,
            "neval": method.state["neval"], "seconds": secs,
            "files": sorted(bt_file.listdir(path))}


def bucket_io(torch, fa, smi) -> int:
    """bucket_io: the object-store paths of the file layer on the card,
    through its ``_epath`` seam over a local directory: a sync and an
    async checkpoint trigger of a LocalOptimizer (the newest checkpoint
    loaded back equal to the trained model bit for bit), the serving
    flagship's module through ``save_module`` / ``load_module``, and a
    sharded checkpoint of its parameters with a slot tree (meta last),
    restored onto the card equal bit for bit to the tensors saved and to
    the same checkpoint written to a local path. No flash launch."""
    import tempfile

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils import file as bt_file
    from bigdl_tpu_torch.utils import sharded_ckpt

    fa.launches = 0
    t_phase = time.monotonic()
    real = bt_file._epath
    with tempfile.TemporaryDirectory() as tmp:
        bt_file._epath = _bucket_seam(os.path.join(tmp, "bucket"))
        try:
            ckpt = {"sync": _bucket_run(torch, "gs://bucket/sync", False),
                    "async": _bucket_run(torch, "gs://bucket/async", True)}
            model = TransformerLM(**FLAGSHIP, seed=0, device="cuda",
                                  dtype=torch.bfloat16)
            bt_file.makedirs("gs://bucket/models")
            torch.cuda.synchronize()
            t0 = time.monotonic()
            bt_file.save_module(model, "gs://bucket/models/flagship")
            save_s = time.monotonic() - t0
            t0 = time.monotonic()
            back = bt_file.load_module("gs://bucket/models/flagship",
                                       device="cuda")
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            module_equal = all(torch.equal(a, b) for a, b in zip(
                back.parameters(), model.parameters()))
            module_mb = os.path.getsize(os.path.join(
                tmp, "bucket", "models", "flagship")) / 1e6
            params = model.params_dict()
            slots = {"momentum": {k: v.float() * 0.5 for k, v in
                                  params["~params"].items()},
                     "neval": torch.tensor(7, device="cuda")}
            like = (params, {}, slots)
            restored, secs = {}, {}
            for name, path in (("bucket", "gs://bucket/sharded/ck"),
                               ("local", os.path.join(tmp, "local", "ck"))):
                t0 = time.monotonic()
                sharded_ckpt.save_train_state(path, 7, params, {}, slots,
                                              {"Loss": 0.5})
                secs[f"{name}_save"] = time.monotonic() - t0
                t0 = time.monotonic()
                restored[name] = sharded_ckpt.restore_train_state(path,
                                                                  like=like)
                torch.cuda.synchronize()
                secs[f"{name}_restore"] = time.monotonic() - t0
            meta_first = sorted(os.listdir(os.path.join(tmp, "bucket",
                                                        "sharded")))
        finally:
            bt_file._epath = real

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    saved = leaves((params, {}, slots))
    b_leaves = leaves(restored["bucket"][1:4])
    l_leaves = leaves(restored["local"][1:4])
    sharded_equal = (len(saved) == len(b_leaves) == len(l_leaves)
                     and all(torch.equal(a, b) and torch.equal(b, c)
                             and b.is_cuda
                             for a, b, c in zip(saved, b_leaves, l_leaves)))
    rec = {"phase": "bucket_io", "nvidia_smi": smi,
           "checkpoints": ckpt,
           "module": {"equal_bit_for_bit": module_equal, "mb": module_mb,
                      "save_seconds": save_s, "load_seconds": load_s},
           "sharded": {"equal_bit_for_bit": sharded_equal,
                       "step": [restored["bucket"][0],
                                restored["local"][0]],
                       "state": restored["bucket"][4],
                       "bucket_files": meta_first, "seconds": secs,
                       "leaves": len(saved)},
           "seconds": time.monotonic() - t_phase,
           "flash_launches": fa.launches}
    emit(rec)
    for c in ckpt.values():
        assert c["equal_bit_for_bit"] and c["tag"] == BUCKET["iterations"], rec
        assert not any(f.startswith(".") for f in c["files"]), rec
    assert module_equal and sharded_equal, rec
    assert restored["bucket"][0] == restored["local"][0] == 7, rec
    assert restored["bucket"][4] == {"Loss": 0.5}, rec
    assert meta_first == ["ck", "ck.meta.json"], rec
    assert fa.launches == 0, rec
    return fa.launches


def _first_apart(rows, ref_rows, ref_logits, t0):
    """The rows that part from the reference's, each with its first
    position and the reference's top-two margin there."""
    out = []
    for i in range(rows.shape[0]):
        diff = (rows[i] != ref_rows[i]).nonzero()
        if len(diff):
            j = int(diff[0]) - t0
            top2 = ref_logits[i, j].topk(2).values
            out.append({"row": i, "position": j,
                        "margin": (top2[0] - top2[1]).item()})
    return out


def _seq_decode(torch, C, world) -> dict:
    """seq_decode on one rank: the serving flagship (f32) decoding with
    its caches split over the sequence of a ``("seq", world)`` mesh, each
    rank holding ``max_len / world`` positions, a prompt that fills more
    than one block; its tokens against the unsplit caches' (rows may part
    only at a near tie of the unsplit run)."""
    import numpy as np

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.parallel.tp import P, NamedSharding

    cfg = SEQ_DECODE
    mesh = Engine.create_mesh([("seq", world)])
    sh = NamedSharding(mesh, P(None, None, "seq", None))
    model = TransformerLM(**FLAGSHIP, seed=0, device="cuda",
                          dtype=torch.float32)
    model.evaluate()
    prompt = torch.as_tensor(np.random.RandomState(11).randint(
        0, FLAGSHIP["vocab_size"], (cfg["batch"], cfg["prompt"])),
        device="cuda")
    local = tuple(model.init_cache(cfg["batch"], cfg["max_len"],
                                   sharding=sh)[0][0].shape)
    runs = {}
    for name, layout in (("sharded", sh), ("whole", None)):
        C.barrier(None)
        torch.cuda.synchronize()
        gathers = C.calls["all_gather"]
        t0 = time.monotonic()
        toks, seen = model.generate(prompt, cfg["new"],
                                    max_len=cfg["max_len"],
                                    kv_cache_sharding=layout,
                                    return_logits=True)
        torch.cuda.synchronize()
        runs[name] = (toks, seen, time.monotonic() - t0,
                      C.calls["all_gather"] - gathers)
    apart = _first_apart(runs["sharded"][0], runs["whole"][0],
                         runs["whole"][1], cfg["prompt"])
    held = [cfg["new"]] * cfg["batch"]     # steps fed the same prefix
    for a in apart:
        held[a["row"]] = a["position"] + 1
    diff = (runs["sharded"][1] - runs["whole"][1]).abs()
    return {"local_cache": list(local), "apart": apart,
            "rows_equal": cfg["batch"] - len(apart),
            "max_logit_diff": max(diff[i, :h].max().item()
                                  for i, h in enumerate(held)),
            "max_abs_logit": runs["whole"][1].abs().max().item(),
            "sharded_seconds": runs["sharded"][2],
            "whole_seconds": runs["whole"][2],
            "sharded_all_gathers": runs["sharded"][3],
            "sharded_ms_per_token": runs["sharded"][2] * 1e3 / cfg["new"],
            "whole_ms_per_token": runs["whole"][2] * 1e3 / cfg["new"]}


def _int8_2d(torch, world) -> dict:
    """int8_2d on one rank: the serving flagship's int8 clone sharded
    under 2-D rules on a ``("data", world) x ("model", 1)`` mesh (codes
    and scales whole on every rank, the f32 token table split over the
    data axis): its forward EQUAL to the unsharded clone's, its greedy
    tokens too."""
    import numpy as np

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn.quantized import Quantizer
    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.parallel.tp import shard_model, transformer_tp_rules

    cfg = SLICE22_CHECK
    mesh = Engine.create_mesh([("data", world), ("model", 1)])
    q = Quantizer.quantize(TransformerLM(**dict(FLAGSHIP, use_flash=False),
                                         seed=0, device="cuda",
                                         dtype=torch.float32))
    q.evaluate()
    local = shard_model(q, mesh, transformer_tp_rules("model", "data"))
    ids = torch.as_tensor(np.random.RandomState(12).randint(
        0, FLAGSHIP["vocab_size"], (cfg["batch"], cfg["seq"])),
        device="cuda")
    with torch.inference_mode():
        a, b = local(ids), q(ids)
    prompt = ids[:, :64]
    t_sh = local.generate(prompt, cfg["new"])
    t_wh = q.generate(prompt, cfg["new"])
    return {"forward_equal": bool(torch.equal(a, b)),
            "tokens_equal": bool(torch.equal(t_sh, t_wh)),
            "table_block": list(local.tok_embed.shape),
            "qkv_codes": list(local.block0.attn.qkv.weight_q.shape)}


def _moe_mesh(torch, mesh) -> dict:
    """moe_mesh on one rank: the serving flagship with
    ``n_experts=SLICE22_CHECK["experts"]`` (f32) on the tensor-parallel
    mesh, attention split by heads and the experts whole on every rank:
    its forward against the unsharded model's, its greedy tokens (rows
    may part only at a near tie)."""
    import numpy as np

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.parallel.tp import shard_model

    cfg = SLICE22_CHECK
    m = TransformerLM(**dict(FLAGSHIP, use_flash=False,
                             n_experts=cfg["experts"]),
                      seed=0, device="cuda", dtype=torch.float32)
    m.evaluate()
    local = shard_model(m, mesh)
    ids = torch.as_tensor(np.random.RandomState(13).randint(
        0, FLAGSHIP["vocab_size"], (cfg["batch"], cfg["seq"])),
        device="cuda")
    with torch.inference_mode():
        a, b = local(ids), m(ids)
    prompt = ids[:, :64]
    t_sh = local.generate(prompt, cfg["new"])
    t_wh, seen = m.generate(prompt, cfg["new"], return_logits=True)
    return {"forward_max_rel": rel_diff(a, b), "rtol": TP_RTOL,
            "apart": _first_apart(t_sh, t_wh, seen, prompt.shape[1]),
            "local_heads": local.block0.attn.num_heads,
            "expert_w1": list(local.block0.mlp.w1.shape)}


def _convergence(torch, C, rank) -> dict:
    """convergence on one rank: the JAX package's two convergence cases
    through the sharded ``DistriOptimizer`` over the launch's ranks
    (gloo, sharing the card): LeNet-5 on rendered digits after the MNIST
    idx round trip (``lenet_steps`` steps, held-out accuracy), ResNet-20
    on the class-template CIFAR set (``resnet_steps`` steps, train
    accuracy and loss)."""
    import tempfile

    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample, mnist
    from bigdl_tpu_torch.models import DatasetType, LeNet5, ResNet
    from bigdl_tpu_torch.optim import SGD, Top1Accuracy, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer

    cfg = CONVERGENCE
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, n, seed in (("train", cfg["lenet_train"], 0),
                              ("t10k", cfg["lenet_test"], 1)):
            imgs, labels = _draw_digits(n, seed)
            mnist.write_images(os.path.join(
                tmp, f"{name}-images-idx3-ubyte"), imgs)
            mnist.write_labels(os.path.join(
                tmp, f"{name}-labels-idx1-ubyte"), labels)
        ti, tl, vi, vl = mnist.read_data_sets(tmp)
    model = LeNet5(10, device="cuda")
    opt = DistriOptimizer(model=model,
                          dataset=DataSet.array(mnist.to_samples(ti, tl)),
                          criterion=nn.ClassNLLCriterion(),
                          batch_size=cfg["lenet_batch"],
                          end_when=Trigger.max_iteration(cfg["lenet_steps"]),
                          parameter_sync="sharded")
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    C.barrier(None)
    t0 = time.monotonic()
    trained = opt.optimize()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    acc, _ = trained.evaluate_on(mnist.to_samples(vi, vl), [Top1Accuracy()],
                                 batch_size=128)[0][1].result()
    out["lenet"] = {"held_out_accuracy": float(acc), "seconds": secs,
                    "ms_per_step": secs * 1e3 / cfg["lenet_steps"]}

    rng = np.random.RandomState(0)
    templates = rng.randn(10, 3, 32, 32).astype(np.float32)
    xs, ys = [], []
    for c in range(10):
        for _ in range(cfg["resnet_per_class"]):
            xs.append(templates[c]
                      + 0.3 * rng.randn(3, 32, 32).astype(np.float32))
            ys.append(np.float32(c + 1))
    order = np.arange(len(xs))
    rng.shuffle(order)
    x, y = np.stack(xs)[order], np.asarray(ys, np.float32)[order]
    model = ResNet(10, {"depth": 20, "dataSet": DatasetType.CIFAR10},
                   device="cuda")
    opt = DistriOptimizer(model=model,
                          dataset=DataSet.array([Sample(a, b)
                                                 for a, b in zip(x, y)]),
                          criterion=nn.CrossEntropyCriterion(),
                          batch_size=cfg["resnet_batch"],
                          end_when=Trigger.max_iteration(
                              cfg["resnet_steps"]),
                          parameter_sync="sharded")
    opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
    C.barrier(None)
    t0 = time.monotonic()
    opt.optimize()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    model.evaluate()
    with torch.inference_mode():
        xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
        logits = model(xt)
        loss = float(nn.CrossEntropyCriterion()(logits, yt))
    acc = float((logits.argmax(1) + 1 == yt).float().mean())
    out["resnet20"] = {"train_accuracy": acc, "train_loss": loss,
                       "seconds": secs,
                       "ms_per_step": secs * 1e3 / cfg["resnet_steps"]}
    return out


def _slice22_rank(torch, fa, C, mesh, rank, world) -> dict:
    """The slice-22 checks on one rank of the --tp-rank launch, each
    counting its flash launches from 0 and timing itself."""
    rec = {}
    for name, run in (("seq_decode", lambda: _seq_decode(torch, C, world)),
                      ("int8_2d", lambda: _int8_2d(torch, world)),
                      ("moe_mesh", lambda: _moe_mesh(torch, mesh)),
                      ("convergence", lambda: _convergence(torch, C, rank))):
        fa.launches = 0
        C.barrier(None)
        t0 = time.monotonic()
        rec[name] = run()
        rec[name]["seconds"] = time.monotonic() - t0
        rec[name]["flash_launches"] = fa.launches
    return rec


def _slice22_lines(smi, ranks) -> int:
    """The --tp-rank launch's slice-22 records as one line a check, each
    asserted; returns the flash launches of both ranks."""
    lead = ranks[0]["slice22"]
    by_rank = [r["slice22"] for r in ranks]
    for name in ("seq_decode", "int8_2d", "moe_mesh", "convergence"):
        emit({"phase": name, "nvidia_smi": smi, "ranks": len(ranks),
              "backend": "gloo", **lead[name],
              "flash_launches_by_rank": [r[name]["flash_launches"]
                                         for r in by_rank],
              "seconds_by_rank": [r[name]["seconds"] for r in by_rank]})
    sd = lead["seq_decode"]
    assert sd["local_cache"][2] == SEQ_DECODE["max_len"] // len(ranks), sd
    for a in sd["apart"]:
        assert abs(a["margin"]) < NEAR_TIE, sd
    assert sd["max_logit_diff"] <= SEQ_DECODE_LOGIT_ATOL, sd
    for r in by_rank:
        assert r["int8_2d"]["forward_equal"], r["int8_2d"]
        assert r["int8_2d"]["tokens_equal"], r["int8_2d"]
        assert r["moe_mesh"]["forward_max_rel"] <= TP_RTOL, r["moe_mesh"]
        for a in r["moe_mesh"]["apart"]:
            assert abs(a["margin"]) < NEAR_TIE, r["moe_mesh"]
        conv = r["convergence"]
        assert conv["lenet"]["held_out_accuracy"] >= 0.97, conv
        assert conv["resnet20"]["train_accuracy"] > 0.85, conv
        assert conv["resnet20"]["train_loss"] < 0.8, conv
    launches = sum(r[n]["flash_launches"] for r in by_rank
                   for n in ("seq_decode", "int8_2d", "moe_mesh",
                             "convergence"))
    assert launches == 0, launches
    return launches


def slice22_ranks(torch, fa, smi) -> int:
    """The slice-22 checks of the --tp-rank launch, launched alone
    (``chip_smoke.py --tp-rank slice22``): for running them by name."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ranks, _ = _launch(tmp, TP["ranks"],
                           [os.path.join(ROOT, "chip_smoke.py"),
                            "--tp-rank", "slice22"], TP_TIMEOUT_S)
    return _slice22_lines(smi, ranks)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.ops import build
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.optim.generation_service import GenerationService

    # ---------------------------------------------------------- 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    # ----------------------------------------------------------- 2. build
    t_build = time.monotonic()
    lib = build.build()
    build_s = time.monotonic() - t_build
    with open(build.build_log()) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln
                 or "Function properties" in ln]
    emit({"phase": "build", "seconds": build_s, "nvcc": build.nvcc_path(),
          "flags": build.NVCC_FLAGS, "library": os.path.relpath(lib, ROOT),
          "sources": [os.path.relpath(p, ROOT) for p in build.sources()],
          "ptxas": ptxas})

    # --------------------------------------------------------- 3. kernels
    bf16, f32 = torch.bfloat16, torch.float32
    flagship = check_flash(torch, fa, (4, 8, 2, 2048, 2048, 64), True, bf16,
                           with_library=True, mutant=True)
    check_flash(torch, fa, (2, 8, 2, 1024, 1024, 64), False, bf16, True)
    check_flash(torch, fa, (2, 8, 2, 256, 2048, 64), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 512, 256, 64), True, bf16, False)
    check_flash(torch, fa, (4, 8, 2, 1000, 1000, 64), True, bf16, True)
    # edges of the bf16 tiling: one query row, a q tile plus one row, a kv
    # tile plus one key (with dead rows), head dims 128 and, zero-padded, 32
    # and 72
    check_flash(torch, fa, (2, 8, 2, 1, 2048, 64), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 129, 129, 64), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 200, 65, 64), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 1024, 1024, 128), True, bf16, True)
    check_flash(torch, fa, (2, 8, 2, 300, 300, 32), True, bf16, False)
    check_flash(torch, fa, (2, 4, 2, 160, 96, 72), False, bf16, False)
    # odd d: element stores in place of TMA copies, single-element outputs
    check_flash(torch, fa, (2, 4, 1, 100, 100, 77), True, bf16, False)
    check_flash(torch, fa, (2, 8, 2, 1024, 1024, 64), True, f32, True)
    # the long-context ring's f32 blocks: the diagonal and a past block
    check_flash(torch, fa, (4, 8, 2, 512, 512, 64), True, f32, False)
    check_flash(torch, fa, (4, 8, 2, 512, 512, 64), False, f32, False)
    # a tp-2 rank's heads of the flagship (tp_gate's scoring forward)
    tp_local = check_flash(torch, fa, (4, 4, 1, 2048, 2048, 64), True,
                           bf16, True)
    # the flagship width over sequence lengths
    sweep = []
    for t in (512, 1024, 2048, 4096, 8192):
        rec = flagship if t == 2048 else check_flash(
            torch, fa, (4, 8, 2, t, t, 64), True, bf16, True)
        sweep.append({"t": t, "tk": t, "kernel_ms": rec["kernel_ms"],
                      "library_ms": rec["library_ms"],
                      "device_ms": rec["device_ms"],
                      "library_device_ms": rec["library_device_ms"],
                      "bound_ms": rec["bound_ms"],
                      "bound_share": rec["bound_ms"] / rec["kernel_ms"],
                      "device_bound_share":
                          rec["bound_ms"] / rec["device_ms"]})
    emit({"phase": "sweep", "kernel": "flash_attention_fwd",
          "shape": {"B": 4, "H": 8, "H_kv": 2, "d": 64}, "dtype": "bfloat16",
          "causal": True, "nvidia_smi": smi, "rows": sweep})
    emit({"phase": "prior", "kernel": "flash_attention_fwd",
          "flagship_kernel_ms_before_redesign": PRIOR_MS,
          "origin": "constant from PERF.md (the WMMA kernel, eager CUDA-event "
                    "time, H100 80GB HBM3, 700 W); not measured in this run"})

    # ------------------------------------------- main path: phases 4 to 6
    fa.launches = 0

    # 4. scoring at full width through the flash kernel
    model = TransformerLM(**FLAGSHIP, seed=0, device="cuda", dtype=bf16)
    model.evaluate()
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, FLAGSHIP["vocab_size"], (4, 2048), device="cuda",
                        generator=g)
    with torch.inference_mode():
        before = fa.launches
        logits = model(ids)
        torch.cuda.synchronize()
        assert fa.launches - before == model.num_layers, fa.launches
        assert logits.shape == (4, 2048, FLAGSHIP["vocab_size"])
        assert torch.isfinite(logits).all()
        n_fwd = 3
        before = fa.launches
        fwd_ms = time_ms(torch, lambda: model(ids), warmup=0, iters=n_fwd)
        assert fa.launches - before == n_fwd * model.num_layers
        for blk in model.blocks():
            blk.attn.use_flash = False
        dense = model(ids)
        for blk in model.blocks():
            blk.attn.use_flash = True
    score_rel = rel_diff(logits, dense)
    agree = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
    emit({"phase": "scoring", "batch": 4, "seq": 2048, "dtype": "bfloat16",
          "forward_ms": fwd_ms, "tokens_per_s": 4 * 2048 / fwd_ms * 1e3,
          "launches_per_forward": model.num_layers,
          "flash_vs_dense_max_rel": score_rel, "rtol": LOGIT_RTOL,
          "argmax_agreement": agree})
    assert score_rel <= LOGIT_RTOL, score_rel
    del logits, dense

    # 5. greedy generate, checked by teacher forcing
    prompts = torch.randint(0, FLAGSHIP["vocab_size"], (8, 256),
                            device="cuda", generator=g)
    n_new = 64
    model.generate(prompts[:, :32], 4)           # warm-up
    torch.cuda.synchronize()
    first = []

    def on_token(_):
        if not first:
            torch.cuda.synchronize()
            first.append(time.monotonic())

    t0 = time.monotonic()
    out, seen = model.generate(prompts, n_new, on_token=on_token,
                               host_loop=True, return_logits=True)
    torch.cuda.synchronize()
    t_end = time.monotonic()
    assert out.shape == (8, 256 + n_new)
    assert torch.equal(out[:, :256], prompts)
    with torch.inference_mode():
        tf = model(out)[:, 255:255 + n_new]
    gen_rel = rel_diff(seen, tf)
    tf_agree = (tf.argmax(-1) == out[:, 256:]).float().mean().item()
    prefill_s, decode_s = first[0] - t0, t_end - first[0]
    emit({"phase": "generate", "prompts": 8, "prompt_len": 256,
          "new_tokens": n_new, "dtype": "bfloat16",
          "prefill_tokens_per_s": 8 * 256 / prefill_s,
          "decode_tokens_per_s": 8 * (n_new - 1) / decode_s,
          "teacher_forced_max_rel": gen_rel, "rtol": LOGIT_RTOL,
          "teacher_forced_argmax_agreement": tf_agree})
    assert gen_rel <= LOGIT_RTOL, gen_rel
    del model, seen, tf

    # 6. server: concurrent mixed-length requests, f32 with TF32 off
    model32 = TransformerLM(**FLAGSHIP, seed=0, device="cuda", dtype=f32)
    model32.evaluate()
    lengths, news = SERVER_LENGTHS, SERVER_NEWS
    reqs = [prompts[i, :n].cpu().numpy() for i, n in enumerate(lengths)]
    svc = GenerationService(model32, max_batch=8, batch_timeout_ms=500.0,
                            bucket_tokens=32, prompt_bucket=64)
    answers = [None] * len(reqs)

    def ask(i):
        answers[i] = svc.generate(reqs[i], news[i])

    threads = [threading.Thread(target=ask, args=(i,), daemon=True)
               for i in range(len(reqs))]
    t_srv = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    srv_s = time.monotonic() - t_srv
    near_ties = []
    for i, (p, n) in enumerate(zip(reqs, news)):
        ans = answers[i]
        assert ans is not None and ans.shape == (len(p) + n,), i
        tie = lone_mismatch(model32, p, n, ans)
        if tie is not None:
            near_ties.append({"request": i, **tie})
    stats = svc.stats()
    emit({"phase": "server", "requests": len(reqs), "prompt_lengths": lengths,
          "new_tokens": news, "dtype": "float32", "seconds": srv_s,
          "stats": stats, "rows_equal_lone_generate":
          len(reqs) - len(near_ties), "near_ties": near_ties})
    serving_launches = fa.launches
    assert serving_launches > 0, \
        "the serving path never launched the flash kernel"
    del svc

    # -------------------------------- the continuous-batching engine
    # (its chunked prefill and decode use the masked dense attention, as
    # in the JAX package: no flash launch, which each phase checks)
    model16 = TransformerLM(**FLAGSHIP, seed=0, device="cuda", dtype=bf16)
    model16.evaluate()
    engine_reqs = list(zip(reqs, news))
    engine_launches = (
        engine_gate(torch, fa, smi, model32, engine_reqs)
        + engine_serving(torch, fa, smi, model16)
        + engine_prefix(torch, fa, smi, model32)
        # paged KV and speculative decoding
        + paged_gate(torch, fa, smi, model32, engine_reqs)
        + spec_gate(torch, fa, smi, model32, engine_reqs)
        + paged_serving(torch, fa, smi, model16)
        + spec_serving(torch, fa, smi, model16)
        # int8 KV and weights, and the prefix host tier
        + quant_gate(torch, fa, smi, model32)
        + quant_serving(torch, fa, smi, model16)
        + tier_serving(torch, fa, smi, model16)
        # QoS: preemption, shedding, rate limits, chaos, the ledger
        + qos_gate(torch, fa, smi, model32)
        + qos_serving(torch, fa, smi, model16))
    # observability: every hook of the engine, the routes, the overhead,
    # the prediction family and the train family (slice 15)
    obs_launches = obs_serving(torch, fa, smi, model16)
    # the serving fleet: spawned workers behind the front door, the
    # affinity against round-robin storm, the walkthrough (slice 16)
    fleet_launches = (fleet_gate(torch, fa, smi, model32, engine_reqs)
                      + fleet_serving(torch, fa, smi, model16)
                      + serve_example(torch, fa, smi))
    # the int8 clone's scoring forward goes through the flash kernel
    quant_launches = quant_scoring(torch, fa, smi, model16)
    # beam search (no flash launch), the prediction service and the
    # non-causal forward (the kernel with causal=False in a model)
    beam_launches = beam_serving(torch, fa, smi, model16, prompts)
    predict_launches = predict_serving(torch, fa, smi, model16)
    noncausal_launches = noncausal_scoring(torch, fa, smi)
    del model32, model16
    _LONE.clear()
    _WINDOWS.clear()

    # ---------------------------------------- 7. and 8.: the train path
    bwd = flash_backward_phase(torch, fa, smi)
    train_launches = train_phase(torch, fa, smi)
    checkpoint_launches = checkpoint_train(torch, fa, smi)
    optim_criterion_gate(torch, smi)

    # ---------------------------------------------------- the vision path
    gate_model = vision_gate(torch, smi)
    vision_train(torch, smi)
    vision_eval(torch, smi, gate_model)
    del gate_model
    local_optimizer_phase(torch, smi)

    # ------------------------------------------- the image zoo (slice 10)
    zoo_launches = zoo_gate(torch, fa, smi)
    zoo_ips = zoo_train(torch, fa, smi)
    zoo_launches += fa.launches
    zoo_launches += zoo_mains(torch, fa, smi)
    zoo_launches += input_pipeline(torch, fa, smi, zoo_ips["inception_v1"])

    # --------------------- the perf CLI and the layer variants (slice 11)
    perf_cli_launches = perf_cli(torch, fa, smi)
    variants_launches = variants_gate(torch, fa, smi)

    # ----- the table and shape layers and the text path (slice 12)
    table_launches = table_gate(torch, fa, smi)
    text_launches = text_train(torch, fa, smi) + text_lm(torch, fa, smi)

    # -------- data- and sequence-parallel training (slice 13)
    (distri_launches, ring_one_launches, main_launches,
     tp_one_launches) = world_of_one(torch, fa, smi)
    distri_launches += main_launches
    ring_launches = ring_one_launches + ring_gate(torch, fa, smi)
    longcontext_launches = longcontext_train(torch, fa, smi)

    # ------------------------ tensor-parallel serving (slice 14)
    tp_launches = tp_one_launches + tp_phases(torch, fa, smi)

    # -- the graph container and the recurrent family (slice 17)
    t_seq = time.monotonic()
    sequence_launches = (sequence_gate(torch, fa, smi)
                         + graph_train(torch, fa, smi)
                         + rnn_train(torch, fa, smi)
                         + tree_train(torch, fa, smi))
    emit({"phase": "slice17_phases", "nvidia_smi": smi,
          "seconds": time.monotonic() - t_seq,
          "flash_launches": sequence_launches})

    # -------- the sparse stack and the detection heads (slice 18)
    t_sd = time.monotonic()
    sparse_detection_launches = (sparse_gate(torch, fa, smi)
                                 + sparse_train(torch, fa, smi)
                                 + detection_infer(torch, fa, smi))
    emit({"phase": "slice18_phases", "nvidia_smi": smi,
          "seconds": time.monotonic() - t_sd,
          "flash_launches": sparse_detection_launches})

    # ---- the TF op set, its control flow and wide-and-deep (slice 19)
    t_ow = time.monotonic()
    ops_widedeep_launches = (ops_gate(torch, fa, smi)
                             + control_flow(torch, fa, smi)
                             + widedeep_train(torch, fa, smi))
    emit({"phase": "slice19_phases", "nvidia_smi": smi,
          "seconds": time.monotonic() - t_ow,
          "flash_launches": ops_widedeep_launches})

    # ------------- the serializer and model interop (slice 20)
    t_si = time.monotonic()
    serialize_launches = (serialize_gate(torch, fa, smi)
                          + interop_gate(torch, fa, smi)
                          + imageclass_predict(torch, fa, smi))
    emit({"phase": "slice20_phases", "nvidia_smi": smi,
          "seconds": time.monotonic() - t_si,
          "flash_launches": serialize_launches})

    # --------------- TF import and the keras API, profiler hosting (slice 21)
    t_tk = time.monotonic()
    tf_keras_launches = (tf_import_gate(torch, fa, smi)
                         + tf_predict_main(torch, fa, smi)
                         + tf_session_train(torch, fa, smi)
                         + keras_train(torch, fa, smi)
                         + profiler_hosting(torch, fa, smi))
    emit({"phase": "slice21_phases", "nvidia_smi": smi,
          "seconds": time.monotonic() - t_tk,
          "flash_launches": tf_keras_launches})

    # ------ dlframes, object-store paths, the sharded caches, the TP
    # leftovers and the convergence cases (slice 22; the last four ran
    # inside the --tp-rank launch, timed there)
    t_lm = time.monotonic()
    last_launches = (dlframes_train(torch, fa, smi)
                     + bucket_io(torch, fa, smi)
                     + _slice22_lines(smi, _TP_RANKS))
    in_ranks = sum(_TP_RANKS[0]["slice22"][n]["seconds"]
                   for n in _TP_RANKS[0]["slice22"])
    emit({"phase": "slice22_phases", "nvidia_smi": smi,
          "seconds": time.monotonic() - t_lm + in_ranks,
          "seconds_in_tp_ranks": in_ranks,
          "flash_launches": last_launches})

    # ----------------------------------------------------- 9. kernels line
    print(nvidia_smi(), flush=True)
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "bigdl_tpu/ops/flash_attention.py:116",
        "tpu_kernel": "bigdl_tpu/ops/flash_attention.py::_flash_kernel",
        "launches": (serving_launches + engine_launches + train_launches
                     + quant_launches + beam_launches + predict_launches
                     + noncausal_launches + checkpoint_launches
                     + zoo_launches + perf_cli_launches
                     + variants_launches + table_launches
                     + text_launches + distri_launches + ring_launches
                     + longcontext_launches + tp_launches + obs_launches
                     + sequence_launches + sparse_detection_launches
                     + ops_widedeep_launches + serialize_launches
                     + tf_keras_launches + last_launches),
        "launches_serving": serving_launches,
        "launches_train": train_launches,
        "launches_engine": engine_launches,
        "launches_quant": quant_launches,
        "launches_beam": beam_launches,
        "launches_predict": predict_launches,
        "launches_noncausal": noncausal_launches,
        "launches_checkpoint_train": checkpoint_launches,
        "launches_zoo": zoo_launches,
        "launches_perf_cli": perf_cli_launches,
        "launches_variants": variants_launches,
        "launches_table": table_launches,
        "launches_text": text_launches,
        "launches_distri": distri_launches,
        "launches_ring": ring_launches,
        "launches_longcontext": longcontext_launches,
        "launches_tp": tp_launches,
        "launches_obs": obs_launches,
        "launches_fleet": fleet_launches,
        "launches_sequence": sequence_launches,
        "launches_sparse_detection": sparse_detection_launches,
        "launches_ops_widedeep": ops_widedeep_launches,
        "launches_serialize": serialize_launches,
        "launches_tf_keras": tf_keras_launches,
        "launches_slice22": last_launches,
        "tp_local_heads": {k: tp_local[k] for k in (
            "shape", "max_abs_err", "kernel_ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_device_ms")},
        "max_abs_err": flagship["max_abs_err"],
        "ms": flagship["kernel_ms"], "kernel_ms": flagship["kernel_ms"],
        "device_ms": flagship["device_ms"],
        "plain_ms": flagship["plain_ms"], "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": flagship["library_ms"],
        "library_device_ms": flagship["library_device_ms"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "bigdl_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "bigdl_tpu/ops/flash_attention.py::_flash_bwd",
        "replaces_note": "XLA in the JAX package (a lax.scan over kv "
                         "blocks): the custom VJP of the pallas_call at "
                         "bigdl_tpu/ops/flash_attention.py:116, not a "
                         "Pallas kernel",
        "kernels": list(BWD_KERNEL_NAMES),
        "launches": sum(BWD_LAUNCHES.values()),
        "launches_by_phase": dict(BWD_LAUNCHES),
        "shape": bwd["shape"], "dtype": bwd["dtype"],
        "inputs": bwd["inputs"],
        "max_abs_err": max(bwd["vs_plain_backward_max_abs_err"].values()),
        "max_abs_err_of": "dq, dk, dv against the plain backward on the "
                          "same saved tensors",
        "ms": bwd["backward_ms"], "kernel_ms": bwd["backward_ms"],
        "device_ms": bwd["backward_device_ms"],
        "plain_ms": bwd["plain_backward_ms"],
        "plain_device_ms": bwd["plain_backward_device_ms"],
        "bound_ms": bwd["backward_bound_ms"],
        "bound_by": bwd["backward_bound_by"],
        "library_ms": bwd["sdpa_backward_ms"],
        "library_device_ms": bwd["sdpa_backward_device_ms"],
        "ptxas": bwd["ptxas"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(ring_rank() if sys.argv[1:] == ["--ring-rank"]
             else tp_rank() if sys.argv[1:] == ["--tp-rank"]
             else tp_rank(True) if sys.argv[1:] == ["--tp-rank", "slice22"]
             else main())
