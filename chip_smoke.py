#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):

1. device: the card's name, count and power limit;
2. build: every kernel of the port built from ``mxnet_tpu_torch/csrc``
   (one nvcc per source, in parallel), with nvcc's ``-Xptxas -v`` report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it, timed beside the plain version, the
   PyTorch library call that computes the same function, and the least
   time the card could take;
   The backward kernels (dQ, dK/dV) are held against the plain backward
   at the training shape (b=32, h=12, s=128, d=64), the serving shape
   (b=8, h=12, s=512, d=64) and d=128, in fp32 and bf16, with no mask, a
   key-padding mask with a dead row, and causal; and the autograd
   Function's gradients against autograd through the plain forward.
   The fp32 attention bounds are at the 3xTF32 rate (the CUDA-core bound
   printed beside); the share of key tiles the forward and dQ kernels
   visit and of 64-key blocks the dK/dV kernel visits (held to a model
   of its rule), their wrappers' host time per call, the SASS opcode mix
   of their kernels and SDPA's kernels (its backend, read by
   torch.profiler in a process of its own) are printed, and at the
   training shape dK/dV against 8/14 of SDPA's backward and dQ + dK/dV
   against all of it, in the same call (printed, not gated); and the
   forward, dQ and dK/dV kernels at Transformer-big's bucket-64 shape
   (b=64, h=16, s=64, d=64, fp32), causal with no mask and key-padded, each
   against the plain version and timed beside it, SDPA and the bound;
4. serve: BERT-base (12 layers, 768 units, 12 heads of 64, vocab 30522,
   random weights from a seed) behind ``serve.ModelServer``, 32 requests
   from 4 client threads, each of the 9 buckets a captured CUDA graph
   (captured at ``start()``, one replay a batch); the kernels' launch
   counts, the graphs captured and the replays are read around this run,
   every response must equal the eager forward of its padded batch bit
   for bit, and 3 responses are compared with the same weights on the
   CPU; each bucket's forward is timed eager and replayed; then
   ``load_parameters`` puts other weights into the served block while the
   server runs, and the next 4 responses must equal the eager forward
   with them, with no new capture;
5. train: BERT-base with MLM+NSP heads (dropout 0.1) takes 20 AdamW steps
   through ``autograd.record``, ``backward`` and ``gluon.Trainer`` at
   batch 32, sequence 128, fp32; the launch counts are read around the
   20 steps; every trainable parameter must have a finite gradient after
   the first backward and the loss must fall; then 2 steps at batch 4
   with dropout 0 on the card and on the CPU from the same weights must
   agree;
6. ResNet kernels: the BatchNorm-statistics kernel and the three fused
   1x1-convolution kernels against their plain versions at every shape
   ResNet-50 gives them (batch 128 at 224^2 in training, 64 in predict
   mode), in fp32 and bf16, with and without ReLU, timed beside the plain
   version, a library yardstick (``torch.var_mean``; ``torch.matmul`` at
   the same shape, the product alone) and the least time; the
   BN-statistics kernel also by its device time from torch.profiler and
   its wrapper's host time a call, at all four stage shapes; at each bf16
   training shape the fused kernels' TMA route and simple route are held
   against each other and timed side by side (also by their device time
   from torch.profiler), and the fused forward of one step is summed from
   them; fp32 ``bn_act_matmul`` (the predict forward's) runs on its TF32
   route, bound at the 3xTF32 rate (the CUDA-core bound beside), held
   against the simple route and timed beside it and ``torch.matmul`` at
   all four predict shapes, summed over one forward's 16 launches; and
   their autograd Functions against autograd through the plain forwards;
7. ResNet training: ResNet-50 v1, NHWC, 1000 classes, with
   ``MXTPU_CONV_EPILOGUE=pallas``, takes 20 steps through
   ``parallel.DataParallelTrainer`` (SGD, lr 0.1, momentum 0.9, wd 1e-4,
   bf16 compute, fp32 masters) at batch 128, 224^2, on one synthetic
   batch; the launch counts are read around the 20 steps, every fused
   launch must have taken the TMA route and every BN-statistics launch
   the 16-byte loads (none its scalar route); the losses after the first two
   updates must be below the first, every trainable parameter change and
   stay finite, the moving statistics move; then the first 4 steps again
   from the same weights with the fused kernels pinned to the simple
   route (PR 3's template), whose losses the TMA run's must track;
8. ResNet predict: the trained net in predict mode at batch 64, fp32,
   timed eager (not hybridized) and then as replays of its captured
   forward; the launches of ``bn_act_matmul`` are read around the timed
   replays, and every one must have taken the TF32 route;
9. ResNet references, fp32 with TF32 off, batch 8 at 112^2: 2 steps of the
   fused net on the card, the same on the CPU, and the standard (unfused)
   net on the card, from the same weights, must agree; the fused net on
   the card with its input moved by one ulp gives the floor of those gaps;
10. RNN kernels: the LSTM and GRU forward and backward kernels against
    their plain versions (every forward output and every gradient) at
    DeepAR training (T=96, N=32, H=40), DeepAR predict (T=73 and 96,
    N=1600; T=96, N=3200), the GRU phase (T=35, N=32, H=200) and a
    large-H LSTM (T=35, N=32, H=512), in fp32 and bf16, each kernel run
    twice for bit-identity; timed beside the plain versions, the bound,
    and cuDNN's layer (``torch.nn.LSTM``/``GRU``, fp32) against the port's
    layer (input GEMM plus kernel), forward and backward; the LSTM forward
    and the GRU backward on every route that takes the shape (register,
    tensor-core, cluster, split), each held against the plain version;
    at the main paths' shapes (DeepAR training and predict, the GRU
    phase; fp32) the planned route timed beside the split route and by
    torch.profiler's device time; the redesigned routes' kernels must
    show 0 spill bytes in nvcc's report; the wrappers' host time a call
    at the main shapes; and the autograd Functions against autograd
    through the plain forwards;
11. DeepAR train: ``deepar(40, 2)`` (GluonTS defaults: 2x40 LSTM,
    Student-t head, dropout 0.1), Xavier, 20 Adam steps (lr 1e-3) at
    batch 32, context 72 + prediction 24, on fresh covariate batches from
    ``data.timeseries.InstanceSplitter`` over ``synthetic_dataset``; the
    launch counts are read around the 20 steps, every ``lstm_fwd`` on
    the register route; every parameter must have a finite gradient after
    the first backward and the mean NLL of the last 5 steps must be below
    the first;
12. DeepAR predict: 16 context series of 72 points, 100 samples each
    (N=1600), 24 sampling steps; then 32 series (GluonTS's default predict
    batch: N=3200, past the JAX package's size rule for its kernel); the
    launches are read around each, every one on the tensor-core route;
13. DeepAR card vs CPU: the same weights, dropout 0, fp32, batch 4: the
    first NLL, ``lstm.l0_h2h_weight``'s gradient, 2 Adam steps' losses,
    the first predict step's (mu, sigma, nu) (``DeepARNetwork.next_params``,
    which ``predict`` calls) and ``predict``'s paths must agree;
14. GRU: ``gluon.rnn.GRU(200, num_layers=2)``, TNC, T=35, N=32, input 200
    (MXNet 1.x's word-language-model example with ``--model gru``), 20
    Adam steps on an L2 loss against a fixed target; the launch counts
    are read around the 20 steps, every ``gru_bwd`` on the cluster route,
    and the loss must fall;
15. captured steps, after every profiled phase (a CUDA-graph capture
    before the ResNet phase zeroed its profiler readings): each training
    path again from the same weights and batches as its eager phase
    above, 20 steps through ``Trainer(whole_step=True).whole_step`` (BERT,
    DeepAR, the GRU) or ``DataParallelTrainer.step`` (ResNet; its eager
    phases above pass ``capture=False``), then for ResNet one
    ``step_many`` over 4 stacked batches.  Each prints its step median
    over steps 3-20 beside the eager phase's, and must show one graph
    captured, one replay a step after the warm-up, no
    ``whole_step_fallbacks``, the eager step's launches (by kernel and
    route) at every step, no plain call on CUDA, and the first 4 losses
    and the parameters after them bit-identical to the eager phase's;
16. checkpoints, from phase 15's weights and batches: (a) BERT-base
    MLM+NSP (AdamW, dropout 0.1): 6 captured steps (the reference); 3
    steps, ``CheckpointManager.save`` without ``sync``, steps 4-6 while it
    drains; then a net and trainer with other weights restore it and take
    steps 4-6, captured and eager: every run's steps 4-6 (losses,
    parameters, launches) bit-identical to the reference's and the
    restored weights to the reference's after step 3; (b) ResNet-50 (bf16,
    ``DataParallelTrainer`` captured): 3 steps, ``save_states(async_save=
    True)``, 3 more; a fresh, built trainer loads it and its 3 steps equal
    steps 4-6 bit for bit; then ``save_parameters``/``load_parameters``
    into a fresh ResNet-50, whose b=64 fp32 predict forward must equal the
    source block's.  Each prints the bytes written, how long ``save()``
    held the training thread, the time to commit, the restore time and
    the step median with a save in flight beside one without.

17. Transformer-big training: ``transformer_big(32000, 32000)``
    (6+6 layers, 1024 units, 16 heads of 64, FFN 4096, dropout 0.3),
    Xavier, behind the example's teacher-forcing wrapper and
    label-smoothed loss (examples/nmt/train_transformer.py, copied), 20
    ``DataParallelTrainer`` steps (Adam lr 3e-4, beta2 0.98, fp32) at
    batch 64 on the port's ``NMTBucketIter`` batches (buckets 16, 32, 64;
    a Zipf-distributed copy task from numpy seed 0), eager, then the same
    20 from the same weights captured: the losses finite and the last 5's
    mean below the first, 18 launches of each flash kernel every step, no
    plain call, one graph a bucket and a replay a step after its warm-up,
    the first 4 losses and the parameters after them bit-identical to the
    eager run's, the positional constant unchanged; then the starting
    weights with dropout 0, batch 2 at bucket 16, 2 Adam steps through
    ``gluon.Trainer`` on the card and on the CPU: the first loss,
    ``dec_layers.0.cross_in_weight``'s gradient and both losses must
    agree; per-bucket step medians in tokens/s are printed;
18. Transformer-big decoding: the trained model, hybridized, in predict
    mode, decodes 8 bucket-32 sources with ``greedy_decode`` and
    ``beam_search_decode`` (beam 4, alpha 0.6), up to 32 tokens, three
    times (the eager warm-up, the captures, the replays): bit-identical
    sequences and scores, a graph a prefix signature, beam 1 equal to
    greedy, 18 forward launches a decode step, no plain call; the CPU fed
    the card's greedy sequences must give each step's logits within
    ``CPU_ATOL`` and the card's token where its top-2 margin exceeds
    ``TFM_MARGIN``; the time a step and a sentence, eager and replayed;
18b. the cells: two stacked ``LSTMCell(200)`` and two ``GRUCell(200)``
    (``HybridSequentialRNNCell``), given the weights of
    ``gluon.rnn.LSTM``/``GRU(200, num_layers=2)``, unrolled over T=35,
    N=32 TNC, must give the fused layers' outputs (the recurrence kernels,
    rows 11 and 13) within ``CELL_RTOL``;
19. the kvstore on the card: ``KVStore('device')`` and ``('nccl')`` on
    CUDA tensors (5 values a key, on the cards there are) against the same
    calls on CPU copies (``cpu(0..4)``), bit for bit: push and pull,
    pushpull, broadcast, 2-bit compression and ``set_optimizer`` (SGD with
    momentum and Adam, 3 pushes each); then the fused multi-key pushpull
    of every BERT-base gradient (two values a key), its buckets and
    dispatches, timed;
20. BERT-base under ``dist_sync``: 2 ranks that the port's launcher starts
    (``python -m mxnet_tpu_torch.tools.launch``, each running this script
    with ``--bert-ranks-worker DIR``, which runs phases 20, 23 and 24 in
    turn in one process group), rank r on ``gpu(r)`` with 2 or more cards
    (NCCL), both on ``gpu(0)`` with one (gloo), train BERT-base MLM+NSP
    (fp32, dropout 0, Adam) on their halves of a 16 x 128 batch for 6
    steps through ``Trainer(kvstore='dist_sync')``: the backend the rule
    names, both ranks' parameters bit-identical after every step, every
    trainable parameter finite and changed, 12 launches of each flash
    kernel a rank a step, no plain call, and the losses within
    ``DIST_LOSS_RTOL`` of one process training the same two halves on
    gpu(0); the all-reduce time and bytes a step;
20b. ``kvstore='device'`` over gpu(0) and gpu(1), where 2 cards are
    visible: the same steps with a forward a card, within the same limit
    of one card, the replicas bit-identical; on one card it says so and
    does not run;
21. ResNet-50 over a mesh: 2 ranks that the port's launcher starts (each
    running this script with ``--mesh-worker DIR resnet,bert``: phases 21
    and 22 in turn, one launch), both on gpu(0)
    (gloo), train fused ResNet-50 v1 NHWC (bf16 compute, fp32 masters, SGD
    lr 0.1 momentum 0.9) through ``DataParallelTrainer`` over
    ``make_mesh()`` = ``{dp:2}`` for 6 steps at phase 7's global batch
    (128 x 224^2, 64 a rank): the backend the rule names, both ranks'
    masters and moving statistics bit-identical after every step, every
    trainable parameter finite and changed, every moving statistic moved,
    a rank's launches a step those of the one-process step (20, 16, 16 of
    rows 8, 7, 10, all on the TMA route), the 106 BatchNorm all-reduces a
    step, and the steps eager by rule; then the cross-replica check, fp32
    at b=16, 112^2, 2 steps, against one process over the same images and
    weights on gpu(0) at phase 9's limits, with the moving statistics
    after step 1 within 1e-4; the all-reduce time and bytes a step, the
    statistics' all-reduces and the step median are printed;
21b. the same over gpu(0) and gpu(1) with NCCL where 2 cards are visible;
    on one card it says so and does not run;
22. BERT-base MLM+NSP (a loss a row, fp32, dropout 0, AdamW) through
    ``DataParallelTrainer`` on 2 ranks for 3 steps at a global batch of
    16 x 128: ``{dp:2}``; ``{dp:2}`` with ``shard_opt_states`` and
    ``remat``, whose losses and gathered masters must be bit-identical to
    the first's, with Adam states half of the unsharded and 24 forward
    launches a rank a step; ``{tp:2}`` with ``shard_params``, each sharded
    parameter half its size at rest; the ZeRO and tp runs' losses within
    1e-4 of one process over the global batch on gpu(0);
23. the Trainer's ZeRO over ``dist_sync`` ranks: phase 20's 2 ranks
    (after phase 20, in the same launch; both on
    gpu(0) under gloo with one card, rank r on gpu(r) under NCCL with 2+)
    train BERT-base MLM+NSP (fp32, dropout 0, Adam) from phase 20's
    weights on phase 20's halves through ``Trainer(kvstore='dist_sync',
    update_on_kvstore=False, whole_step=True)``, ``ZERO_STEPS`` steps
    unsharded and then as many with ``zero_shard=True`` (the eager world
    step, ``gluon.whole_step.WorldStep``); the sharded run saves through
    ``CheckpointManager`` after ``ZERO_SAVE_AT`` steps (a 2-process
    manifest, each rank's half of the Adam states in its own file), and
    this process restores it on gpu(0) into an unsharded one-process
    Trainer and takes the remaining steps.  Gates: the backend the rule
    names; both ranks bit-identical after every step; under gloo the
    sharded weights bit-identical to the unsharded after every step;
    ``zero_steps`` equal to the steps and no fallback; a rank's optimizer
    state at most half the unsharded plus one chunk's pad; 12 launches of
    each flash kernel a rank a step and no plain call; the losses within
    ``DIST_LOSS_RTOL`` of phase 20's one-process reference, and the
    resumed steps within it of the uninterrupted sharded run.  The step
    times, the collectives' times and GB/s, the state bytes a rank and
    the save and restore seconds are printed.
24. the Trainer on a mesh: phase 20's 2 ranks (after phase 23, in the
    same launch; both on gpu(0) under gloo with
    one card, rank r on gpu(r) under NCCL with 2+) train BERT-base MLM+NSP
    (fp32, dropout 0, Adam) from phase 20's weights on phase 20's global
    batch, whose loss is taken a half of the batch at a time (phase 20's
    objective however the rows are split), through
    ``Trainer(..., whole_step=True, mesh_shape="mp=2")`` for
    ``SPMD_STEPS`` steps (every Dense and attention projection computed on
    its half of the weight, saved through ``CheckpointManager`` after
    ``SPMD_SAVE_AT`` steps) and then from the same start through
    ``mesh_shape="dp=2", zero_shard=True``; this process restores the
    save on gpu(0) without a mesh and steps once.  Gates: the backend the
    rule names; both ranks' losses and gathered weights bit-identical
    after every step; the losses within ``MESH_LOSS_RTOL`` of phase 20's
    one-process reference; under mp=2 a rank's parameters at rest and
    Adam states at most ``SPMD_SHARE`` of the full ones, 52 products a
    forward on a shard, no split weight gathered, and the parameter
    all-gathers of a step exactly the bytes of the gathered parameters;
    under dp=2 with ZeRO a rank's Adam states at most ``SPMD_SHARE`` of
    the full ones; every step an spmd step and none a fallback; 12
    launches of each flash kernel a rank a step and no plain call; the
    restored step within ``MESH_LOSS_RTOL`` of the uninterrupted one.  The
    step times, the collectives by kind (ms, GB/s), the bytes a rank at
    rest, the peak memory a rank (phase 22 prints it beside its
    ``{tp:2}`` figure) and the save and restore seconds are printed.

25. the ``pp`` and ``sp`` axes: phase 20's 2 ranks (after phase 24, in
    the same launch; gloo on one card, NCCL with 2+) train the pipeline LM (``parallel.pipeline_lm``) at GPT-2
    small's widths (vocabulary 50257, context 1024, 12 layers of 768, 12
    heads of 64, FFN 3072; pre-LN blocks, untied head; fp32, TF32 off) from
    ``init_pipeline_lm``'s draws rescaled to GPT-2's published init
    (``gpt2_scale``) on one batch of 8 x 1024 (targets the tokens rolled
    by one) in 4 micro-batches: over ``{pp:2}`` the first step's
    loss and gradients, then ``PP_STEPS`` Adam steps at lr 3e-4; over
    ``{sp:2}`` (Ulysses in every block) ``PP_SP_STEPS`` steps; the ring
    shift and the all-to-all at the path's shapes on CUDA tensors against
    the same calls on CPU tensors; ring and Ulysses attention at b=1, h=12,
    s=4096, d=64, causal.  This process runs ``reference_lm_loss`` on
    gpu(0) from the same weights, and prints what fp32 rounding alone does
    to it from the JAX package's own init scales (the whole batch against
    its micro-batches).  Gates: the backend the rule names; the
    collectives bit-identical to CPU tensors; ``{pp:2}``: losses finite and
    the last below the first, the first within ``PP_LOSS_RTOL`` of the
    reference, the gradients of ``embed.tok``, layer 0's ``wqkv`` and
    ``head.w`` within ``PP_GRAD_TOL`` of their largest value, every
    parameter finite and changed, 24 launches of each flash kernel a rank
    a step; ``{sp:2}``: the first loss within ``PP_LOSS_RTOL``, both ranks
    bit-identical after every step, 48 launches of each flash kernel a rank
    a step; no plain call; the attention entries within ``PP_ATTN_TOL`` of
    ``sdpa_reference``.  The step medians, the collectives' bytes and
    times and the peak memory a rank are printed.  Phase 3 also holds the
    flash kernels against their plain versions at this path's causal
    micro-batch (b=2, h=12, s=1024, d=64) and times them there.
26. the input tier, in a ``data-smoke-*`` directory of the
    checkout that is removed after.  (a) LeNet on MNIST as
    examples/image-classification/train_mnist.py trains it: MNIST-format
    idx files of 60,000 training and 10,000 test rows (28x28 uint8, the
    example's separable digits from seed 0), read through
    ``gluon.data.vision.MNIST`` with ``ToTensor`` and a
    ``DataLoader(batch_size=128, num_workers=4)`` over a shuffle of the
    first ``LENET_ROWS`` (10,000) rows; ``lenet()`` hybridized,
    Xavier, ``gluon.Trainer('sgd', lr 0.05, momentum 0.9)`` and
    ``metric.Accuracy`` for that sixth of an epoch; validation through
    ``mx.io.MNISTIter`` over the test files.  Gates: validation accuracy
    at least ``LENET_MIN_ACC``; the first 5 steps' losses within
    ``LENET_LOSS_RTOL`` of the same steps run by the port on the CPU from
    the same weights and batches.  (b) ResNet-50 v1 NHWC, bf16, fused,
    through phase 15's captured ``DataParallelTrainer`` step at b=128,
    224^2, fed by ``DataLoader(ArrayDataset(1,280 uint8 images), shuffle,
    num_workers=4).as_pipeline()`` with ``RandomFlipLeftRight``,
    ``ToTensor`` and ImageNet's ``Normalize``, a map to NHWC and
    ``prefetch_to_device(gpu(0), depth=2)`` for one epoch (10 steps),
    saved after step 5 by ``CheckpointManager.save(pipeline=...)`` with
    the trainer's ``save_states``, and resumed into a fresh trainer and a
    fresh pipeline for steps 6-10.  Gates: every batch the consumer's
    stream reads bit-identical to the host batch the pipeline built; the
    resumed steps' losses and batches bit-identical to the uninterrupted
    run's; 20/16/16 launches of rows 8/7/10 a step on the TMA route, no
    plain call.  Printed: the pipeline-fed step median beside phase 15's
    device-resident one, the consumer's wait a step and ``h2d_ms`` a batch
    from ``pipeline_stats()``, the host build time of one batch.
27. the image and text tiers, in a ``data-smoke-*`` directory of the
    checkout that is removed after.  (a) ResNet-50 from JPEG records as
    examples/image-classification/train_imagenet.py trains it: an indexed
    ``.rec`` of 768 JPEG records (128 distinct 500x375 RGB images from seed
    0, smooth sinusoids plus 20 levels of noise, quality 95, each under 6
    ids, labels in [0, 1000)) read by ``mx.io.ImageRecordIter`` with the
    example's recipe (b=128, 224^2, shuffle, mirror, random-resized crops,
    brightness/contrast/saturation 0.4, ImageNet mean and std, 8 threads),
    each batch to NHWC and through phase 15's captured ``DataParallelTrainer``
    step (SGD, bf16) for one pass of 6 steps.  Gates: the lane is
    ``native`` exactly when ``utils.native.load()`` returns a library, and
    ``use_native=True`` raises where it returns None; every batch the card
    received bit-identical to the batch a second iterator on the same file
    and seed yields on ``cpu()``; finite losses, every trainable parameter
    finite and changed; 20/16/16 launches of rows 8/7/10 a step on the TMA
    route, no plain call.  Printed: the lane and the loader's build error,
    the host iterator alone in samples/s, the host decode time of one
    batch, the fed step median beside phase 15's and the consumer's wait a
    step.  (b) BERT-base from a corpus as examples/bert/pretrain_bert.py
    trains it: a corpus file of ``data.bert.synthetic_corpus`` (400
    documents of 8 sentences of up to 24 of 5,000 words), a WordPiece
    vocabulary built to at most 8,000 entries, ``BertPretrainPipeline(seq_len
    128, seed 0).batches(32, 20)`` through ``pipeline.IterableSource`` and
    ``prefetch_to_device(gpu(0), 2)``, into phase 15's captured whole step
    (MLM+NSP, AdamW 1e-4, dropout 0.1, the 30,522-row model).  Gates: every
    batch the consumer's stream read equal to its host dict; finite
    losses, the last below the first; one graph, no fallback; 12 launches
    of each flash kernel a step, no plain call.  Printed: the fed step
    median beside phase 15's.
28. resilience and telemetry around BERT-base training, in a
    ``res-smoke-*`` directory of the checkout that is removed after:
    phase 5's configuration (MLM+NSP, b=32, s=128, AdamW 1e-4, wd 0.01)
    with dropout 0 through the captured whole step, fed by a
    ``pipeline.Pipeline`` over ``RES_STEPS`` seeded synthetic batches
    (``prefetch_to_device``), checkpointed by ``CheckpointManager(keep_n=2)``
    every ``RES_SAVE_EVERY`` steps (``sync=True``), under
    ``resilience.Supervisor(on_preemption="resume")``, twice: clean, and
    under ``RES_PLAN`` (a kill at step 3, a truncated commit of the step-5
    save, a transient fault at step 6, two delayed h2d copies).  Armed
    throughout: ``telemetry.trace``, the flight recorder, a
    ``HealthMonitor(tick_sec=0)`` (one window a run) and a
    ``MetricsServer`` on a free loopback port.  Gates: the plan fired
    exactly its faults; the ``resilience`` section reads 2 restarts,
    retries ``{preemption: 1, transient: 1}``, 1 fallback restore and lost
    time; the chaos run's parameters and batch log bit-identical to the
    clean run's; 12 launches of each flash kernel on every executed step,
    one capture an attempt, no fallback, no plain call; the trace parses
    and holds ``whole_step`` scopes, ``checkpoint.save.*`` scopes and the
    supervisor's instants; a flight dump with reason ``sigterm``;
    ``/metrics`` (over ``urllib``) serves ``mxtpu_resilience_restarts`` and
    the ``mxtpu_health_*`` gauges, ``/healthz`` answers; the chaos
    window's goodput below 1, MFU finite and positive against the H100's
    datasheet peak; device memory after the chaos run within one
    checkpoint buffer set of the clean run's; the SIGTERM handler and the
    no-op hooks back once everything is disarmed.  Then a short
    ``ModelServer`` pass over BERT-base under the trace: one
    ``serve.request`` span a request, its gauges on ``/metrics``.
    Printed: the health window's step time (host scopes) beside the CUDA
    events' step median of the same steps, and the disarmed step median
    beside phase 15's.
29. int8 BERT-base serving: ``bert_base(vocab_size=30522)`` (MLM and NSP
    heads, Normal(0.02) from a seed) through ``contrib.quantization.
    quantize_net(calib_mode="naive")`` on ``INT8_CALIB_BATCHES``
    synthetic batches (the 24 FFN Dense layers, the pooler and the heads
    int8; the attention projections stay float32, so the flash forward
    runs), hybridized behind ``ModelServer`` over phase 4's bucket grid
    with ``INT8_SERVE_REQUESTS`` requests.  Gates: 28 int8 layers; all
    served; no signature after warm-up, one capture a bucket, one replay a
    batch; 12 flash launches a forward, no plain call; every batch booked
    in the ``quantize`` section; against the CPU's int8 path on the same
    weights and ranges, each of six quantized layers on one input a
    quantum apart at most on ``INT8_LAYER_FLIPS`` of its outputs at most,
    and the logits within ``INT8_NOISE_FACTOR`` times int8's own error
    against float32 of the CPU's; the int8 products exact (a float64
    product); then
    ``reload_weights()`` of a float32 ``CheckpointManager`` save of other
    weights, re-quantized against the stored scales with no new capture,
    and the next responses bit-identical to the eager int8 forward.
    Printed: each int8 product (``torch._int_mm`` through the padding
    rule) beside the float32 ``torch.matmul`` of its shape.
30. decode at bench.py serve_decode's device configuration: whole-batch,
    continuous, paged (``page_tokens=16``, half the contiguous arena's
    cache) with ``spec_k=4`` and ``TinyDraft``, and int8 (``proj_block``
    quantized) arms of ``DecodeServer``.  Gates: all served; no signature
    or capture after warm-up; one replay a token step, a draft proposal
    and an admission group; continuous == whole-batch and speculative ==
    greedy, token for token; every arm's tokens equal to the CPU run's of
    the same weights, but for divergences at a decision whose top two
    logits lie within ``DEC_TIE_GAP`` (one level of the calibrated output
    range in the int8 arm; named); int8 steps booked.
    Printed: tokens/s, replays, the paged arm's peak live slots.
31. the tuner: ``tune.derive_bucket_spec`` from phase 29's request
    histogram, then a ``tune.Tuner`` (seed 0, at most ``TUNE_MAX_TRIALS``
    trials) over ``decode_page_tokens`` and ``decode_spec_k`` applied
    through the environment, each trial ``TUNE_PASSES`` passes of phase
    30's traffic through a fresh paged ``DecodeServer``, scored by tokens/s
    of wall time.  Printed:
    every trial's JSONL line and the recommendation.
32. the router: (a) phase 4's replica (each built from seed 0: bit-identical
    weights) three times behind ``serve.Router(evict_after=2)`` with a
    health probe every ``ROUTER_HEALTH_SEC``; 48 requests from 4 client
    threads, the last 40 under ``ROUTER_PLAN`` (replica 1 fails every
    dispatch and probe, one probe of replica 2 stalls); a warm spare
    captures its 9 buckets while its peers serve; then 12 requests with a
    budget under ``hedge_ms``, a tenant over its quota of 2, and
    ``rolling_reload()`` under 24 requests to a ``CheckpointManager`` save
    of the same weights with the pooler's bias raised by 0.5.  Gates: every
    request served (or failed classified, naming its attempts),
    ``requests_lost == 0``; replica 1 evicted and a spare admitted (3
    healthy); one capture a bucket a server and none after warm-up; flash
    launches exactly 12 a forward (the build's, the warm-ups', the
    batches', the probes'); every replica's parameters bit-identical to
    replica 0's; every hedged request run twice and a loser cancelled; the
    tenant refused with ``TenantQuotaExceededError``; every reload-period
    response within ``CPU_ATOL`` of exactly one of two eager card forwards
    (old and new weights), no capture in the reload; 6 responses against
    the CPU; ``mxtpu_router_*`` and ``mxtpu_ctrl_*`` on ``/metrics``.  (b)
    phase 30's decode configuration, 2 ``DecodeServer`` replicas behind a
    Router, 48 of its requests through ``submit_stream``: each stream
    token for token equal to one server's.  Printed: each replica's
    warm-up, the recovery time (eviction to the spare's admission), each
    pool's requests/s.
33. the control plane: a ``ControlPlane`` of worker processes
    (``chip_smoke.py --serve-replica-worker REGISTRY ID``: phase 32's
    replica over ``CTRL_GRID``, registered after its warm-up) on the one
    card, driven by an ``Autoscaler`` (1 to 2 workers): one worker (spawned
    while phase 32 runs: a spawn is ~10 s of start-up), then
    ``CTRL_LOAD_THREADS`` closed-loop clients until the pool grows to 2 by
    a warm admission, a SIGKILL of the worker carrying the most dispatches,
    its eviction and a freshly spawned warm worker, then no load until the
    pool drains back to 1.  Gates: 4 requests through a ``RemoteReplica``
    bit-identical to an in-process replica of the same weights and grid;
    every request served, ``requests_lost == 0``, network re-dispatches;
    the corpse evicted; 3 spawns, 1 scale-up, a scale-down and a
    retirement, also in the ``mxtpu_ctrl_*`` gauges; no capture in traffic
    on any worker; each worker that stopped cleanly (all but the killed
    one) counted 12 flash launches a forward.  Printed: the time to the
    first warm worker, the scale-up, kill-to-rejoin and recovery times,
    the workers' warm-ups and launches, requests/s.
34. the symbolic API, ResNet-50 v1 (NCHW, 224^2, 1000 classes, random
    weights from a seed): the model zoo's gluon net exported
    (``HybridBlock.export``), reloaded by ``mx.model.load_checkpoint``,
    given a ``SoftmaxOutput`` and bound in ``mx.mod.Module`` on gpu(0) at
    b=32.  Gates: the Module's predict forward within 1e-5 of the gluon
    net's softmax; its first step's parameter gradients within 1e-4
    (norm) of autograd through the net; 4 SGD steps (momentum 0.9)
    through ``fit``; ``predict`` finite.  Printed: the Module step's
    median and its host issue share.
35. the LSTM language model of MXNet 1.x's cudnn_lstm_bucketing.py
    (vocabulary 10,000, embedding 200, 2 x 200 LSTM, batch 32, buckets
    10-60, Zipf tokens from a seed) built from ``mx.sym`` and trained one
    epoch (3 batches a bucket) through ``mx.mod.BucketingModule`` with
    ``Perplexity``, ``Speedometer`` and ``do_checkpoint``.  Gates: every
    bucket run; perplexity finite and falling; the LSTM kernels (rows
    11-12) launched 2 x (1 forward + 1 backward) a step, no plain call;
    the checkpoint reloaded by ``Module.load`` and scored to the trained
    module's value; one bucket's forward and gradients on the card
    against the CPU.  Printed: the step median by bucket.
36. the int8 tier on the symbolic path: ``quantize_model`` of phase 34's
    ResNet-50 (naive calibration, 2 batches of 32), bound by
    ``Symbol.bind`` on gpu(0).  Gates: top-1 agreement with float32 at
    least 0.75 over the b=32 batch; 53 quantized convolutions and 1 FC;
    54 ``int_mm`` calls a forward; a 3-D int8 convolution on the card
    equal to its CPU result.  Printed: both executors' forward medians.
37. the MoE language model of examples/moe/train_moe_lm.py (causal
    attention through the fused op, ``gluon.contrib.nn.MoEFFN`` in every
    layer) at Switch-Base-8's widths (``MOE_*``: d_model 768, 12 heads,
    FFN 3072, 8 experts, top-1, capacity 1.25, vocabulary 32128) x 12
    layers on gpu(0), batch 8 x 512, fp32 with TF32 off, 5 Adam steps
    (lr 3e-4) through ``gluon.Trainer`` on the example's synthetic
    batches.  Gates: losses and parameters finite, every parameter
    changed, 12 launches a step of each flash kernel and no plain call;
    at 2 layers, batch 2 x 128, the first step's loss and layer 0's
    router, w1 and w2 gradients on the card within 1e-4 of their largest
    value against ``cpu()``, the same for one top-2 forward, and both
    routings equal but for near ties (reported).  Printed: the step
    median, tokens/s, the peak memory, the share of tokens dropped a
    layer, and the dispatch and combine einsums against the experts'
    products in one instrumented forward (CUDA events).
38. ``{ep:2}`` (in phase 20's launch): 2 ranks train phase 37's LM at
    4 layers through ``DataParallelTrainer(param_spec_fn=
    gluon_moe_param_spec_fn(mesh))`` for 3 Adam steps.  Gates: the
    backend the rule names; both ranks' losses and replicated weights
    bit-identical every step; a rank's experts and their Adam states half
    of the whole, nothing else split; no parameter gathered; losses within
    1e-5 relative of one process on gpu(0); 4 launches a step of each
    flash kernel a rank.  Printed: the ``ep`` collectives a step.
39. ``dist_async`` (in phase 20's launch, which starts one parameter
    server, ``tools.launch -n 2 -s 1``: ``python -m
    mxnet_tpu_torch.kvstore_server``): the 2 ranks train BERT-base
    MLM+NSP (fp32, dropout 0, Adam) through ``Trainer(kvstore=
    'dist_async')``, 3 steps a rank on its half of phase 20's batch.
    Gates: the server never initialized CUDA (its log line and its memory
    map); after a final barrier both ranks pull bit-identical values;
    every parameter finite and changed; no synchronous all-reduce; the
    server exits with 0 or -15; 12 flash launches a step a rank.
    Printed: the push and pull seconds and GB/s a step.
40. the elastic resize (the same launch, last): both ranks train
    BERT-base through ``kvstore='dist_sync'`` inside
    ``Supervisor(elastic=True, manager=CheckpointManager(DIR))``, saving
    after step 2; at step 4 rank 1 leaves with ``os._exit(0)``; rank 0
    classifies the gloo error as peer death, shrinks to world 1 through
    the rendezvous in the checkpoint directory, re-forms its group,
    restores and finishes steps 3-6.  Gates: one resize to world 1, dead
    ranks [1]; rank 1's record of its exit and the launch's code 0; the
    resumed steps within ``DIST_LOSS_RTOL`` of one process on gpu(0)
    restored from the same checkpoint.  Printed: whether they came out
    bit-identical, and the seconds from the failure to the first resumed
    step by part (detection, rendezvous, re-init, restore).

41. the imperative NDArray (gpu(0), fp32, TF32 off): (a) a BERT-base
    encoder layer (768 units, 12 heads, FFN 3072, b=8 x s=512) written in
    ``mx.nd`` calls on NDArrays (``nd.multihead_attention``, ``+``,
    ``nd.LayerNorm``, ``nd.FullyConnected``, ``nd.LeakyReLU(act_type=
    'gelu')``), its weights a ``BERTEncoderLayer``'s with
    ``attach_grad()``, forward and backward under ``record()``: the output
    and every weight gradient within ``IMP_TOL`` of their largest value
    against the block's eager run, one launch each of the flash forward,
    dQ and dK/dV kernels and no plain call, every result an NDArray on
    gpu(0); (b) an MLP (4096 x 768 from numpy, 3072 hidden, 10 classes of
    a fixed random teacher; weights from ``nd.random.normal(scale=0.02)``)
    trained ``IMP_STEPS`` steps by ``w[:] = w - lr * w.grad``: the losses
    finite and the last below the first, the first ``IMP_CPU_STEPS``
    within ``IMP_CPU_RTOL`` relative of the same loop on cpu() from the
    same weights, each weight's tensor, address and variable status kept
    through every update, the accuracy a Python float; the step median is
    printed; (c) the 10 samplers of ``mx.random`` on gpu(0): reseeding
    gives the same bits, the JAX package's shapes, dtypes and contexts,
    and the moments of ``IMP_DRAWS`` draws within 6 standard errors.
42. the Gluon basics (gpu(0), fp32, TF32 off, cuDNN deterministic): (a)
    examples/ocr/train_crnn_ctc.py's CRNN (two 3x3 convolutions with
    (2, 1) max pooling, a bidirectional ``gluon.rnn.LSTM(64)``, a Dense
    head, ``gluon.loss.CTCLoss(layout="TNC")``) trained as the example
    does at its defaults: ``Xavier``, hybridized, Adam at lr 1e-2, batch
    32 of ``render_batch(RandomState(0), 32, 4)`` strips (T = 20
    columns, 11 classes), ``CRNN_STEPS`` steps, then greedy decoding of
    the held-out batch of 64 from ``RandomState(99)``.  Gates: every
    loss finite, the mean of the last 20 below a tenth of the first,
    exact-sequence accuracy at least ``CRNN_ACC``, 2 ``lstm_fwd`` and 2
    ``lstm_bwd`` launches a step, all on the register route, none on the
    split route, no plain call on CUDA.  Printed: the step median, the
    accuracy and the loss at steps 1, 100 and the last; the LSTM kernels
    at the CRNN's shape (T=20, N=32, H=64) against their plain versions,
    timed beside them, cuDNN's layer and the bound.  (b) The same weights
    on the card and on the CPU, one batch of 32, 2 Adam steps: logits
    within ``CRNN_LOGIT_TOL`` of their largest value, the first loss
    within ``CRNN_LOSS_RTOL`` relative, the gradients of both directions'
    ``h2h_weight`` and ``conv.0.weight`` within ``CRNN_GRAD_TOL`` of each
    one's largest value, both losses within ``CRNN_STEP_RTOL`` relative.
    (c) (a)'s first ``CRNN_CAPTURE_STEPS`` batches from its starting
    weights through ``Trainer(whole_step=True).whole_step``: phase 15's
    gates against (a)'s eager steps (one graph, a replay a step, no
    fallback, the eager launches, the first 4 losses and the parameters
    after them bit-identical).  (d) The ``CTCLoss`` op alone, (T, N, C)
    = (20, 32, 11), L = 4, both blank conventions, both lengths given,
    one zero-length and one infeasible row, card against CPU: the loss
    within ``CTC_RTOL`` relative, the gradient within ``CTC_RTOL`` of its
    largest value, no NaN.  (e) A net of the new layers and ops
    (``Conv1D``/``Conv3D``, the three transposed convolutions,
    ``InstanceNorm``, ``GroupNorm``, ``PReLU``, ``ELU``, ``SELU``,
    ``GELU``, ``Swish``, ``ReflectionPad2D``, ``UpSampling``, ``LRN``,
    ``L2Normalization``, ``PixelShuffle2D``) on the card against the CPU
    from the same weights: the output and every gradient within
    ``BASICS_TOL`` of its largest value.

The phases run in the order 1-3, 5, 6, 10, 7-9, 4, 11-18b, 19-20b, 23,
24, 25, 21, 22, 38, 39, 40, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
37, 41, 42 (20, 23, 24, 25, 21, 22, 38, 39 and 40 in one launch of 2 ranks and a
parameter server; 21b, 2+ cards only, in another): every
torch.profiler session (phases 6 and 10, and the profiles below) comes
before the first CUDA graph (phase 8's predict forwards), as graphs
captured before them broke the profiler's device readings (PERF.md §6).

The last lines are the total wall time, the kernels' JSON record, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Needs one CUDA device, the
CUDA toolkit, and the repository beside this file.

    python3 chip_smoke.py --profile-train

also writes a ``torch.profiler`` table of two training steps to
``chiprun_out/train_profile.txt`` and prints its top rows;
``--profile-resnet`` does the same for two ResNet-50 steps, into
``chiprun_out/resnet_profile.txt``, and prints the fused kernels' share of
the device time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): CUDA-core fp32 and tensor-core
# bf16 FLOP/s, and HBM3 bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# fp32 products on the tensor cores as 3xTF32 (three TF32 products, 495
# TFLOP/s dense, per fp32 product): the fp32 attention bounds' rate, which
# a tensor-core kernel can beat the CUDA cores' 67 TFLOP/s by
TF32X3_FLOPS = 495e12 / 3

SERVE_REQUESTS = 32
SERVE_THREADS = 4
# fp32 card vs CPU after 12 encoder layers: matmuls sum in other orders
# on the two devices (TF32 off); outputs are LayerNorm-scaled, O(1)
CPU_ATOL = 1e-3

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 32, 128, 20
# training, card vs CPU from the same weights (fp32, TF32 off, dropout 0):
# the two losses within 1e-4 relative, and layer 0's attn_in_weight
# gradient within 1e-3 of its largest magnitude (12 layers of backward
# summed in other orders on the two devices)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# backward kernels vs their plain version: fp32 sums over up to 512 keys
# in other orders; bf16 outputs are rounded to bf16
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 2e-2)}

RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 128, 224, 20
PREDICT_BATCH = 64
# fused 1x1 kernels vs their plain version: y within these (atol, rtol):
# fp32 sums over up to 2048 products in other orders; bf16 outputs are
# rounded to bf16 (2^-8 relative), and another order may round a sum to
# the neighbouring value
FUSED_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# the bf16 training step against the same steps from the same weights with
# the fused 1x1 kernels pinned to the simple route (PR 3's template): the
# products and the statistics sum in other orders, and at lr 0.1 each
# update widens the gap (the two runs part after ~8 steps).  On one H100
# (PERF.md, PR 5) the losses of steps 1-4 were 4.0e-5, 2.6e-4, 1.6e-3 and
# 7.5e-3 apart, relative; the limits are about ten times those, five at
# step 4.  A fused kernel that is wrong moves the first loss by far more.
RESNET_ROUTE_RTOL = (4e-4, 3e-3, 1.5e-2, 4e-2)
# ResNet-50 references (fp32, TF32 off, b=8, 112^2, 2 SGD steps from the
# same weights).  The first loss is a forward alone: within 1e-4 relative
# (sums in other orders through 53 layers).  The first step's updates,
# -lr*(grad + wd*w), relative in L2.  A ReLU input within rounding of zero
# can open on one side and not on the other, which moves the gradient of
# every layer below it; a one-ulp change of the input moves ReLU inputs by
# up to ~4e-5.  So the limits are set from the gaps that a one-ulp change
# of the input (up, then down) makes on the card alone, the floor the
# script prints beside them; on one H100 (PERF.md, PR 3) the floor and the
# card-vs-CPU and fused-vs-standard gaps were: classifier weight (no ReLU
# above it) 3.4-4.9e-5, limit 5e-4; the last bottleneck's conv3 weight
# (the final ReLU above it) 0.67-1.06%, limit 3%; the first bottleneck's
# conv1 weight (every ReLU above it) 2.48-2.84%, limit 6%; the second loss
# (after every layer's update at lr 0.1) 1.66-4.12%, limit 8%.
RESNET_FC_KEY = "output.weight"
RESNET_TOP_KEY = "features.7.2.body.6.weight"
RESNET_DEEP_KEY = "features.4.0.body.0.weight"
RESNET_LOSS1_RTOL = 1e-4
RESNET_FC_UPDATE_RTOL = 5e-4
RESNET_TOP_UPDATE_RTOL = 0.03
RESNET_UPDATE_RTOL = 0.06
RESNET_LOSS2_RTOL = 0.08

# the recurrence kernels vs their plain versions, max |err| over max(1,
# max |ref|): fp32, the same products and activations summed in other
# orders through up to 96 dependent steps and, for dWh, over up to 307,200
# rows; bf16 forward outputs (ys, hn, cn) are rounded to bf16 (2^-8
# relative), so a value within rounding of a midpoint may round the other
# way: two ulps
RNN_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
DEEPAR_BATCH, DEEPAR_CONTEXT, DEEPAR_PREDICT = 32, 72, 24
DEEPAR_STEPS, DEEPAR_SAMPLES = 20, 100
# DeepAR card vs CPU (fp32, TF32 off, dropout 0, batch 4, same weights).
# The first NLL is a mean over 4 x 96 positions of a 2-layer, 96-step
# recurrence whose sums run in other orders on the two devices: 1e-5
# relative.  l0_h2h_weight's gradient sums over all 96 steps of both
# layers' backward: 1e-4 of its largest magnitude.  The losses of 2 Adam
# steps (the second after an update of every weight): 1e-4 relative.  The
# first predict step's (mu, sigma, nu), O(1) values out of the same
# network: 1e-4 absolute.  predict's paths (4 series x 4 samples, 3 steps):
# the same RandomState draws scaled by those parameters, each step's value
# fed back as the next step's lag: 1e-4 of the largest |value|.
DEEPAR_NLL_RTOL = 1e-5
DEEPAR_GRAD_RTOL = 1e-4
DEEPAR_LOSS_RTOL = 1e-4
DEEPAR_PARAM_ATOL = 1e-4
DEEPAR_PATH_RTOL = 1e-4
# MXNet 1.x's example/gluon/word_language_model defaults with --model gru
GRU_HIDDEN, GRU_T, GRU_BATCH, GRU_STEPS = 200, 35, 32, 20
# Transformer-big as examples/nmt/train_transformer.py runs it (--model big
# --batch-size 64 --buckets 16,32,64; vocabularies 32,000; Adam lr 3e-4,
# beta2 0.98; label smoothing 0.1): 7 full batches a bucket, 20 steps
TFM_VOCAB, TFM_BATCH, TFM_BUCKETS = 32000, 64, (16, 32, 64)
TFM_WIDTHS = dict(units=1024, hidden_size=4096, num_layers=6, num_heads=16)
TFM_BATCHES_A_BUCKET, TFM_STEPS = 7, 20
TFM_OPT = {"learning_rate": 3e-4, "beta2": 0.98}
# attention launches of one Transformer-big forward: 6 encoder
# self-attentions, 6 causal decoder self-attentions, 6 cross-attentions
TFM_ATTENTIONS = 18
# decoding: 8 source rows of bucket 32, beam 4 with GNMT alpha 0.6 (Vaswani
# et al. 2017, 6.1), up to 32 tokens
TFM_DECODE_ROWS, TFM_DECODE_LEN, TFM_BEAM, TFM_ALPHA = 8, 32, 4, 0.6
# the CPU's argmax must be the card's token where its top-2 margin is above
# this: twice the logits' card-vs-CPU tolerance (CPU_ATOL)
TFM_MARGIN = 2e-3
# phase 19, the kvstore on the card: values a key for the API calls, calls
# timed of the fused pushpull over BERT-base's gradients, and the
# optimizers set on the kvstore (3 pushes each)
KV_SLOTS, KV_ITERS = 5, 5
KV_OPTIMIZERS = (("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
                 ("adam", {"learning_rate": 0.01}))
# Adam through the kvstore, card against CPU: torch.sqrt rounds some values
# the other way on the card (PERF.md, PR 14), which moves an update by an
# ulp of its denominator; everything else in phase 19 is bit-identical
KV_ADAM_RTOL = 1e-6
# phase 20, BERT-base under dist_sync: 2 ranks, each on half of a batch of
# 16 x 128, 6 Adam steps; the losses against one process over the same
# halves within BERT's card-vs-CPU limit (fp32, gradients summed in other
# orders); the launch's own time limit
DIST_RANKS, DIST_BATCH, DIST_SEQ, DIST_STEPS = 2, 16, 128, 6
DIST_ADAM = {"learning_rate": 1e-4}
DIST_LOSS_RTOL = TRAIN_LOSS_RTOL
DIST_TIMEOUT_S = 600
# phases 21-22, DataParallelTrainer over a mesh of 2 ranks that the
# port's launcher starts (make_mesh() = {dp: 2}); both ranks on gpu(0)
# under gloo (phase 21b: gpu(0), gpu(1) under NCCL where 2 cards are
# visible).  Phase 21: fused ResNet-50 at phase 7's global batch, bf16
# compute; the cross-replica check at b=16 112^2 fp32 against one process
# at phase 9's limits, and the moving statistics after step 1 within 1e-4
# relative (the global batch's statistics summed in other orders).  Phase
# 22: BERT-base MLM+NSP, a loss a row (so the mean over the data ranks is
# the batch's), fp32, dropout 0, AdamW; the losses within BERT's
# card-vs-CPU limit of one process over the global batch
# phase 23, the Trainer's ZeRO over dist_sync ranks, from phase 20's weights
# and halves: the whole step unsharded, then ZeRO-sharded (saved after
# ZERO_SAVE_AT steps and resumed in one process)
ZERO_STEPS, ZERO_SAVE_AT = 4, 2
ZERO_TIMEOUT_S = 400
# phase 24, the Trainer on a mesh of phase 20's ranks, from phase 20's
# weights and batch (a loss a half of it): mp=2 (saved after SPMD_SAVE_AT
# steps), then dp=2 with ZeRO; a rank's bytes at rest at most SPMD_SHARE of
# the full ones (half, and what the split leaves over); the products a
# forward computes on a shard (24 encoder Dense, 24 attention
# projections, the 4 heads' Dense)
SPMD_RUNS = (("mp2", "mp=2", False), ("dp2_zero", "dp=2", True))
SPMD_STEPS, SPMD_SAVE_AT = 3, 2
SPMD_SHARE = 0.51
SPMD_SPLITS = 52
SPMD_TIMEOUT_S = 400
# the peak memory a rank of phase 24's runs, printed in phase 22
SPMD_PEAK = {}
MESH_RANKS, MESH_RESNET_STEPS = 2, 6
MESH_REF_BATCH, MESH_REF_IMAGE = 16, 112
MESH_STATS_RTOL = 1e-4
MESH_BERT_BATCH, MESH_BERT_SEQ, MESH_BERT_STEPS = 16, 128, 3
MESH_ADAMW = {"learning_rate": 1e-4, "wd": 0.01}
MESH_LOSS_RTOL = TRAIN_LOSS_RTOL
MESH_TIMEOUT_S = 400
# phase 25, the pp and sp axes: the pipeline LM at GPT-2 small's published
# widths (Radford et al. 2019, the 124M model: vocabulary 50257, context
# 1024, 12 x 768, 12 heads, FFN 3072) with this LM's pre-LN blocks and
# untied head, fp32; 2 ranks over {pp:2} (PP_STEPS steps) and {sp:2}
# (PP_SP_STEPS); the first loss against one process within BERT's
# card-vs-CPU limit and the gradients within 1e-3 of their largest value
# (PERF.md section 2); ring and Ulysses attention at PP_ATTN, causal,
# within 1e-4 of the oracle
PP_VOCAB, PP_CTX, PP_D, PP_LAYERS, PP_HEADS, PP_FF = 50257, 1024, 768, 12, \
    12, 3072
PP_RANKS, PP_BATCH, PP_MICRO, PP_STEPS, PP_SP_STEPS = 2, 8, 4, 4, 2
PP_LR = 3e-4
PP_LOSS_RTOL, PP_GRAD_TOL, PP_ATTN_TOL = TRAIN_LOSS_RTOL, 1e-3, 1e-4
PP_ATTN = (1, 12, 4096, 64)
PP_COMM_ITERS = 5
PP_TIMEOUT_S = 400
# the cells against the fused layers, max |err| over max |fused|: fp32,
# the same products summed in other orders through 35 steps of 2 layers
CELL_RTOL = 1e-4
# phase 26, the input tier.  MNIST's own sizes; train_mnist.py's batch,
# optimizer and one epoch.  The digits are separable (a bright band of 6
# rows a class), so one epoch should classify nearly every test row: 0.97
# leaves room for the bands' overlap.  Card vs CPU from the same weights
# and batches: fp32, TF32 off, two convolutions and two dense layers
# summed in other orders, then SGD-momentum updates: BERT's 1e-4 relative
MNIST_TRAIN, MNIST_TEST, LENET_BATCH = 60000, 10000, 128
# a sixth of the epoch: the loop is host-bound (~2,400 samples/s on the
# card machine), and the rest of the epoch's time is what phase 27 needs
# of the time limit (the digits are learnt within ~100 steps)
LENET_ROWS = 10000
LENET_MIN_ACC, LENET_LOSS_RTOL, LENET_REF_STEPS = 0.97, 1e-4, 5
# ResNet-50 fed by a pipeline: 10 batches of bench.py's b=128 at 224^2,
# saved after DATA_SAVE_AT steps
DATA_IMAGES, DATA_SAVE_AT, DATA_WORKERS = 1280, 5, 4
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# phase 27 (a): ResNet-50 from an indexed .rec of JPEGs through
# ImageRecordIter with train_imagenet.py's recipe (its --data-nthreads
# default, 8); 6 steps at b=128; 128 distinct 500x375 images (a typical
# ImageNet size) encoded once, each under 6 ids
JPEG_RECORDS, JPEG_DISTINCT, JPEG_HW = 768, 128, (375, 500)
IMAGENET_RECIPE = dict(
    data_shape=(3, 224, 224), batch_size=128, shuffle=True, rand_mirror=True,
    random_resized_crop=True, min_random_area=0.08, max_random_area=1.0,
    min_aspect_ratio=0.75, max_aspect_ratio=1.333, brightness=0.4,
    contrast=0.4, saturation=0.4, mean_r=123.68, mean_g=116.779,
    mean_b=103.939, std_r=58.393, std_g=57.12, std_b=57.375,
    preprocess_threads=8)
# phase 27 (b): BERT-base from a text corpus as pretrain_bert.py feeds it
# (--wordpiece-vocab 8000), 20 steps of 32 x 128, phase 5's count: over 10
# fresh batches AdamW's first steps swing the loss by more than it falls
# (11.1687 -> 11.1733 on an H100, PERF.md's findings)
CORPUS = dict(n_docs=400, sents_per_doc=8, words_per_sent=24, n_words=5000)
WORDPIECE_VOCAB, CORPUS_STEPS = 8000, 20
# phase 28: RES_STEPS supervised steps, a save every RES_SAVE_EVERY (after
# steps 1, 3, 5, 7), twice: clean and under RES_PLAN.  The kill lands at
# step 3 before its save, so the SIGTERM hook's final save commits step 3;
# the step-5 save commits truncated; the transient fault at step 6 makes
# the restore fall back past it to step 3
RES_STEPS, RES_SAVE_EVERY, RES_SERVE_REQUESTS = 8, 2, 8
RES_PLAN = {"seed": 28, "faults": [
    {"site": "train.step", "action": "kill", "match": {"step": 3}},
    {"site": "checkpoint.commit", "action": "truncate", "match": {"step": 5}},
    {"site": "train.step", "action": "raise", "match": {"step": 6}},
    {"site": "engine.h2d", "action": "delay", "delay_s": 0.02, "times": 2}]}
# phase 29, int8 BERT-base serving: quantize_net calibrated ("naive") on
# INT8_CALIB_BATCHES synthetic batches of INT8_CALIB_SHAPE, then served
# through phase 4's bucket grid.  The card against the CPU's int8 path on
# the same weights and ranges, two ways.  Layer by layer, on one input: an
# output quantum apart at most, at INT8_LAYER_FLIPS of the elements at
# most (the same int8 input and an exact product give the same levels; a
# last-bit difference of the float32 scale arithmetic can move a value
# sitting on a rounding boundary).  End to end, the logits: a float32
# rounding (attention, LayerNorm) that moves one activation across a
# rounding boundary moves it a quantum, which moves many of the next
# layer's outputs across theirs, so after 12 layers the card's and the
# CPU's int8 runs carry independent quantization errors of the size of
# int8's own error against float32 (PR 22, call 1: 0.024-0.126 of the
# logits' norm apart); the card's int8 logits may lie up to
# INT8_NOISE_FACTOR times that error from the CPU's (two independent errors
# add at most so), and a wrong scale, range or weight lies far beyond
INT8_CALIB_BATCHES, INT8_CALIB_SHAPE = 4, (8, 128)
INT8_SERVE_REQUESTS, INT8_CPU_REQUESTS = 24, 2
INT8_LAYER_ROWS, INT8_LAYER_FLIPS = 64, 1e-4
INT8_NOISE_FACTOR = 2.0
# phase 30, decode at bench.py serve_decode's device configuration
# (bench.py:733-790): TinyDecoder(256, 64), 150 requests over 16 slots,
# max_len 96, prompts of 2-16 tokens, budgets 48-72 with p = 0.25 else 4-12
DEC_VOCAB, DEC_EMBED, DEC_REQUESTS, DEC_SLOTS, DEC_MAX_LEN = 256, 64, 150, \
    16, 96
DEC_BATCHES, DEC_LENGTHS = (1, 2, 4, 8), (4, 8, 16)
DEC_PAGE_TOKENS, DEC_SPEC_K = 16, 4
# a greedy decision whose top two logits lie closer than this may go either
# way on float rounding alone: a card-vs-CPU divergence there is named, not
# failed (every other token must be equal).  The int8 arm's logits are
# levels of the projection's calibrated output range, so there a tie is a
# gap of one level or none (a rounding on a boundary moves a logit a level)
DEC_TIE_GAP = 1e-5
# phase 31: the tuner's trials at most, and the passes of phase 30's traffic
# a trial serves (one pass is ~0.15 s on the card, PR 22, call 4: too short
# a window for the tuner to tell two configurations apart)
TUNE_MAX_TRIALS, TUNE_PASSES = 6, 4
# phase 32 (a): phase 4's replica (BERT-base, buckets (1,4,8)x(128,256,512))
# three times behind a Router; 48 requests of lengths U[16,512] (seed 1)
# from 4 client threads, the first 8 healthy, the rest under ROUTER_PLAN
# (replica 1 fails every dispatch and every probe; replica 2's first probe
# stalls); evict_after=2 with a probe every ROUTER_HEALTH_SEC; then 12
# hedged requests (a budget under hedge_ms), a tenant over its quota of 2
# and a rolling reload under 24 requests, one every ROUTER_RELOAD_GAP_S, to
# a checkpoint of the same weights with the pooler's bias raised by
# ROUTER_RELOAD_BIAS
SERVE_GRID = ((1, 4, 8), (128, 256, 512))
ROUTER_REPLICAS, ROUTER_REQUESTS, ROUTER_THREADS = 3, 48, 4
ROUTER_HEALTHY_FIRST, ROUTER_HEALTH_SEC, ROUTER_HEDGE_MS = 8, 0.5, 60_000
ROUTER_HEDGE_REQUESTS, ROUTER_RELOAD_REQUESTS = 12, 24
ROUTER_RELOAD_BIAS, ROUTER_RELOAD_GAP_S = 0.5, 0.05
ROUTER_PLAN = {"seed": 32, "faults": [
    {"site": "serve.replica.submit", "action": "raise",
     "match": {"replica": 1}, "times": None},
    {"site": "serve.replica.health", "action": "raise",
     "match": {"replica": 1}, "times": None},
    {"site": "serve.replica.health", "action": "stall",
     "match": {"replica": 2}, "delay_s": 0.05, "times": 1}]}
# phase 32 (b): phase 30's decode configuration, 2 replicas, its first 48
# requests as streams
ROUTER_DECODE_REQUESTS = 48
# phase 33: BERT-base worker processes over a shorter grid (a shorter
# warm-up), an autoscaler between 1 and 2 of them; CTRL_LOAD_THREADS
# closed-loop clients against a capacity hint of CTRL_CAPACITY requests a
# worker raise the load past the scale-up occupancy (0.75)
CTRL_GRID = ((1, 4), (128, 256))
CTRL_CAPACITY, CTRL_LOAD_THREADS = 4, 12
CTRL_HEALTH_SEC, CTRL_TICK_SEC, CTRL_COOLDOWN_SEC = 0.25, 0.2, 1.0
CTRL_LEASE_SEC = 2.0
# phases 34 and 36: ResNet-50 v1 (NCHW, 224^2, 1000 classes) exported and
# bound through mx.mod.Module at b=32; the Module's forward against the
# gluon net's (same ops, same card: only cuDNN's sums in other orders) and
# its first gradients against autograd through the net (norm); fit steps,
# timed steps; int8 top-1 agreement at the JAX test's limit
SYM_BATCH, SYM_FIT_STEPS, SYM_TIMED_STEPS, SYM_IMAGE = 32, 4, 3, 224
SYM_FWD_ATOL, SYM_GRAD_RTOL = 1e-5, 1e-4
SYM_INT8_AGREE, SYM_INT8_ITERS = 0.75, 5
# phase 35: the LSTM LM of MXNet 1.x's example/rnn/bucketing/
# cudnn_lstm_bucketing.py at its default widths (PTB's vocabulary),
# LM_BATCHES batches a bucket, the example's SGD lr 0.01 (at 0.1 the
# perplexity diverged within 5 steps on the H100); card vs CPU at the RNN
# tests'
# tolerances (tests/test_torch_rnn.py:26-27); the reloaded checkpoint's
# perplexity within LM_SCORE_RTOL of the trained module's (the same graph
# bound anew: cuBLAS may pick other algorithms for other pointers)
LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS = 10000, 200, 200, 2
LM_BATCH, LM_BUCKETS, LM_BATCHES, LM_LR = 32, (10, 20, 30, 40, 50, 60), 3, 0.01
LM_SCORE_RTOL = 1e-5
LM_FWD_ATOL, LM_GRAD_TOL = 1e-5, dict(atol=1e-4, rtol=1e-4)
# phase 3's timing repeats (kernel and library calls, plain version)
PHASE3_ITERS, PHASE3_PLAIN_ITERS = 10, 2
# phases 37-38: examples/moe/train_moe_lm.py's LM at the widths of
# Switch-Base-8 ("Switch Transformers", Fedus, Zoph and Shazeer 2021;
# google/switch-base-8): d_model 768, 12 heads of 64, FFN 3072, 8 experts,
# top-1, capacity factor 1.25, vocabulary 32128, sequence 512.  Reduced:
# the example's structure (MoE in every layer where Switch has it in every
# other, no positional encoding, an untied head), random weights from a
# seed, and in phase 38 4 layers of 12
MOE_VOCAB, MOE_D, MOE_HEADS, MOE_FF, MOE_EXPERTS = 32128, 768, 12, 3072, 8
MOE_LAYERS, MOE_BATCH, MOE_SEQ, MOE_STEPS, MOE_CF = 12, 8, 512, 5, 1.25
MOE_LR, MOE_AUX = 3e-4, 0.01
MOE_CHECK_BATCH, MOE_CHECK_SEQ, MOE_TOL, MOE_TIE_GAP = 2, 128, 1e-4, 1e-6
MOE_EP_LAYERS, MOE_EP_STEPS, MOE_EP_RTOL = 4, 3, 1e-5
# phase 41: the imperative NDArray.  (a) one BERT-base encoder layer
# (768 units, 12 heads, FFN 3072) at b=8 x s=512 written in mx.nd calls,
# its output and weight gradients within IMP_TOL of their largest value
# against the BERTEncoderLayer block's eager run (the same registered
# functions in the same order); (b) an MLP (4096 x 768 inputs, 3072 hidden,
# 10 classes from a fixed random teacher) trained IMP_STEPS steps by
# ``w[:] = w - lr * w.grad``, its first IMP_CPU_STEPS losses within
# IMP_CPU_RTOL relative of the same loop on cpu() (products summed in
# other orders); (c) the samplers over IMP_DRAWS draws each
IMP_B, IMP_S, IMP_UNITS, IMP_HEADS, IMP_FFN, IMP_TOL = 8, 512, 768, 12, \
    3072, 1e-5
IMP_ROWS, IMP_CLASSES, IMP_STEPS, IMP_LR = 4096, 10, 20, 0.1
IMP_CPU_STEPS, IMP_CPU_RTOL, IMP_DRAWS = 3, 1e-4, 1 << 20
# phase 42: examples/ocr/train_crnn_ctc.py at its defaults (batch 32,
# --seq-len 4: strips of 8 x 20, T = 20 columns; hidden 64; 11 classes, the
# blank last; Adam at lr 1e-2; 600 steps); the held-out batch of 64 from
# RandomState(99); the card-vs-CPU limits of (b), the captured steps of
# (c), the CTC op's shape and limit in (d) and the layers' limit in (e)
CRNN_BATCH, CRNN_SEQ, CRNN_HIDDEN, CRNN_CLASSES = 32, 4, 64, 11
CRNN_STEPS, CRNN_LR, CRNN_EVAL, CRNN_ACC = 600, 1e-2, 64, 0.9
CRNN_LOGIT_TOL, CRNN_LOSS_RTOL, CRNN_GRAD_TOL, CRNN_STEP_RTOL = \
    1e-4, 1e-5, 1e-4, 1e-4
CRNN_CAPTURE_STEPS = 8
CTC_T, CTC_N, CTC_C, CTC_L, CTC_RTOL = 20, 32, 11, 4, 1e-5
BASICS_B, BASICS_C, BASICS_HW, BASICS_TOL = 8, 8, 16, 1e-4
# phases 39-40: BERT-base on phase 20's batch, 3 dist_async steps a rank,
# then 6 dist_sync steps under the elastic supervisor (save after step 2,
# rank 1 leaves at step 4 with code 0: the launcher ends the job when a
# worker exits non-zero)
ASYNC_STEPS = 3
ELASTIC_STEPS, ELASTIC_SAVE_AT, ELASTIC_DIE_AT, ELASTIC_LEAVE_CODE = 6, 2, 4, 0
ELASTIC_RDV_S, ELASTIC_DIST_TIMEOUT_S, ELASTIC_TIMEOUT_S = 8.0, 120, 400


def log(*args):
    print(*args, flush=True)


#: what each eager training phase leaves for its captured phase (15): the
#: first 4 losses, the parameters after them, the launches a step and the
#: step median
EAGER_RUNS = {}
#: each eager training phase's launches a step, by kernel and counter (the
#: checkpoint phase, 16, holds its resumed steps to them)
STEP_LAUNCHES = {}


def counts_now():
    """Every kernel's counters now, ``{kernel: {counter: n}}``."""
    from mxnet_tpu_torch.ops import kernels

    return {k: c.snapshot() for k, c in kernels.KERNEL_COUNTS.items()}


def counts_gain(before, after):
    """The counters that grew from ``before`` to ``after``."""
    return {k: {n: v - before[k][n] for n, v in after[k].items()
                if v != before[k][n]}
            for k in after if after[k] != before[k]}


def eager_record(label, losses, params, total, steps, median_ms):
    """Keep an eager phase's first 4 losses, its parameters after them (a
    copy), its launches a step (``total`` over ``steps``) and its step
    median for the captured phase."""
    per_step = {k: {n: v / steps for n, v in d.items()}
                for k, d in counts_gain({k: {n: 0 for n in d}
                                         for k, d in total.items()},
                                        total).items()}
    EAGER_RUNS[label] = {"losses": list(losses[:4]), "params": params,
                         "launches": per_step, "median_ms": median_ms}
    STEP_LAUNCHES[label] = per_step


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean time of ``fn`` on the card, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
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


# -- phase 3: flash attention forward ---------------------------------------


def valid_pairs(b, h, sq, sk, valid, causal):
    """The (query, key) pairs a call's rows attend to: their valid keys,
    or under causal the keys up to each row."""
    if causal:
        return b * h * sum(min(i + 1, sk) for i in range(sq))
    if valid is not None:
        return h * sq * int(sum(valid))
    return b * h * sq * sk


def least_ms(nbytes, flops, dtype, rate=None):
    """The least time (ms) for ``nbytes`` moved at the memory rate and
    ``flops`` at ``rate`` (default: the peak rate of ``dtype``), and which
    of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / (rate or PEAK_FLOPS[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_rates(dtype):
    """The attention kernels' bound rates: fp32 at 3xTF32 on the tensor
    cores, and on the CUDA cores (the bound rows 1-6 had until the
    tensor-core kernels); bf16 at the bf16 tensor-core rate."""
    if dtype == "float32":
        return TF32X3_FLOPS, PEAK_FLOPS["float32"]
    return PEAK_FLOPS[dtype], PEAK_FLOPS[dtype]


def attention_bound(b, h, sq, sk, d, dtype, valid, causal, cores=False):
    """Least time (ms) of the forward: q, k, v and the mask read once, o
    and lse written once, and the QK and PV products over the valid
    pairs, at the 3xTF32 rate (``cores``: the CUDA cores') in fp32."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * (sq + 2 * sk) * d * item + b * h * sq * d * item
              + b * h * sq * 4 + (b * sk * 4 if valid is not None else 0))
    pairs = valid_pairs(b, h, sq, sk, valid, causal)
    return least_ms(nbytes, 4.0 * pairs * d, dtype,
                    attention_rates(dtype)[int(cores)])


def host_us(fn, iters=200):
    """Host time (us) of one call of ``fn``: the wrapper's Python, checks,
    allocations and launch, without waiting for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def sass_mix(library, name, ops=("HMMA", "MUFU", "LDS", "F2F", "FFMA",
                                  "BAR", "SYNCS")):
    """Counts of a few opcodes in the SASS of each kernel of ``library``
    whose name holds ``name`` (cuobjdump from the CUDA toolkit), or None
    where cuobjdump is missing: shows which unit does the products."""
    import shutil

    from mxnet_tpu_torch.ops.kernels.build import nvcc_path

    tool = shutil.which("cuobjdump") or str(Path(nvcc_path()).with_name(
        "cuobjdump"))
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(library._target())],
                         capture_output=True, text=True, timeout=120).stdout
    mixes, current = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            current = fn if name in fn else None
            if current:
                mixes[current] = dict.fromkeys(ops, 0)
        elif current and "/*" in line:
            text = line.split("*/", 1)[-1].strip()
            op = text.split()[0] if text else ""
            if op.startswith("@"):
                op = text.split()[1]
            for o in ops:
                if op.startswith(o):
                    mixes[current][o] += 1
    return mixes


def spill_bytes(build_log, names):
    """(spill store bytes, spill load bytes) of each kernel of a library
    whose mangled name holds one of ``names``, from nvcc's ``-Xptxas -v``
    report."""
    import re

    out, current = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1) if any(n in m.group(1) for n in names) \
                else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            out[current] = (int(m.group(1)), int(m.group(2)))
            current = None
    return out


def short_name(mangled):
    """A kernel's name and template arguments out of its mangled name."""
    import re

    found = re.search(r"[a-z_]+kernelI\w{0,40}?E(?=v|E)", mangled)
    return found.group(0) if found else mangled[:80]


def tile_share(launch):
    """The share of key tiles a tensor-core attention kernel visited in
    ``launch(tiles)``, from the counter it adds to: (visited, of)."""
    import torch

    tiles = torch.zeros(2, dtype=torch.int32, device="cuda")
    launch(tiles)
    visited, total = tiles.tolist()
    return visited, total


SDPA_PROBE = r"""
import json, sys
import torch
import torch.nn.functional as tF
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
torch.backends.cuda.matmul.allow_tf32 = False
b, h, s, d, n_valid = (int(x) for x in sys.argv[1:])
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=g)
           .requires_grad_(True) for _ in range(3))
mask = torch.zeros(b, 1, 1, s, device="cuda")
mask[..., n_valid:] = -1e9
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    out = tF.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    torch.cuda.synchronize()
times = {}
for e in prof.key_averages():
    if e.device_type == DeviceType.CUDA:
        t = getattr(e, "self_device_time_total", None)
        times[e.key] = e.self_cuda_time_total if t is None else t
print(json.dumps(sorted(times, key=lambda n: -times[n])[:4]))
"""


def start_sdpa_probe(b, h, s, d):
    """Start reading the device kernels of one fp32 SDPA forward and
    backward on (b, h, s, d) inputs with an additive key-padding mask (the
    backend PyTorch picks) by torch.profiler in a process of its own, so
    that no profiler session of this process comes before the ResNet
    phase's device readings.  It starts before phase 3, whose forward
    sweep hides its start-up; :func:`sdpa_kernel_names` reads it."""
    return subprocess.Popen([sys.executable, "-c", SDPA_PROBE, str(b),
                             str(h), str(s), str(d), str(s // 2)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def sdpa_kernel_names(probe):
    """The probe's kernels, longest first (:func:`start_sdpa_probe`)."""
    out, err = probe.communicate(timeout=300)
    if probe.returncode != 0 or not out.strip():
        return f"not read: {err.strip()[-300:]}"
    return json.loads(out.strip().splitlines()[-1])


def decode_rows(mx):
    """Phase 18's source rows and their valid lengths, as numpy: the first
    ``TFM_DECODE_ROWS`` of the first bucket-32 batch."""
    _, (src, _, svl), _ = next(b for b in nmt_batches(mx)
                               if b[0] == TFM_DECODE_LEN)
    return src[:TFM_DECODE_ROWS], svl[:TFM_DECODE_ROWS]


def fwd_shapes(mx):
    """The forward check's shapes: ``(label, b, h, sq, sk, d, dtypes,
    masks, valid, layout, seed)``.  BERT-base's serve shape and its d=128
    twin; Transformer-big's bucket-64 training shape (b=64, h=16, s=64),
    causal (the decoder's self-attention) and key-padded (the encoder's
    and the cross-attention); and its decode steps at 8 (greedy) and 32
    (beam 4) rows for prefixes of t = 1, 17 and 31: cross-attention of t
    queries on the 32 source keys under their key-padding row, and causal
    self-attention at sq = sk = t.  ``layout`` "packed": q, k and v head
    views of one ``(b, s, 3*h*d)`` tensor (the self-attention's packed
    projection); "cross": q a head view of a ``(b, sq, h*d)`` tensor, k and
    v of two ``(b, sk, h*d)`` ones (the three-projection branch).  A seed
    of None draws on from the shape before."""
    import numpy as np

    bert = np.array([512, 500, 384, 300, 256, 130, 17, 0])
    both, masks = ("float32", "bfloat16"), ("none", "key_padding", "causal")
    shapes = [("bert", 8, 12, 512, 512, 64, both, masks, bert, "packed", 0),
              ("d128", 8, 6, 512, 512, 128, both, masks, bert, "packed",
               None)]
    s = TFM_BUCKETS[-1]
    shapes.append(("transformer_big_b64", TFM_BATCH, 16, s, s, 64,
                   ("float32",), ("causal", "key_padding"),
                   np.random.RandomState(7).randint(33, s + 1,
                                                    size=TFM_BATCH),
                   "packed", 7))
    shapes.append(("gpt2_pp", PP_BATCH // PP_MICRO, PP_HEADS, PP_CTX, PP_CTX,
                   PP_D // PP_HEADS, ("float32",), ("causal",), None,
                   "packed", 25))
    valid = np.asarray(decode_rows(mx)[1]).astype(np.int64)
    for rows in (TFM_DECODE_ROWS, TFM_BEAM * TFM_DECODE_ROWS):
        vl = np.repeat(valid, rows // TFM_DECODE_ROWS)  # beam's row order
        for t in (1, 17, TFM_DECODE_LEN - 1):
            label = f"decode_b{rows}_t{t}"
            shapes.append((label, rows, 16, t, TFM_DECODE_LEN, 64,
                           ("float32",), ("key_padding",), vl, "cross", 8))
            shapes.append((label, rows, 16, t, t, 64, ("float32",),
                           ("causal",), None, "packed", None))
    return shapes


def fwd_inputs(rng, b, h, sq, sk, d, layout, dev):
    """Draws fp32 tensors in ``layout`` (:func:`fwd_shapes`); returns a
    function of a dtype that gives q, k and v as head views of them cast
    to it."""
    import numpy as np
    import torch

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                * 0.5).to(dev)

    def heads(t):
        return t.reshape(b, t.shape[1], h, d).transpose(1, 2)

    if layout == "packed":
        base = [rand(b, sq, 3 * h * d)]
    else:
        base = [rand(b, sq, h * d), rand(b, sk, h * d), rand(b, sk, h * d)]

    def views(dtype):
        cast = [t.to(getattr(torch, dtype)) for t in base]
        if layout == "packed":
            cast = cast[0].chunk(3, dim=-1)
        return [heads(t) for t in cast]

    return views


def check_flash_attention(mx):
    """Kernel vs plain, o and lse, at the shapes of :func:`fwd_shapes`.
    Returns the record of the main-path case (BERT's serve shape, fp32,
    key padding: b=8, h=12, s=512, d=64) and ``{label: {mask: record}}``
    of Transformer-big's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as tF

    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda", 0)
    tol = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 1e-3)}
    main, by_shape, rng = None, {}, None
    log("flash_attention_fwd: kernel vs plain (o atol / lse atol: fp32 "
        "1e-4 / 1e-3, bf16 2e-2 / 1e-3); q, k, v are head views of a "
        "packed QKV tensor (cross: of the q, k and v projections), read in "
        "place; bound at 3xTF32 (fp32), the CUDA-core bound in brackets; "
        "tiles: key tiles visited of those without skipping")
    shape_s = {}
    for (label, b, h, sq, sk, d, dtypes, masks, valid, layout,
         seed) in fwd_shapes(mx):
        t_shape = time.perf_counter()
        if seed is not None:
            rng = np.random.RandomState(seed)
        views = fwd_inputs(rng, b, h, sq, sk, d, layout, dev)
        for dtype in dtypes:
            q, k, v = views(dtype)
            for mask in masks:
                km = None
                if mask == "key_padding":
                    keep = torch.from_numpy(np.arange(sk)[None, :]
                                            < valid[:, None])
                    km = torch.where(keep, 0.0, -1e9).to(dev, torch.float32)
                causal = mask == "causal"
                assert all(fa.rows_aligned(t) for t in (q, k, v))
                o, lse = fa.flash_attention_fwd(q, k, v, km, causal=causal)
                po, plse = fa.flash_attention_plain(q, k, v, km,
                                                    causal=causal)
                torch.cuda.synchronize()
                o_err = (o.float() - po.float()).abs().max().item()
                lse_err = ((lse - plse).abs()
                           / (1.0 + 1e-6 * plse.abs())).max().item()
                finite = bool(torch.isfinite(o).all())
                ok = finite and o_err <= tol[dtype][0] and \
                    lse_err <= tol[dtype][1]
                kern_ms = cuda_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, km, causal=causal), iters=PHASE3_ITERS)
                plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, km, causal=causal), iters=PHASE3_PLAIN_ITERS)
                attn_mask = None if km is None else \
                    km.to(q.dtype).view(b, 1, 1, sk)
                lib_ms = cuda_ms(lambda: tF.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, is_causal=causal),
                    iters=PHASE3_ITERS)
                vl = valid if mask == "key_padding" else None
                bound_ms, bound_by = attention_bound(b, h, sq, sk, d, dtype,
                                                     vl, causal)
                cores_ms, _ = attention_bound(b, h, sq, sk, d, dtype, vl,
                                              causal, cores=True)
                visited, total = tile_share(lambda t: fa._launch_fwd(
                    q, k, v, km, causal, None, tiles=t))
                log(f"  {label:19s} b={b} h={h} sq={sq} sk={sk} d={d} "
                    f"{dtype:8s} {mask:11s} "
                    f"o_err={o_err:.3g} lse_err={lse_err:.3g} "
                    f"kernel={kern_ms:.4f}ms "
                    f"plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
                    f"bound={bound_ms:.4f}ms ({bound_by}; "
                    f"{cores_ms:.4f}) tiles {visited}/{total} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"flash attention kernel disagrees "
                                     f"with its plain version: {label} "
                                     f"d={d} {dtype} {mask}")
                rec = {"max_abs_err": o_err, "ms": kern_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms}
                if label.startswith(("transformer", "decode", "gpt2")):
                    by_shape.setdefault(label, {})[mask] = dict(
                        rec, lse_err=lse_err)
                if (label, dtype, mask) == ("bert", "float32",
                                            "key_padding"):
                    main = dict(rec, cuda_core_bound_ms=cores_ms,
                                tiles_visited=[visited, total])
                    main["host_us"] = host_us(lambda: fa.flash_attention_fwd(
                        q, k, v, km))
                    log(f"  main case: the wrapper's host time "
                        f"{main['host_us']:.1f} us a call")
        shape_s[label] = round(shape_s.get(label, 0.0)
                               + time.perf_counter() - t_shape, 2)
    log(f"flash_attention_fwd: seconds by shape {shape_s}")
    return main, by_shape


def bwd_bound(b, h, sq, sk, d, dtype, valid, causal, n_ops, n_out,
              cores=False):
    """Least time (ms) of one backward kernel: q, k, v, dO read once, lse
    and delta (fp32) and the mask read once, ``n_out`` (b,h,s,d) outputs
    written once; ``n_ops * d`` operations per valid pair, at the rates of
    :func:`attention_bound`."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * (2 * sq + 2 * sk) * d * item + 2 * b * h * sq * 4
              + (b * sk * 4 if valid is not None else 0)
              + n_out * b * h * sq * d * item)
    pairs = valid_pairs(b, h, sq, sk, valid, causal)
    return least_ms(nbytes, float(n_ops) * pairs * d, dtype,
                    attention_rates(dtype)[int(cores)])


def check_flash_attention_bwd(mx, probe):
    """dQ and dK/dV kernels vs the plain backward; returns the records of
    the main-path case (fp32, key padding, the training shape), the
    forward kernel's time at that shape, and under "transformer_big_b64"
    ``{"dq"/"dkv": {mask: record}}`` at Transformer-big's bucket-64
    training shape (b=64, h=16, s=64, d=64, fp32; causal, the decoder's
    self-attention, and key-padded, the encoder's and the
    cross-attention) and under "gpt2_pp" at phase 25's micro-batch (b=2,
    h=12, s=1024, d=64, fp32, causal).

    q, k and v are head views of one packed ``(b, s, 3*h*d)`` tensor and
    dO a head view of a ``(b, s, h*d)`` one, the layouts autograd hands
    the kernels in training."""
    import numpy as np
    import torch
    import torch.nn.functional as tF

    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(2)
    main = {}
    log(f"flash_attention_bwd: dQ and dK/dV kernels vs plain (fp32 atol/"
        f"rtol {BWD_TOL['float32']}, bf16 {BWD_TOL['bfloat16']}); the "
        f"key-padding case has a dead row except at the training shape's "
        f"main case; bounds at 3xTF32 (fp32), the CUDA-core bound after the "
        f"slash; tiles: the dQ kernel's key tiles visited of those without "
        f"skipping")
    both = ("float32", "bfloat16")
    shapes = (("train", TRAIN_BATCH, 12, TRAIN_SEQ, 64, both, rng),
              ("serve", 8, 12, 512, 64, both, rng),
              ("d128", 8, 6, 512, 128, both, rng),
              ("transformer_big_b64", TFM_BATCH, 16, TFM_BUCKETS[-1], 64,
               ("float32",), np.random.RandomState(7)),
              ("gpt2_pp", PP_BATCH // PP_MICRO, PP_HEADS, PP_CTX,
               PP_D // PP_HEADS, ("float32",), np.random.RandomState(25)))
    shape_s = {}
    for label, b, h, s, d, dtypes, srng in shapes:
        t_shape = time.perf_counter()
        packed = torch.from_numpy(srng.randn(b, s, 3 * h * d)
                                  .astype(np.float32) * 0.5).to(dev)
        dout = torch.from_numpy(srng.randn(b, s, h * d)
                                .astype(np.float32)).to(dev)
        if label == "train":
            valid = srng.randint(32, s + 1, size=b)
        elif label == "transformer_big_b64":
            valid = srng.randint(33, s + 1, size=b)
        else:
            valid = np.array([512, 500, 384, 300, 256, 130, 17, 0])
        cases = ["none", "key_padding", "causal"]
        if label == "train":
            cases.insert(1, "key_padding_dead_row")
        elif label == "transformer_big_b64":
            cases = ["causal", "key_padding"]
        elif label == "gpt2_pp":
            cases = ["causal"]
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in
                       packed.to(dt).chunk(3, dim=-1))
            do = dout.to(dt).reshape(b, s, h, d).transpose(1, 2)
            for mask in cases:
                vl = valid.copy()
                if mask == "key_padding_dead_row":
                    vl[-1] = 0
                keep = torch.from_numpy(np.arange(s)[None, :] < vl[:, None])
                km = torch.where(keep, 0.0, -1e9).to(dev, torch.float32) \
                    if mask.startswith("key_padding") else None
                causal = mask == "causal"
                o, lse = fa.flash_attention_fwd(q, k, v, km, causal=causal)
                dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, km,
                                                    causal=causal)
                ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, km,
                                                   causal=causal)
                torch.cuda.synchronize()
                atol, rtol = BWD_TOL[dtype]
                errs, ok = [], True
                for g, r in zip((dq, dk, dv), ref):
                    errs.append((g.float() - r.float()).abs().max().item())
                    ok = ok and bool(torch.isfinite(g).all()) and \
                        torch.allclose(g.float(), r.float(), atol=atol,
                                       rtol=rtol)
                delta = (do.float() * o.float()).sum(-1).reshape(b * h, s)
                args = (q, k, v, do, lse, delta, km)
                assert all(fa.rows_aligned(t) for t in (q, k, v, do))
                dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq(
                    *args, causal=causal), iters=PHASE3_ITERS)
                visited, total = tile_share(lambda t: fa._launch_dq(
                    *args, causal, None, tiles=t))
                dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv(
                    *args, causal=causal), iters=PHASE3_ITERS)
                blocks = tile_share(lambda t: fa._launch_dkv(
                    *args, causal, None, blocks=t))
                rule = dkv_block_model(vl if km is not None else None, b, h,
                                       s, causal)
                if blocks != rule:
                    raise SystemExit(
                        f"the dK/dV kernel visited {blocks} blocks of keys, "
                        f"its rule {rule}: {label} {dtype} {mask}")
                plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, km, causal=causal),
                    iters=PHASE3_PLAIN_ITERS)
                lib_ms = sdpa_backward_ms(tF, q, k, v, do, km, causal)
                dvalid = vl if km is not None else None
                dq_bound = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                     6, 1)
                dkv_bound = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                      8, 2)
                dq_cores = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                     6, 1, cores=True)[0]
                dkv_cores = bwd_bound(b, h, s, s, d, dtype, dvalid, causal,
                                      8, 2, cores=True)[0]
                log(f"  {label:5s} b={b} h={h} s={s} d={d} {dtype:8s} "
                    f"{mask:20s} err dq/dk/dv {errs[0]:.3g}/{errs[1]:.3g}/"
                    f"{errs[2]:.3g} dQ={dq_ms:.4f}ms "
                    f"(bound {dq_bound[0]:.4f} {dq_bound[1]}/{dq_cores:.4f})"
                    f" tiles {visited}/{total} dKdV={dkv_ms:.4f}ms (bound "
                    f"{dkv_bound[0]:.4f} {dkv_bound[1]}/{dkv_cores:.4f}) "
                    f"blocks {blocks[0]}/{blocks[1]} "
                    f"plain={plain_ms:.4f}ms sdpa_bwd={lib_ms:.4f}ms "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"flash attention backward kernels "
                                     f"disagree with their plain version: "
                                     f"{label} {dtype} {mask}")
                if label in ("transformer_big_b64", "gpt2_pp"):
                    tfm = main.setdefault(label, {"dq": {}, "dkv": {}})
                    for name, ms, err, (bms, bby) in (
                            ("dq", dq_ms, errs[0], dq_bound),
                            ("dkv", dkv_ms, max(errs[1:]), dkv_bound)):
                        tfm[name][mask] = {
                            "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bms,
                            "bound_by": bby, "library_ms": lib_ms}
                    tfm["dkv"][mask]["blocks_visited"] = list(blocks)
                if (label, dtype, mask) == ("train", "float32",
                                            "key_padding"):
                    fwd_ms = cuda_ms(lambda: fa.flash_attention_fwd(
                        q, k, v, km), iters=20)
                    sdpa_fwd_ms = cuda_ms(
                        lambda: tF.scaled_dot_product_attention(
                            q, k, v, attn_mask=km.view(b, 1, 1, s)),
                        iters=20)
                    for name, ms, err, (bms, bby), cores in (
                            ("dq", dq_ms, errs[0], dq_bound, dq_cores),
                            ("dkv", dkv_ms, max(errs[1:]), dkv_bound,
                             dkv_cores)):
                        main[name] = {"max_abs_err": err, "ms": ms,
                                      "plain_ms": plain_ms, "bound_ms": bms,
                                      "bound_by": bby, "library_ms": lib_ms,
                                      "cuda_core_bound_ms": cores}
                    main["dq"].update(
                        tiles_visited=[visited, total],
                        host_us=host_us(lambda: fa.flash_attention_bwd_dq(
                            *args, causal=causal)))
                    main["dkv"].update(
                        blocks_visited=list(blocks),
                        host_us=host_us(lambda: fa.flash_attention_bwd_dkv(
                            *args, causal=causal)))
                    main["fwd_ms"] = fwd_ms
                    names = sdpa_kernel_names(probe)
                    log(f"  train shape fp32 key padding: forward kernel "
                        f"{fwd_ms:.4f} ms, SDPA's forward {sdpa_fwd_ms:.4f};"
                        f" dQ {dq_ms:.4f} ms against 6/14 of SDPA's "
                        f"backward {6 / 14 * lib_ms:.4f}; the dQ and dK/dV "
                        f"wrappers' host time {main['dq']['host_us']:.1f} "
                        f"and {main['dkv']['host_us']:.1f} us a call; "
                        f"SDPA's kernels at this shape (forward and "
                        f"backward, by device time): {names}")
                    held = {"dkv_at_or_below_8/14_of_sdpa_bwd":
                            dkv_ms <= 8 / 14 * lib_ms,
                            "dq_plus_dkv_below_sdpa_bwd":
                            dq_ms + dkv_ms < lib_ms}
                    log(f"  train shape fp32 key padding, same call: dK/dV "
                        f"{dkv_ms:.4f} ms against 8/14 of SDPA's backward "
                        f"{8 / 14 * lib_ms:.4f}; dQ + dK/dV "
                        f"{dq_ms + dkv_ms:.4f} ms against SDPA's backward "
                        f"{lib_ms:.4f}; dK/dV blocks of 64 keys visited "
                        f"{blocks[0]} of {blocks[1]}; "
                        + ", ".join(f"{k}: {'held' if v else 'MISSED'}"
                                    for k, v in held.items())
                        + " (printed, not gated)")
        shape_s[label] = round(time.perf_counter() - t_shape, 2)
    t_shape = time.perf_counter()
    check_function_gradients(fa, dev, rng)
    shape_s["function_gradients"] = round(time.perf_counter() - t_shape, 2)
    log(f"flash_attention_bwd: seconds by shape {shape_s}")
    return main


def dkv_block_model(valid, b, h, s, causal, block=64):
    """The blocks of ``block`` keys the dK/dV kernel visits by its rule,
    and all its blocks, for sq = sk = s and batch row i's first
    ``valid[i]`` keys live (``valid`` None: no mask): a block is skipped
    when all its keys are padding and the row's first live key is at most
    the block's first key under causal, or exists at all."""
    n = -(-s // block)
    skipped = 0
    if valid is not None:
        for nv in valid:
            if nv > 0:
                skipped += sum(1 for kb in range(n) if block * kb >= nv)
    # under causal the first live key (0) is at most every block's first
    return (b * n - skipped) * h, b * n * h


def sdpa_backward_ms(tF, q, k, v, do, km, causal):
    """The backward of ``scaled_dot_product_attention`` at the same shape
    and mask, timed on its own (the graph is kept across calls)."""
    import torch

    b, s = q.shape[0], q.shape[2]
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    attn_mask = None if km is None else km.to(q.dtype).view(b, 1, 1, s)
    out = tF.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn_mask,
                                          is_causal=causal)
    return cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                               retain_graph=True), iters=10)


def check_function_gradients(fa, dev, rng):
    """The autograd Function on the card (kernel forward and backward)
    against torch.autograd through the plain forward, fp32, key padding
    without dead rows: within 1e-4 absolute plus 1e-4 relative."""
    import numpy as np
    import torch

    b, h, s, d = 4, 12, 128, 64
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)
                                    * 0.5).to(dev) for _ in range(4))
    keep = torch.from_numpy(np.arange(s)[None, :]
                            < np.array([[128], [100], [64], [33]]))
    km = torch.where(keep, 0.0, -1e9).to(dev, torch.float32)
    grads = []
    for fn in (lambda a, c, e: fa.FlashAttentionFunction.apply(
                   a, c, e, km, False, 0.125),
               lambda a, c, e: fa.flash_attention_plain(
                   a, c, e, km, scale=0.125)[0]):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*ts), ts, do))
    err = max((g - r).abs().max().item() for g, r in zip(*grads))
    ok = all(torch.allclose(g, r, atol=1e-4, rtol=1e-4)
             for g, r in zip(*grads))
    log(f"FlashAttentionFunction on the card vs autograd of the plain "
        f"forward: max abs err {err:.3g} (atol 1e-4 rtol 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the autograd Function's gradients disagree with "
                         "autograd through the plain forward")


# -- phase 4: serving --------------------------------------------------------


def serving_block(mx):
    import torch

    class BertServing(mx.gluon.HybridBlock):
        """Token ids (B, S) -> (sequence, pooled); id 0 is padding."""

        def __init__(self, bert, **kwargs):
            super().__init__(**kwargs)
            self.bert = bert

        def hybrid_forward(self, F, ids):
            valid = (ids != 0).sum(dim=1).to(torch.float32)
            return self.bert(ids, torch.zeros_like(ids), valid)

    return BertServing


def serve_bert(mx, card, attn_ms, tmpdir):
    """Phase 4: BERT-base behind ``ModelServer`` on captured buckets; then
    weights reloaded under the running server.  Returns the flash
    forward's launches over the served and warm-up batches."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _imperative
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    BertServing = serving_block(mx)
    mx.random.seed(0)
    bert = mx.models.bert_base(use_decoder=False, use_classifier=False)
    bert.initialize(init=mx.init.Normal(0.02), ctx=mx.gpu(0))
    net = BertServing(bert)
    eager_net = BertServing(bert)   # not hybridized: the eager forward
    spec = mx.serve.BucketSpec(batch_sizes=(1, 4, 8), example_shape=(None,),
                               lengths=(128, 256, 512), dtype="int32")
    batches = []   # (the requests' examples, the padded batch) per batch
    pad = spec.pad_batch

    def recording_pad(examples, batch, length):
        padded = pad(examples, batch, length)
        batches.append((list(examples), padded))
        return padded

    spec.pad_batch = recording_pad
    rng = np.random.RandomState(1)
    lengths = rng.randint(16, 513, size=SERVE_REQUESTS)
    reqs = [rng.randint(1, 30522, size=int(n)).astype(np.int32)
            for n in lengths]
    results = [None] * SERVE_REQUESTS
    server = mx.serve.ModelServer(net, spec, ctx=mx.gpu(0))

    kernels.reset_counts()
    c0 = _imperative.graph_capture_count()
    r0 = _imperative.graph_replay_count()
    t0 = time.perf_counter()
    server.start()
    t_warm = time.perf_counter() - t0
    captured = _imperative.graph_capture_count() - c0

    def client(idx):
        futs = [(i, server.submit(reqs[i])) for i in idx]
        for i, f in futs:
            results[i] = f.result(timeout=300)

    threads = [threading.Thread(
        target=client, args=(range(c, SERVE_REQUESTS, SERVE_THREADS),))
        for c in range(SERVE_THREADS)]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t1
    launches = fa.counts.launches
    plain_on_cuda = fa.counts.plain_calls_on_cuda
    replays = _imperative.graph_replay_count() - r0

    if any(t.is_alive() for t in threads):
        server.shutdown(drain=False, timeout=120)
        raise SystemExit("serve: client threads did not finish")
    st = server.stats()
    n_buckets = st["warmup_batches"]
    # a bucket's warm-up is one eager forward and one captured one
    n_forwards = st["batches"] + 2 * n_buckets
    log(f"serve: warmup {n_buckets} buckets in {t_warm:.2f}s; "
        f"{st['served']}/{SERVE_REQUESTS} served in {st['batches']} "
        f"batches, {wall:.3f}s wall, {SERVE_REQUESTS / wall:.2f} req/s; "
        f"latency p50 {st['latency']['p50_ms']} ms p99 "
        f"{st['latency']['p99_ms']} ms; bucket hits {st['bucket_hits']} "
        f"on {card}")
    log(f"serve: graph {st['graph']}; CUDA graphs captured {captured} (one "
        f"a bucket), replays {replays} ({st['batches']} batches + "
        f"{n_buckets} at warm-up); flash launches {launches} (12 x "
        f"{n_forwards} forwards = {12 * n_forwards}); plain calls on cuda "
        f"{plain_on_cuda}")
    checks = {
        "served": st["served"] == SERVE_REQUESTS and st["failed"] == 0,
        "post_warmup_compiles": st["graph"]["post_warmup_compiles"] == 0,
        "graphs_captured": captured == n_buckets == 9,
        "replay_a_batch": replays == st["batches"] + n_buckets,
        "launches": launches == 12 * n_forwards,
        "plain_calls_on_cuda": plain_on_cuda == 0,
        "shapes": all(seq.shape == (len(r), 768) and pooled.shape == (768,)
                      and np.isfinite(seq).all() and np.isfinite(pooled).all()
                      for r, (seq, pooled) in zip(reqs, results)),
    }

    def replay_equals_eager(served, answers):
        """Every response of ``served`` (examples, padded batch) against
        the eager forward of its padded batch, bit for bit."""
        same = True
        for examples, padded in served:
            seq, pooled = (o.data for o in eager_net(
                mx.nd.array(padded, ctx=mx.gpu(0))))
            seq, pooled = seq.cpu().numpy(), pooled.cpu().numpy()
            for row, ex in enumerate(examples):
                got = answers[id(ex)]
                same &= (np.array_equal(got[0], seq[row, :len(ex)])
                         and np.array_equal(got[1], pooled[row]))
        return same

    answers = {id(r): res for r, res in zip(reqs, results)}
    checks["replay_equals_eager"] = replay_equals_eager(batches, answers)
    log(f"serve: every response bit-identical to the eager forward of its "
        f"padded batch: {checks['replay_equals_eager']} "
        f"({len(batches)} batches)")

    # the same weights on the CPU (plain attention), three requests
    cpu_bert = mx.models.bert_base(use_decoder=False, use_classifier=False)
    cpu_bert.initialize(ctx=mx.cpu())
    mx.load_numpy_params(cpu_bert, {
        k: p.data().detach().cpu().numpy()
        for k, p in bert._collect_params_with_prefix().items()})
    cpu_net = BertServing(cpu_bert)
    cpu_err = 0.0
    for i in range(3):
        seq, pooled = cpu_net(mx.nd.array(reqs[i][None], ctx=mx.cpu()))
        cpu_err = max(cpu_err,
                      float(np.abs(seq.asnumpy()[0] - results[i][0]).max()),
                      float(np.abs(pooled.asnumpy()[0] - results[i][1]).max()))
    checks["cpu_parity"] = cpu_err <= CPU_ATOL
    log(f"serve: card vs cpu max abs err over 3 responses {cpu_err:.3g} "
        f"(atol {CPU_ATOL})")
    del cpu_net, cpu_bert

    # each bucket's forward, eager and replayed (the hybridized call: the
    # input copied in, the replay, the outputs copied out), by CUDA events
    times = {}
    for b in spec.batch_sizes:
        for n in spec.lengths:
            x = mx.nd.array(pad([r[:n] for r in reqs[:b]], b, n),
                            ctx=mx.gpu(0))
            times[spec.key(b, n)] = (cuda_ms(lambda: eager_net(x), iters=5),
                                     cuda_ms(lambda: net(x), iters=5))
    log(f"serve: forward ms by bucket (eager, replayed) on {card}: "
        + ", ".join(f"{k} {e:.3f}/{r:.3f}" for k, (e, r) in times.items()))
    fwd_ms = times["b8xl512"][0]
    log(f"serve: b8xl512 eager forward {fwd_ms:.3f} ms; 12 flash launches x "
        f"{attn_ms:.4f} ms = {12 * attn_ms / fwd_ms:.1%} of it")

    # other weights loaded into the served block while the server runs: the
    # replays read them, with no new capture
    mx.random.seed(1)
    other = mx.models.bert_base(use_decoder=False, use_classifier=False)
    other.initialize(init=mx.init.Normal(0.02), ctx=mx.gpu(0))
    fname = os.path.join(tmpdir, "bert-base-other.params")
    other = BertServing(other)
    other(mx.nd.array(reqs[0][None], ctx=mx.gpu(0)))  # deferred shapes
    other.save_parameters(fname)
    del other
    c1 = _imperative.graph_capture_count()
    t0 = time.perf_counter()
    net.load_parameters(fname)
    t_load = time.perf_counter() - t0
    first = len(batches)
    later = reqs[3:7]
    fresh = [server.predict(r, timeout=300) for r in later]
    server.shutdown(drain=True, timeout=120)
    st = server.stats()
    reloaded = replay_equals_eager(
        batches[first:], {id(r): res for r, res in zip(later, fresh)})
    changed = not np.array_equal(fresh[0][1], results[3][1])
    checks["reload_seen_by_replays"] = (
        reloaded and changed and len(batches) - first == len(later)
        and _imperative.graph_capture_count() == c1
        and st["graph"]["post_warmup_compiles"] == 0)
    log(f"serve: load_parameters of other weights under the running server "
        f"({os.path.getsize(fname)} bytes, {t_load:.3f} s); the next "
        f"{len(later)} responses bit-identical to the eager forward with "
        f"them: {reloaded}; differ from before: {changed}; new captures "
        f"{_imperative.graph_capture_count() - c1}")
    os.remove(fname)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"serve checks failed: {failed}")
    return {"launches": launches}


# -- phase 5: training -------------------------------------------------------


def pretrain_block(mx, rows=False, groups=None):
    class BERTForPretrain(mx.gluon.HybridBlock):
        """MLM + NSP loss head over the backbone, one scalar loss out
        (after examples/bert/pretrain_bert.py); with ``rows`` one loss a
        row, whose mean is the batch's however it is split over ranks;
        with ``groups`` one loss a run of that many rows, each that run's
        scalar loss."""

        def __init__(self, model, **kwargs):
            super().__init__(**kwargs)
            self.model = model

        def hybrid_forward(self, F, inputs, token_types, mlm_targets,
                           nsp_labels, mask_weight, valid_length,
                           masked_positions):
            mlm_scores, nsp_scores = self.model(inputs, token_types,
                                                valid_length,
                                                masked_positions)
            mlm_log = F.log_softmax(mlm_scores)
            mlm_ll = F.pick(mlm_log, mlm_targets, axis=-1)
            nsp_log = F.log_softmax(nsp_scores)
            if rows:
                return (-F.sum(mlm_ll * mask_weight, axis=-1)
                        / mask_weight.shape[-1]
                        - F.pick(nsp_log, nsp_labels, axis=-1))
            if groups:
                n = inputs.shape[0] // groups
                ll = (mlm_ll * mask_weight).reshape(n, -1).sum(-1)
                w = mask_weight.reshape(n, -1).sum(-1)
                nsp = F.pick(nsp_log, nsp_labels, axis=-1).reshape(n, -1)
                return -ll / (w + 1) - nsp.mean(-1)
            mlm_loss = -F.sum(mlm_ll * mask_weight) / (F.sum(mask_weight) + 1)
            nsp_loss = -F.mean(F.pick(nsp_log, nsp_labels, axis=-1))
            return mlm_loss + nsp_loss

    return BERTForPretrain


def synthetic_batch(rng, bs, seq_len, vocab, mask_frac=0.15):
    """examples/bert/pretrain_bert.py's recipe, with valid lengths drawn
    in [32, seq_len] and padding ids 0, so the key-padding mask reaches
    the attention kernels."""
    import numpy as np

    K = max(1, int(round(seq_len * mask_frac)))
    valid = rng.randint(32, seq_len + 1, bs)
    tokens = rng.randint(4, vocab, (bs, seq_len))
    tokens[np.arange(seq_len)[None, :] >= valid[:, None]] = 0
    types = np.zeros((bs, seq_len), np.int32)
    types[:, seq_len // 2:] = 1
    positions = np.stack([rng.choice(v, K, replace=False)
                          for v in valid]).astype(np.int32)
    targets = np.take_along_axis(tokens, positions, 1)
    inputs = tokens.copy()
    np.put_along_axis(inputs, positions, 3, 1)  # 3 = [MASK]
    weights = np.ones((bs, K), np.float32)
    nsp = rng.randint(0, 2, (bs,))
    return (inputs.astype(np.int32), types, targets.astype(np.int32),
            nsp.astype(np.int32), weights, valid.astype(np.float32),
            positions)


def pretrain_net(mx, ctx, dropout, seed=0, rows=False, groups=None):
    mx.random.seed(seed)
    net = pretrain_block(mx, rows, groups)(mx.models.bert_base(
        use_decoder=True, use_classifier=True, dropout=dropout))
    net.initialize(init=mx.init.Normal(0.02), ctx=ctx)
    return net


def train_step(mx, net, trainer, batch):
    with mx.autograd.record():
        loss = net(*batch)
    loss.backward()
    trainer.step(1)
    return loss


def train_bert(mx, card, attn_ms, profile=False):
    """20 AdamW steps of BERT-base MLM+NSP at b=32, s=128 on the card;
    then card vs CPU at b=4 with dropout 0.  Returns the launch counts."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    gpu = mx.gpu(0)
    net = pretrain_net(mx, gpu, dropout=0.1)
    data = synthetic_batch(np.random.RandomState(3), TRAIN_BATCH, TRAIN_SEQ,
                           30522)
    batch = [mx.nd.array(a, ctx=gpu) for a in data]
    trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01})
    params = net.collect_params()
    losses, step_ms, missing = [], [], []

    kernels.reset_counts()
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = net(*batch)
        loss.backward()
        if step == 0:  # the gradient the card used to lose
            for name, p in params.items():
                g = p.data().grad
                if p.grad_req != "null" and (
                        g is None or not bool(torch.isfinite(g).all())):
                    missing.append(name)
        trainer.step(1)
        losses.append(loss.asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 3:
            after4 = [p.data().detach().clone() for p in params.values()]
    counts = {name: c.launches for name, c in kernels.KERNEL_COUNTS.items()
              if name.startswith("flash_attention")}
    plain_on_cuda = fa.counts.plain_calls_on_cuda

    median_ms = statistics.median(step_ms[2:])
    eager_record("bert", losses, after4, counts_now(), TRAIN_STEPS,
                 median_ms)
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3)
    n = TRAIN_STEPS
    log(f"train: BERT-base MLM+NSP b={TRAIN_BATCH} s={TRAIN_SEQ} fp32 "
        f"AdamW, {n} steps; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"step median {median_ms:.3f} ms over steps 3-{n} (first "
        f"{step_ms[0]:.1f} ms), {tokens_s:.0f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    log(f"train: losses {[round(x, 4) for x in losses]}")
    log(f"train: launches {counts} (12 x {n} = {12 * n} each); plain calls "
        f"on cuda {plain_on_cuda}; attention kernels at this shape (fwd "
        f"{attn_ms['fwd_ms']:.4f} + dQ {attn_ms['dq']['ms']:.4f} + dK/dV "
        f"{attn_ms['dkv']['ms']:.4f} ms) x 12 = "
        f"{12 * (attn_ms['fwd_ms'] + attn_ms['dq']['ms'] + attn_ms['dkv']['ms']) / median_ms:.1%}"
        f" of the median step")
    checks = {
        "finite_losses": all(np.isfinite(losses)),
        "loss_falls": losses[-1] < losses[0],
        "first_backward_gradients": not missing,
        "launches": all(c == 12 * n for c in counts.values()),
        "plain_calls_on_cuda": plain_on_cuda == 0,
    }
    if missing:
        log(f"train: parameters without a finite gradient after the first "
            f"backward: {missing}")
    if profile:
        profile_steps(lambda: [train_step(mx, net, trainer, batch)
                               for _ in range(2)],
                      "train_profile.txt", "train")
    del net, trainer, batch
    torch.cuda.empty_cache()
    checks.update(train_card_vs_cpu(mx, data))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"train checks failed: {failed}")
    return counts


def train_card_vs_cpu(mx, data):
    """Two AdamW steps at b=4 with dropout 0 on the card and on the CPU from
    the same initial weights: the losses and layer 0's attn_in_weight
    gradient after the first backward must agree."""
    import numpy as np

    out = []
    weights = None
    small = [a[:4] for a in data]
    for ctx in (mx.gpu(0), mx.cpu()):
        net = pretrain_net(mx, ctx, dropout=0.0)
        batch = [mx.nd.array(a, ctx=ctx) for a in small]
        if weights is None:
            with mx.autograd.pause():
                net(*batch)  # completes the deferred shapes
            weights = {k: p.data().detach().cpu().numpy().copy()
                       for k, p in net._collect_params_with_prefix().items()}
        else:
            mx.load_numpy_params(net, weights)
        trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                                   {"learning_rate": 1e-4, "wd": 0.01})
        losses = []
        for step in range(2):
            losses.append(train_step(mx, net, trainer, batch).asscalar())
            if step == 0:
                p = net._collect_params_with_prefix()[
                    "model.encoder.layers.0.attn_in_weight"]
                grad = p.grad().detach().cpu().numpy().copy()
        out.append((losses, grad))
    (gl, gg), (cl, cg) = out
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    grad_err = float(np.abs(gg - cg).max() / np.abs(cg).max())
    log(f"train: card vs cpu, b=4 s={TRAIN_SEQ} dropout 0, 2 AdamW steps: "
        f"losses card {gl} cpu {cl}, max rel err {loss_err:.3g} (rtol "
        f"{TRAIN_LOSS_RTOL}); layer 0 attn_in_weight gradient max abs err "
        f"/ max |grad| {grad_err:.3g} (rtol {TRAIN_GRAD_RTOL})")
    return {"card_vs_cpu_loss": loss_err <= TRAIN_LOSS_RTOL,
            "card_vs_cpu_grad": grad_err <= TRAIN_GRAD_RTOL}


def profile_steps(run_two_steps, filename, title):
    """A torch.profiler table of ``run_two_steps()`` by CUDA time, into
    chiprun_out/<filename>; its top rows are printed.  Returns the device
    time (us) by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tprofile(activities=acts) as prof:
        run_two_steps()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=60)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / filename).write_text(table)
    log(f"{title} profile (2 steps, by CUDA time):")
    log("\n".join(table.splitlines()[:28]))
    return kernel_times(averages)


def kernel_times(averages):
    """Device time (us) by kernel name from a profiler's key averages: the
    entries that ran on the card (kernels, copies, fills)."""
    from torch.autograd import DeviceType

    out = {}
    for e in averages:
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            out[e.key] = e.self_cuda_time_total if t is None else t
    return out


@contextlib.contextmanager
def simple_route(kcf):
    """Within the block the fused 1x1 kernels' route rule (``kcf.route``)
    picks the simple route, PR 3's template, for every launch."""
    rule = kcf.route
    kcf.route = lambda *args: "simple"
    try:
        yield
    finally:
        kcf.route = rule


def device_ms(fn, iters, tags, attempts=3):
    """Mean device time (ms) a call of ``fn`` spends in the kernels whose
    names hold one of ``tags``, from torch.profiler over ``iters`` calls
    after one warm call: the kernels alone, without the host's time
    between launches.  On the H100 torch.profiler has now and then left a
    launch, or every launch of a session, unrecorded (PERF.md §6): a
    session in which no tagged kernel was recorded, or one's launches are
    not a whole number a call, is logged and taken again, up to
    ``attempts`` sessions.  Each kernel's time counts as its mean over the
    launches recorded times its launches a call (the recorded count over
    ``iters``, rounded), so a launch left out of the last session does not
    count as 0."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        launches = {e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and any(tag in e.key for tag in tags)}
        if launches and all(c % iters == 0 for c in launches.values()):
            break
        log(f"  device_ms: torch.profiler session {attempt} of {attempts} "
            f"recorded {launches or 'no launches'} of {tags} over {iters} "
            f"calls; " + ("taken again" if attempt < attempts
                          else "counted over the launches recorded"))
    times = kernel_times(prof.key_averages())
    return sum(times[k] / n * max(1, round(n / iters))
               for k, n in launches.items()) / 1e3


# -- phase 6: the ResNet kernels ----------------------------------------------


def resnet_kernel_shapes():
    """The (M, K, N) each fused kernel gets from ResNet-50 v1 (stride on
    conv1): in training at batch 128, 224^2 (stage sizes 56, 28, 14, 7;
    3, 4, 6, 3 bottlenecks), conv1 and downsample through
    ``matmul_bn_stats``, conv3 through ``bn_act_matmul_stats``, bn2's C
    through ``bn_stats``; in predict mode at batch 64, conv3 through
    ``bn_act_matmul``.  ``per_step`` maps (kernel, (M, K, N)) to its
    launches in one training step (20 and 16 in all)."""
    per_step, act, stats = {}, [], []
    for i, (width, s, blocks) in enumerate(zip((64, 128, 256, 512),
                                               (56, 28, 14, 7),
                                               (3, 4, 6, 3))):
        m = RESNET_BATCH * s * s
        cin = 64 if i == 0 else 2 * width
        for key, n in ((("matmul_bn_stats", (m, cin, width)), 1),
                       (("matmul_bn_stats", (m, cin, 4 * width)), 1),
                       (("matmul_bn_stats", (m, 4 * width, width)),
                        blocks - 1),
                       (("bn_act_matmul_stats", (m, width, 4 * width)),
                        blocks)):
            per_step[key] = per_step.get(key, 0) + n
        act.append((PREDICT_BATCH * s * s, width, 4 * width))
        stats.append((m, width))
    mm = sorted(shape for kind, shape in per_step if kind == "matmul_bn_stats")
    act_stats = [shape for kind, shape in per_step
                 if kind == "bn_act_matmul_stats"]
    return mm, act_stats, act, stats, per_step


def gemm_bound(m, k, n, dtype, prologue, stats, rate=None):
    """Least time (ms): x, w read once, y written once (plus scale and
    shift read, the fp32 sums written); 2*M*K*N operations at ``rate``
    (default the dtype's peak: for fp32 the CUDA cores'; TF32X3_FLOPS for
    the fp32 products of the TF32 route)."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = ((m * k + k * n + m * n) * item + (2 * k * 4 if prologue else 0)
              + (2 * n * 4 if stats else 0))
    return least_ms(nbytes, 2.0 * m * k * n, dtype, rate)


def check_stats(got, y):
    """``got``, a kernel's column sums of ``y`` and of its squares, where
    ``y`` is what the kernel stored (or read): against fp64 sums of the
    same values, within 1e-5 of the sum of magnitudes (fp32 sums in the
    kernel's order) plus 1e-5, in bf16 as in fp32.  Returns the largest
    error relative to the column's sum of magnitudes, and whether every
    column holds."""
    yd = y.double()
    worst, ok = 0.0, True
    for g, r, mag in zip(got, (yd.sum(dim=0), (yd * yd).sum(dim=0)),
                         (yd.abs().sum(dim=0), (yd * yd).sum(dim=0))):
        err = (g.reshape(-1).double() - r).abs()
        worst = max(worst, (err / mag.clamp_min(1e-30)).max().item())
        ok = ok and bool((err <= 1e-5 * mag + 1e-5).all())
    return worst, ok


def check_resnet_kernels(dev):
    """Rows 7-10 of the kernel table against their plain versions at the
    ResNet-50 shapes on ``dev``; returns each kernel's record at its main
    shape (stage 1: bf16 in training, fp32 in predict mode).  At each bf16
    training shape the fused kernels' two routes are timed side by side
    (CUDA events around back-to-back calls, and the kernels' own device
    time from torch.profiler) and held against each other; the fused
    forward of one training step is summed from them, old route against
    new."""
    import torch

    from mxnet_tpu_torch.ops.kernels import batch_norm as kbn
    from mxnet_tpu_torch.ops.kernels import conv_fused as kcf

    gen = torch.Generator(device=dev).manual_seed(0)
    mm, act_stats, act, stats, per_step = resnet_kernel_shapes()
    routes = {}  # (kernel, shape) -> times of both routes, bf16 training
    predict = {}  # shape -> times of fp32 bn_act_matmul with ReLU
    # each kernel's record: stage 1, in the dtype of its main path
    main_case = {"bn_stats": (stats[0], "bfloat16", False),
                 "matmul_bn_stats": ((RESNET_BATCH * 56 * 56, 256, 64),
                                     "bfloat16", False),
                 "bn_act_matmul_stats": (act_stats[0], "bfloat16", True),
                 "bn_act_matmul": (act[0], "float32", True)}
    main = {}
    log(f"resnet kernels: kernel vs plain (y atol/rtol fp32 "
        f"{FUSED_TOL['float32']}, bf16 {FUSED_TOL['bfloat16']}; sums within "
        f"1e-5 of their magnitudes of fp64 sums of the stored y, or of x for "
        f"bn_stats; err is y's, or the sums' for bn_stats); library = "
        f"torch.matmul at the same shape (the product alone) or "
        f"torch.var_mean")

    def rand(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.rand(*shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    def record(name, key, err, ok, kern, plain, lib, bound, label,
               stats_err=None, extra=None):
        sums = "" if stats_err is None else f" sums_rel={stats_err:.3g}"
        more = "".join(f" {k}={v:.1f}us" if k.endswith("_us")
                       else f" {k}={v:.4f}ms" for k, v in (extra or {}).items())
        log(f"  {name:20s} {label} err={err:.3g}{sums} kernel={kern:.4f}ms"
            f"{more} plain={plain:.4f}ms library={lib:.4f}ms "
            f"bound={bound[0]:.4f}ms ({', '.join(bound[1:])})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} kernel disagrees with its plain "
                             f"version: {label}")
        if key:
            main[name] = {"max_abs_err": err, "ms": kern, "plain_ms": plain,
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "library_ms": lib, "shape": label, **(extra or {})}

    bn_stages = []  # row 7 at each stage and dtype
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for (m, c), n_step in zip(stats, (3, 4, 6, 3)):
            x = rand(m, c, dtype=dt, shift=-0.3)
            got, ref = kbn.bn_stats_fwd(x), kbn.bn_stats_plain(x)
            err = max((g - r).abs().max().item() for g, r in zip(got, ref))
            serr, ok = check_stats(got, x)
            ok = ok and check_stats(ref, x)[1]
            again = kbn.bn_stats_fwd(x)
            ok = ok and all(torch.equal(a, b) for a, b in zip(got, again))
            bound = least_ms(m * c * x.element_size() + 2 * c * 4,
                             3.0 * m * c, "float32")
            extra = {"device_ms": device_ms(lambda: kbn.bn_stats_fwd(x), 10,
                                            ("bn_stats_kernel",)),
                     "host_us": host_us(lambda: kbn.bn_stats_fwd(x))}
            kern = cuda_ms(lambda: kbn.bn_stats_fwd(x), 10)
            plain = cuda_ms(lambda: kbn.bn_stats_plain(x), 3)
            lib = cuda_ms(lambda: torch.var_mean(x, dim=0, correction=0), 10)
            label = f"M={m} C={c} {dtype}"
            record("bn_stats",
                   main_case["bn_stats"] == ((m, c), dtype, False), err, ok,
                   kern, plain, lib, bound, label, serr, extra)
            bn_stages.append(dict(shape=label, max_abs_err=err, ms=kern,
                                  plain_ms=plain, bound_ms=bound[0],
                                  library_ms=lib, launches_per_step=n_step,
                                  **extra))
            del x, got, ref, again
        cases = [("matmul_bn_stats", shape, False) for shape in mm]
        cases += [("bn_act_matmul_stats", shape, relu)
                  for shape in act_stats for relu in (True, False)]
        cases += [("bn_act_matmul", shape, relu)
                  for shape in act for relu in (True, False)]
        for name, (m, k, n), relu in cases:
            x = rand(m, k, dtype=dt, shift=-0.5)
            # w as the main path hands it over: a (Cout, Cin) weight's
            # transpose, so the kernels take it without a copy
            w = rand(n, k, dtype=dt, scale=2.0 / k ** 0.5,
                     shift=-1.0 / k ** 0.5).t()
            prologue = name != "matmul_bn_stats"
            args = ((x, rand(1, k, shift=0.5), rand(1, k, shift=-0.5), w, relu)
                    if prologue else (x, w))
            fwd = getattr(kcf, f"{name}_fwd")
            plain = getattr(kcf, f"{name}_plain")
            got, ref = fwd(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            torch.cuda.synchronize()
            atol, rtol = FUSED_TOL[dtype]
            err = (got[0].float() - ref[0].float()).abs().max().item()
            ok = bool(torch.isfinite(got[0]).all()) and torch.allclose(
                got[0].float(), ref[0].float(), atol=atol, rtol=rtol)
            serr = None
            if len(got) == 3:
                serr, sok = check_stats(got[1:], got[0])
                ok = ok and sok
            extra = None
            tf32 = dtype == "float32" and name == "bn_act_matmul"
            if tf32:  # the TF32 route, held against the simple route
                c = kcf.bn_act_matmul_counts
                before = c.tf32_launches
                fwd(*args)
                ok = ok and c.tf32_launches == before + 1
                with simple_route(kcf):
                    simple = fwd(*args)
                    extra = {"simple_ms": cuda_ms(lambda: fwd(*args), 5)}
                ok = ok and torch.allclose(got[0], simple, atol=atol,
                                           rtol=rtol)
                extra["cuda_core_bound_ms"] = gemm_bound(m, k, n, dtype,
                                                         True, False)[0]
                del simple
            if (dtype == "bfloat16" and (name, (m, k, n)) in per_step
                    and relu == prologue):  # the training step's call
                extra = {"device_ms": device_ms(lambda: fwd(*args), 10,
                                                ("tma_mm_kernel",
                                                 "stats_reduce_kernel"))}
                with simple_route(kcf):
                    simple = fwd(*args)
                    extra["simple_ms"] = cuda_ms(lambda: fwd(*args), 5)
                    extra["simple_device_ms"] = device_ms(
                        lambda: fwd(*args), 3,
                        ("fused_mm_kernel", "stats_reduce_kernel"))
                ok = ok and torch.allclose(got[0].float(), simple[0].float(),
                                           atol=atol, rtol=rtol)
                ok = ok and check_stats(simple[1:], simple[0])[1]
                del simple
            del got, ref
            kern = cuda_ms(lambda: fwd(*args), 10)
            lib = cuda_ms(lambda: torch.matmul(x, w), 10)
            bound = gemm_bound(m, k, n, dtype, prologue,
                               name.endswith("stats"),
                               TF32X3_FLOPS if tf32 else None)
            record(name, main_case[name] == ((m, k, n), dtype, relu), err, ok,
                   kern, cuda_ms(lambda: plain(*args), 3), lib,
                   bound + ("3xTF32",) * tf32,
                   f"M={m} K={k} N={n} {dtype} relu={relu}", serr, extra)
            if tf32:
                if relu:  # the predict forward's call
                    predict[(m, k, n)] = dict(extra, ms=kern, library_ms=lib,
                                              bound_ms=bound[0])
            elif extra:
                routes[(name, (m, k, n))] = dict(extra, ms=kern)
            del x, w, args
        torch.cuda.empty_cache()
    main["bn_stats"]["stages"] = bn_stages
    step_routes(routes, per_step)
    predict_routes(predict)
    check_fused_function_gradients(kbn, kcf, dev)
    return main


def predict_routes(predict):
    """fp32 ``bn_act_matmul`` at the four shapes of ResNet-50's predict
    forward (b=64): the TF32 route against ``torch.matmul`` (the product
    alone) and the simple route, each shape and the forward's 16 launches
    (3, 4, 6, 3 a stage); printed, not gated."""
    log("resnet kernels: fp32 bn_act_matmul (ReLU) at the predict forward's "
        "shapes, TF32 route against torch.matmul and the simple route "
        "(events around back-to-back calls):")
    total = dict.fromkeys(("ms", "library_ms", "simple_ms", "bound_ms"), 0.0)
    for (m, k, n), t in sorted(predict.items(), key=lambda kv: -kv[0][0]):
        count = {64: 3, 128: 4, 256: 6, 512: 3}[k]
        for key in total:
            total[key] += t[key] * count
        log(f"  M={m} K={k} N={n} x{count}: tf32 {t['ms']:.4f} ms, "
            f"torch.matmul {t['library_ms']:.4f} "
            f"({'at or below' if t['ms'] <= t['library_ms'] else 'ABOVE'}), "
            f"simple {t['simple_ms']:.4f}, bound {t['bound_ms']:.4f} "
            f"(3xTF32) / {t['cuda_core_bound_ms']:.4f} (CUDA cores)")
    log(f"  one predict forward, 16 launches: tf32 {total['ms']:.4f} ms, "
        f"torch.matmul {total['library_ms']:.4f}, simple "
        f"{total['simple_ms']:.4f}, bound {total['bound_ms']:.4f}")


def step_routes(routes, per_step):
    """The fused forward of one bf16 training step, each shape's time x its
    launches per step, on the TMA route against the simple route; fails
    where the TMA route's kernels take longer than the simple route's.
    Where torch.profiler recorded no launch of a route in any session
    (its device time reads 0, see :func:`device_ms`), that shape's two
    routes are compared by their event times instead, and the log says
    so."""
    log("resnet kernels: the fused 1x1 forward of one bf16 training step "
        "(time x launches a step; events around back-to-back calls, device = "
        "the kernels' own time), TMA route against the simple route:")
    total = dict.fromkeys(("ms", "device_ms", "simple_ms",
                           "simple_device_ms"), 0.0)
    slower = []
    for (name, (m, k, n)), t in sorted(routes.items(),
                                       key=lambda kv: -kv[0][1][0]):
        count = per_step[(name, (m, k, n))]
        for key in total:
            total[key] += t[key] * count
        timed = t["device_ms"] > 0 and t["simple_device_ms"] > 0
        log(f"  {name:20s} M={m} K={k} N={n} x{count}: tma {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}), simple {t['simple_ms']:.4f} ms "
            f"(device {t['simple_device_ms']:.4f})" + ("" if timed else
            "; the profiler recorded no launch of a route: event times "
            "compared"))
        if (t["device_ms"] > t["simple_device_ms"] if timed
                else t["ms"] > t["simple_ms"]):
            slower.append((name, (m, k, n)))
    log(f"  one step, {sum(per_step.values())} launches: tma "
        f"{total['ms']:.4f} ms (device {total['device_ms']:.4f}), simple "
        f"{total['simple_ms']:.4f} ms (device "
        f"{total['simple_device_ms']:.4f})")
    if len(routes) != len(per_step) or slower:
        raise SystemExit(f"the TMA route is slower than the simple route at "
                         f"{slower}, or a training shape went untimed")


def check_fused_function_gradients(kbn, kcf, dev):
    """The four autograd Functions on the card (kernel forwards, plain
    backwards) against torch.autograd through the plain forwards, fp32 at
    a stage-4 shape: within 1e-4 absolute plus 1e-4 relative of each
    gradient's largest magnitude."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)
    m, k, n = 6272, 512, 256
    x = torch.rand(m, k, generator=gen, device=dev) - 0.5
    w = (torch.rand(k, n, generator=gen, device=dev) - 0.5) * 0.1
    sc = torch.rand(1, k, generator=gen, device=dev) + 0.5
    sh = torch.rand(1, k, generator=gen, device=dev) - 0.5
    cot = [torch.randn(m, n, generator=gen, device=dev),
           torch.randn(1, n, generator=gen, device=dev),
           torch.randn(1, n, generator=gen, device=dev) * 0.01]
    ccot = [torch.randn(k, generator=gen, device=dev) for _ in range(2)]

    def grads(fn, args, cots):
        ts = [a.clone().requires_grad_(True) for a in args]
        outs = fn(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(
            sum((o.float() * c).sum() for o, c in zip(outs, cots)), ts)

    cases = [
        ("matmul_bn_stats", kcf.matmul_bn_stats, kcf.matmul_bn_stats_plain,
         (x, w), cot),
        ("bn_act_matmul", lambda *a: kcf.bn_act_matmul(*a, True),
         lambda *a: kcf.bn_act_matmul_plain(*a, True), (x, sc, sh, w), cot),
        ("bn_act_matmul_stats", lambda *a: kcf.bn_act_matmul_stats(*a, True),
         lambda *a: kcf.bn_act_matmul_stats_plain(*a, True),
         (x, sc, sh, w), cot),
        ("bn_stats", kbn.bn_stats, kbn.bn_stats_plain, (x,), ccot)]
    worst, ok = 0.0, True
    for name, fn, plain, args, cots in cases:
        for g, r in zip(grads(fn, args, cots), grads(plain, args, cots)):
            scale = r.abs().max().item()
            worst = max(worst, (g - r).abs().max().item() / max(scale, 1e-30))
            ok = ok and bool(((g - r).abs() <= 1e-4 * scale
                              + 1e-4 * r.abs()).all())
    log(f"resnet kernels: autograd Functions on the card vs autograd of the "
        f"plain forwards, M={m} K={k} N={n} fp32: max err / max |grad| "
        f"{worst:.3g} (atol 1e-4 of the largest, rtol 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fused kernels' autograd Functions disagree "
                         "with autograd through the plain forwards")


# -- phases 7-9: ResNet-50 ----------------------------------------------------


def resnet50(mx, ctx, fuse):
    """ResNet-50 v1, NHWC, 1000 classes, Xavier from seed 0 (deferred
    shapes); ``fuse`` sets MXTPU_CONV_EPILOGUE, which the bottlenecks read
    when they are built."""
    os.environ["MXTPU_CONV_EPILOGUE"] = "pallas" if fuse else ""
    mx.random.seed(0)
    net = mx.gluon.model_zoo.vision.resnet50_v1(layout="NHWC", classes=1000)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def resnet_trainer(mx, net, compute_dtype=None, capture=False, mesh=None):
    """train_imagenet.py's optimizer settings; the step eager unless
    ``capture``."""
    return mx.parallel.DataParallelTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        compute_dtype=compute_dtype, capture=capture, mesh=mesh)


def synthetic_images(rng, batch, image):
    x = rng.rand(batch, image, image, 3).astype("float32")
    y = rng.randint(0, 1000, batch).astype("float32")
    return x, y


def train_resnet(mx, card, profile=False):
    """20 bf16 steps of fused ResNet-50 through DataParallelTrainer at
    b=128, 224^2; then predict mode at b=64.  Returns the launch counts of
    both runs."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels

    gpu = mx.gpu(0)
    net = resnet50(mx, gpu, fuse=True)
    x, y = synthetic_images(np.random.RandomState(0), RESNET_BATCH,
                            RESNET_IMAGE)
    xg, yg = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    trainer = resnet_trainer(mx, net, compute_dtype="bfloat16")
    trainer.build(xg)  # deferred shapes: one predict-mode probe
    start = [p.detach().clone() for p in trainer._params]
    names = [n for n, _ in trainer._named]
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []

    kernels.reset_counts()
    for i in range(RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(xg, yg)
        losses.append(loss.asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 3:
            after4 = [p.detach().clone() for p in trainer._params]
    counts = {k: (c.launches, c.plain_calls_on_cuda)
              for k, c in kernels.KERNEL_COUNTS.items()}
    eager_record("resnet", losses, after4, counts_now(), RESNET_STEPS,
                 statistics.median(step_ms[2:]))
    EAGER_RUNS["resnet"]["start"] = start
    fused = ("matmul_bn_stats", "bn_act_matmul_stats")
    simple = {k: kernels.KERNEL_COUNTS[k].simple_launches for k in fused}
    scalar = kernels.KERNEL_COUNTS["bn_stats"].scalar_launches

    n = RESNET_STEPS
    median_ms = statistics.median(step_ms[2:])
    log(f"resnet train: ResNet-50 v1 NHWC fused, b={RESNET_BATCH} "
        f"{RESNET_IMAGE}^2, bf16 compute, SGD momentum, {n} steps; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step median {median_ms:.3f} "
        f"ms over steps 3-{n} (first {step_ms[0]:.1f} ms), "
        f"{RESNET_BATCH / (median_ms / 1e3):.1f} images/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    log(f"resnet train: losses {[round(v, 4) for v in losses]}; mean of "
        f"the last 5 {statistics.mean(losses[-5:]):.4f}")
    log(f"resnet train: (launches, plain calls on cuda) {counts}; "
        f"launches on the simple route {simple}; bn_stats launches on its "
        f"scalar route {scalar}")
    unchanged, bad, still = [], [], []
    for name, p0, p1, tr in zip(names, start, trainer._params,
                                trainer._trainable):
        if not bool(torch.isfinite(p1).all()):
            bad.append(name)
        if tr and torch.equal(p0, p1):
            unchanged.append(name)
        if "running" in name and torch.equal(p0, p1):
            still.append(name)
    expect = {"matmul_bn_stats": 20 * n, "bn_stats": 16 * n,
              "bn_act_matmul_stats": 16 * n}
    checks = {
        "launches": all(counts[k][0] == v for k, v in expect.items()),
        # every fused launch of the bf16 step on the TMA route
        "tma_route": all(v == 0 for v in simple.values()),
        # every bn_stats launch with 16-byte loads
        "bn_stats_vector_loads": scalar == 0,
        "plain_calls_on_cuda": all(c[1] == 0 for c in counts.values()),
        "finite_losses": all(np.isfinite(losses)),
        # at lr 0.1 the loss on one batch swings from step to step and,
        # after about 8 steps, its path depends on the rounding of every
        # sum (runs that differ only in the fused kernels' summation order
        # part there): the first two updates must each leave it below the
        # first loss, and the first steps must track the simple route's
        # (route_gap below)
        "loss_falls": max(losses[1:3]) < losses[0],
        "parameters_change": not unchanged,
        "parameters_finite": not bad,
        "running_stats_move": not still,
    }
    if unchanged or bad or still:
        log(f"resnet train: unchanged {unchanged[:5]}, non-finite "
            f"{bad[:5]}, running stats that did not move {still[:5]}")
    if profile:
        times = profile_steps(lambda: [trainer.step(xg, yg)
                                       for _ in range(2)],
                              "resnet_profile.txt", "resnet train")
        busy = sum(times.values())
        shares = {tag: sum(t for k, t in times.items() if tag in k) / busy
                  for tag in ("tma_mm_kernel", "fused_mm_kernel",
                              "stats_reduce_kernel", "bn_stats_kernel")}
        log(f"resnet train: device time of 2 profiled steps {busy / 1e3:.3f} "
            f"ms; shares: fused 1x1 kernels, TMA route "
            f"{shares['tma_mm_kernel']:.1%}, simple route "
            f"{shares['fused_mm_kernel']:.1%}; their stats_reduce_kernel "
            f"{shares['stats_reduce_kernel']:.1%}; bn_stats_kernel "
            f"{shares['bn_stats_kernel']:.1%}")

    checks.update(resnet_route_gap(mx, start, xg, yg, losses))

    # predict mode on the trained weights, b=64, fp32
    trainer.sync_to_block()
    del trainer
    torch.cuda.empty_cache()
    xp = xg[:PREDICT_BATCH].contiguous()
    reps = 5

    def forwards():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = net(xp)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / reps

    # eager (the block not hybridized), then the hybridized block's graph:
    # a warm-up and a capture, then replays, whose launches are counted
    net.hybridize(False)
    net(xp)  # warm
    _, eager_ms = forwards()
    net.hybridize()
    net(xp)
    net(xp)
    torch.cuda.synchronize()
    kernels.reset_counts()
    out, fwd_ms = forwards()
    pcounts = {k: (c.launches, c.plain_calls_on_cuda)
               for k, c in kernels.KERNEL_COUNTS.items()}
    log(f"resnet predict: b={PREDICT_BATCH} fp32 forward, replayed "
        f"{fwd_ms:.3f} ms, {PREDICT_BATCH / (fwd_ms / 1e3):.1f} images/s "
        f"(eager {eager_ms:.3f} ms); (launches, plain calls on cuda) of the "
        f"replays {pcounts}")
    checks["predict_launches"] = pcounts["bn_act_matmul"][0] == 16 * reps
    # every fp32 bn_act_matmul of the forward on the TF32 route
    bam = kernels.KERNEL_COUNTS["bn_act_matmul"]
    log(f"resnet predict: bn_act_matmul launches on the TF32 route "
        f"{bam.tf32_launches}, on the simple route {bam.simple_launches}")
    checks["predict_tf32_route"] = (bam.simple_launches == 0
                                    and bam.tf32_launches == 16 * reps)
    checks["predict_plain_calls_on_cuda"] = all(
        c[1] == 0 for c in pcounts.values())
    checks["predict_output"] = tuple(out.shape) == (PREDICT_BATCH, 1000) \
        and bool(torch.isfinite(out.data).all())
    del net, xg, yg, xp, out
    torch.cuda.empty_cache()
    checks.update(resnet_references(mx))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"resnet checks failed: {failed}")
    return ({k: counts[k][0] for k in expect},
            pcounts["bn_act_matmul"][0])


def resnet_route_gap(mx, start, xg, yg, losses):
    """The first steps of the bf16 training run again from its starting
    weights ``start``, with the fused 1x1 kernels pinned to the simple
    route; the training run's ``losses`` (TMA route) must stay within
    RESNET_ROUTE_RTOL of these, step by step."""
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import conv_fused as kcf

    trainer = resnet_trainer(mx, resnet50(mx, mx.gpu(0), fuse=True),
                             compute_dtype="bfloat16")
    trainer.build(xg)
    with torch.no_grad():
        for p, p0 in zip(trainer._params, start):
            p.copy_(p0)
    n = len(RESNET_ROUTE_RTOL)
    kernels.reset_counts()
    with simple_route(kcf):
        simple = [trainer.step(xg, yg).asscalar() for _ in range(n)]
    fused = ("matmul_bn_stats", "bn_act_matmul_stats")
    pinned = all(kernels.KERNEL_COUNTS[k].simple_launches
                 == kernels.KERNEL_COUNTS[k].launches > 0 for k in fused)
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, simple)]
    log(f"resnet train: the first {n} losses on the TMA route "
        f"{losses[:n]} against the simple route's {simple} from the same "
        f"weights: relative gaps {[f'{g:.3g}' for g in gaps]}, limits "
        f"{list(RESNET_ROUTE_RTOL)}; every fused launch of the simple run "
        f"on the simple route: {pinned}")
    del trainer
    torch.cuda.empty_cache()
    return {"route_gap": all(g <= t for g, t in zip(gaps, RESNET_ROUTE_RTOL)),
            "route_gap_pinned": pinned}


def resnet_references(mx):
    """Two fp32 steps at b=8, 112^2 (TF32 off) from the same weights: the
    fused net on the card, on the CPU, and the standard net on the card.
    Their losses and the first step's updates of the classifier, the last
    bottleneck's conv3 weight and the first bottleneck's conv1 weight must
    agree.  The fused net on the card with its input moved by one ulp up
    and down gives the gaps that rounding alone makes (the floor), as a
    reading."""
    import numpy as np

    x, y = synthetic_images(np.random.RandomState(1), 8, 112)
    keys = {"fc": RESNET_FC_KEY, "top": RESNET_TOP_KEY,
            "deep": RESNET_DEEP_KEY}
    runs, weights = {}, None
    for label, ctx, fuse, xin in (
            ("fused card", mx.gpu(0), True, x),
            ("fused card, input +1 ulp", mx.gpu(0), True,
             np.nextafter(x, np.float32(2))),
            ("fused card, input -1 ulp", mx.gpu(0), True,
             np.nextafter(x, np.float32(-1))),
            ("fused cpu", mx.cpu(), True, x),
            ("standard card", mx.gpu(0), False, x)):
        net = resnet50(mx, ctx, fuse)
        trainer = resnet_trainer(mx, net)
        if weights is None:
            trainer.build(mx.nd.array(xin, ctx=ctx))
            weights = {k: p.data().detach().cpu().numpy().copy() for k, p in
                       net._collect_params_with_prefix().items()}
        else:
            mx.load_numpy_params(net, weights)
        xa, ya = mx.nd.array(xin, ctx=ctx), mx.nd.array(y, ctx=ctx)
        losses = [trainer.step(xa, ya).asscalar()]
        trainer.sync_to_block()
        params = net._collect_params_with_prefix()
        updates = {w: params[k].data().detach().cpu().numpy() - weights[k]
                   for w, k in keys.items()}
        losses.append(trainer.step(xa, ya).asscalar())
        runs[label] = (losses, updates)
        del net, trainer
    (ref1, ref2), ref_upd = runs["fused card"]
    limits = {"loss1": RESNET_LOSS1_RTOL, "fc": RESNET_FC_UPDATE_RTOL,
              "top": RESNET_TOP_UPDATE_RTOL, "deep": RESNET_UPDATE_RTOL,
              "loss2": RESNET_LOSS2_RTOL}
    log(f"resnet reference: b=8 112^2 fp32, 2 steps; gaps to the fused card "
        f"run, relative: loss1, loss2, and the step-1 update (L2) of "
        f"{RESNET_FC_KEY} (fc), {RESNET_TOP_KEY} (top) and "
        f"{RESNET_DEEP_KEY} (deep); limits "
        f"{limits} (the ulp runs are the floor, not checked)")
    checks = {}
    for label, ((l1, l2), upd) in runs.items():
        if label == "fused card":
            continue
        gaps = {"loss1": abs(ref1 - l1) / abs(l1),
                "fc": 0.0, "top": 0.0, "deep": 0.0,
                "loss2": abs(ref2 - l2) / abs(l2)}
        for w in keys:
            gaps[w] = float(np.linalg.norm(ref_upd[w] - upd[w])
                            / np.linalg.norm(upd[w]))
        log(f"resnet reference: fused card vs {label}: losses "
            f"{[ref1, ref2]} vs {[l1, l2]}; gaps "
            + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
        if "ulp" in label:
            continue
        slug = label.replace(" ", "_")
        for k, v in gaps.items():
            checks[f"{slug}_{k}"] = v <= limits[k]
    return checks


# -- phase 10: the RNN kernels ------------------------------------------------


def rnn_kernel_shapes():
    """(label, T, N, H, I) the recurrence kernels get: DeepAR training
    (T=96, N=32, H=40; I=40 is its second layer), DeepAR predict (N=1600,
    the path grows from T=73 to 96; N=3200 at GluonTS's default batch of
    32 series, which the JAX package's size rule sends to its loop), the
    GRU phase (T=35, N=32, H=200) and a large-H LSTM near that rule's
    limit (T=35, N=32, H=512)."""
    return (("deepar_train", 96, 32, 40, 40), ("deepar_predict", 73, 1600, 40, 40),
            ("deepar_predict", 96, 1600, 40, 40),
            ("deepar_predict", 96, 3200, 40, 40),
            ("gru_phase", 35, 32, 200, 200), ("large_h", 35, 32, 512, 512))


def rnn_bound(cell, direction, T, N, H, dtype, rate=None):
    """Least time (ms) of one recurrence kernel call: each input read once
    and each output written once, in their dtypes (x_proj, wh, h0 and c0,
    ys, hn and cn in ``dtype``; saved gates, cell states or hn_lin, and
    every gradient in fp32); ``2*T*N*G*H*H`` operations for the forward's
    recurrent product at ``rate`` (default: the dtype's peak; the
    tensor-core route's is TF32X3_FLOPS), twice that for the backward
    (dh_prev and dWh) at the fp32 rate."""
    G = 4 if cell == "lstm" else 3
    item = 2 if dtype == "bfloat16" else 4
    tn = T * N
    if direction == "fwd":
        nbytes = (tn * G * H * item + G * H * H * item + (G - 2) * N * H * item
                  + tn * H * item + (G - 2) * N * H * item + tn * G * H * 4
                  + tn * H * 4 + (G * H * item if cell == "gru" else 0))
        return least_ms(nbytes, 2.0 * tn * G * H * H, dtype, rate)
    nbytes = (tn * H * 4 + tn * G * H * 4 + tn * H * 4 + tn * H * item
              + G * H * H * 4 + 2 * (G - 2) * N * H * 4
              + tn * G * H * 4 + G * H * H * 4 + (G - 2) * N * H * 4
              + (G * H * 4 if cell == "gru" else 0))
    return least_ms(nbytes, 4.0 * tn * G * H * H, "float32")


def rnn_inputs(cell, T, N, H, I, dtype, dev, gen):
    """Inputs of one case on ``dev``: x (T, N, I), Xavier-scaled Wi, Wh and
    biases, small states, and unit cotangents."""
    G = 4 if cell == "lstm" else 3
    import torch

    dt = getattr(torch, dtype)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale)

    t = {"x": rnd(T, N, I, scale=0.5), "wi": rnd(G * H, I, scale=I ** -0.5),
         "wh": rnd(G * H, H, scale=H ** -0.5), "b": rnd(G * H, scale=0.1),
         "bh": rnd(G * H, scale=0.1), "h0": rnd(N, H, scale=0.1),
         "c0": rnd(N, H, scale=0.1), "dys": rnd(T, N, H),
         "dhn": rnd(N, H), "dcn": rnd(N, H)}
    t["xp"] = (torch.matmul(t["x"], t["wi"].T) + t["b"]).to(dt)
    for k in ("wh", "h0", "c0", "bh"):
        t[k] = t[k].to(dt)
    return t


def rel_err(got, ref):
    """Largest |got - ref| over the largest |ref| (at least 1)."""
    scale = max(1.0, ref.float().abs().max().item())
    return (got.float() - ref.float()).abs().max().item() / scale


def cudnn_layer(cell, t, H, I, N):
    """torch.nn.LSTM/GRU (cuDNN) with the same weights: gate orders i,f,g,o
    and r,z,n and the linear-before-reset GRU equal the JAX package's."""
    import torch

    mod = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(I, H).to(
        t["x"].device)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(t["wi"])
        mod.weight_hh_l0.copy_(t["wh"].float())
        mod.bias_ih_l0.copy_(t["b"])
        mod.bias_hh_l0.copy_(t["bh"].float() if cell == "gru"
                             else torch.zeros_like(t["b"]))
    h0 = t["h0"].float()[None]
    state = (h0, t["c0"].float()[None]) if cell == "lstm" else h0
    return mod, state


def check_rnn_kernels(mx, dev):
    """Rows 11-14 against their plain versions at every shape of
    :func:`rnn_kernel_shapes`, fp32 and bf16, LSTM and GRU, forward
    outputs and every backward output; timed beside the plain versions,
    cuDNN's layer (fp32, against the port's layer: input GEMM plus kernel)
    and the bound.  Returns each kernel's record at its main shape (fp32;
    DeepAR training for the LSTM, the GRU phase for the GRU)."""
    import torch

    from mxnet_tpu_torch.ops.kernels import rnn as kr

    gen = torch.Generator(device=dev).manual_seed(4)
    main, predict = {}, []
    log(f"rnn kernels: kernel vs plain, max |err| / max(1, max |ref|) within "
        f"{RNN_TOL} (forward outputs in x_proj's dtype; gates, states and "
        f"every gradient fp32); backward inputs are the plain forward's "
        f"saved tensors; cudnn = torch.nn.LSTM/GRU, fp32, vs the port's "
        f"layer (x @ Wi.T + b, then the kernel); per-step = kernel / T")
    for label, T, N, H, I in rnn_kernel_shapes():
        for cell in ("lstm", "gru"):
            for dtype in ("float32", "bfloat16"):
                t = rnn_inputs(cell, T, N, H, I, dtype, dev, gen)
                if cell == "lstm":
                    f_args = (t["xp"], t["wh"], t["h0"], t["c0"])
                    fwd, fplain = kr.lstm_fwd, kr.lstm_fwd_plain
                    bwd, bplain = kr.lstm_bwd, kr.lstm_bwd_plain
                    ref = fplain(*f_args)
                    b_args = (t["wh"], t["h0"], t["c0"], ref[0], ref[3],
                              ref[4], t["dys"], t["dhn"], t["dcn"])
                else:
                    f_args = (t["xp"], t["wh"], t["bh"], t["h0"])
                    fwd, fplain = kr.gru_fwd, kr.gru_fwd_plain
                    bwd, bplain = kr.gru_bwd, kr.gru_bwd_plain
                    ref = fplain(*f_args)
                    b_args = (t["wh"], t["h0"], ref[0], ref[2], ref[3],
                              t["dys"], t["dhn"])
                got = fwd(*f_args)
                bgot, bref = bwd(*b_args), bplain(*b_args)
                torch.cuda.synchronize()
                ferr = max(rel_err(g, r) for g, r in zip(got, ref))
                berr = max(rel_err(g, r) for g, r in zip(bgot, bref))
                ok = (ferr <= RNN_TOL[dtype] and berr <= RNN_TOL["float32"]
                      and all(bool(torch.isfinite(g).all()) for g in got)
                      and all(g.dtype == r.dtype and g.shape == r.shape
                              for g, r in zip(got, ref)))
                again = bwd(*b_args)
                ok = ok and all(torch.equal(a, b) for a, b in zip(bgot, again))
                fagain = fwd(*f_args)
                ok = ok and all(torch.equal(a, b) for a, b in zip(got, fagain))
                del again, fagain
                f_ms = cuda_ms(lambda: fwd(*f_args), 10)
                b_ms = cuda_ms(lambda: bwd(*b_args), 10)
                fp_ms = cuda_ms(lambda: fplain(*f_args), 2, warmup=1)
                bp_ms = cuda_ms(lambda: bplain(*b_args), 2, warmup=1)
                fbound = rnn_bound(cell, "fwd", T, N, H, dtype)
                bbound = rnn_bound(cell, "bwd", T, N, H, dtype)
                main_shape = (label, cell) in (("deepar_train", "lstm"),
                                               ("gru_phase", "gru"))
                predict_shape = (label, cell) == ("deepar_predict", "lstm")
                # every route that takes this shape, each direction, held
                # against the plain version; on the main paths' shapes
                # (fp32) the planned route and the split route (the
                # shared-memory kernel every launch took before the
                # redesigned routes) are timed, both directions (the
                # forward alone at predict's, whose path runs no backward)
                G = 4 if cell == "lstm" else 3
                pinned = {"fwd": kr._lstm_fwd if cell == "lstm"
                          else kr._gru_fwd,
                          "bwd": kr._lstm_bwd if cell == "lstm"
                          else kr._gru_bwd}
                routes = {}
                for d, args, want in (("fwd", f_args, ref),
                                      ("bwd", b_args, bref)):
                    back = d == "bwd"
                    route = kr.plan(G, back, N, H, dev)[0]
                    timed = (route, "split") if dtype == "float32" and (
                        main_shape or (predict_shape and not back)) else ()
                    routes_ms, rerr, checked = route_times(
                        lambda r: pinned[d](*args, route=r),  # noqa: B023
                        want,
                        lambda r: kr.plan(G, back, N, H, dev, r),  # noqa: B023
                        timed)
                    if rerr > 0:
                        raise SystemExit(f"{cell}_{d}: a route disagrees "
                                         f"with the plain version by "
                                         f"{rerr:.3g} past RNN_TOL at "
                                         f"{label} T={T} {dtype}")
                    routes[d] = (route, routes_ms, checked)
                cores = ""
                if routes["fwd"][0] == "mma":  # 3xTF32 products: their bound
                    cores = (f" (3xTF32; {fbound[0]:.4f} {fbound[1]} at the "
                             f"CUDA cores)")
                    fbound = rnn_bound(cell, "fwd", T, N, H, dtype,
                                       TF32X3_FLOPS)
                lib = ""
                rec = {}
                if dtype == "float32":
                    rec = rnn_layer_times(cell, t, T, N, H, I)
                    lib = (f" | layer fwd port {rec['port_fwd']:.4f} cudnn "
                           f"{rec['cudnn_fwd']:.4f} ms, bwd port "
                           f"{rec['port_bwd']:.4f} cudnn "
                           f"{rec['cudnn_bwd']:.4f} ms")
                log(f"  {label:14s} {cell} T={T} N={N} H={H} {dtype:8s} "
                    f"err fwd {ferr:.3g} bwd {berr:.3g} | fwd {f_ms:.4f} ms "
                    f"({1e3 * f_ms / T:.2f} us/step, bound {fbound[0]:.4f} "
                    f"{fbound[1]}{cores}, plain {fp_ms:.3f}) bwd "
                    f"{b_ms:.4f} ms "
                    f"({1e3 * b_ms / T:.2f} us/step, bound {bbound[0]:.4f} "
                    f"{bbound[1]}, plain {bp_ms:.3f}) | "
                    + "; ".join(
                        f"{cell}_{d} on the {r} route, routes held to plain "
                        f"{'/'.join(chk)}, timed (ms) "
                        + (", ".join(f"{k} {v:.4f}" for k, v in rms.items())
                           or "none")
                        for d, (r, rms, chk) in routes.items())
                    + f"{lib} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{cell} kernels disagree with their "
                                     f"plain versions: {label} T={T} "
                                     f"{dtype}")
                dev_ms = {}
                if dtype == "float32" and (main_shape or predict_shape):
                    # each kernel's device time: where its wrapper's host
                    # time exceeds it, events over calls read the host; the
                    # backward's with and without its dW product
                    for d, fn, tags in (
                            ("fwd", lambda: fwd(*f_args), (f"{cell}_fwd",)),
                            ("bwd", lambda: bwd(*b_args),
                             (f"{cell}_bwd", "dw_")),
                            ("recurrence", lambda: bwd(*b_args),
                             (f"{cell}_bwd",))):
                        if main_shape or d == "fwd":
                            dev_ms[d] = device_ms(fn, 5, tags)
                    log(f"  {cell} at {label} T={T} N={N}, device ms "
                        f"(torch.profiler): "
                        + ", ".join(f"{cell}_{d} {v:.4f}" if d != "recurrence"
                                    else f"{cell}_bwd without the dW product "
                                    f"{v:.4f}" for d, v in dev_ms.items()))
                if dtype == "float32" and main_shape:
                    hosts = {"fwd": host_us(lambda: fwd(*f_args), 100),
                             "bwd": host_us(lambda: bwd(*b_args), 100)}
                    log(f"  {cell} wrappers' host time a call at {label}: "
                        f"fwd {hosts['fwd']:.1f} us, bwd "
                        f"{hosts['bwd']:.1f} us")
                    for d, ms, pms, bound, err in (
                            ("fwd", f_ms, fp_ms, fbound, ferr),
                            ("bwd", b_ms, bp_ms, bbound, berr)):
                        route, routes_ms, _ = routes[d]
                        main[f"{cell}_{d}"] = {
                            "max_abs_err": err, "ms": ms, "plain_ms": pms,
                            "bound_ms": bound[0], "bound_by": bound[1],
                            "library_ms": rec[f"cudnn_{d}"],
                            "us_per_step": 1e3 * ms / T,
                            "port_layer_ms": rec[f"port_{d}"],
                            "host_us": hosts[d], "kernel_route": route,
                            "split_route_ms": routes_ms.get("split"),
                            "route_ms": routes_ms, "device_ms": dev_ms[d],
                            "shape": f"T={T} N={N} H={H} I={I} fp32"}
                    main[f"{cell}_bwd"]["recurrence_device_ms"] = \
                        dev_ms["recurrence"]
                if dtype == "float32" and predict_shape:
                    route, routes_ms, _ = routes["fwd"]
                    predict.append({
                        "shape": f"T={T} N={N} H={H} I={I} fp32", "ms": f_ms,
                        "device_ms": dev_ms["fwd"],
                        "kernel_route": route,
                        "split_route_ms": routes_ms.get("split"),
                        "route_ms": routes_ms,
                        "bound_ms": fbound[0], "bound_by": fbound[1],
                        "library_ms": rec["cudnn_fwd"],
                        "port_layer_ms": rec["port_fwd"]})
                del t, f_args, b_args, ref, got, bgot, bref
        torch.cuda.empty_cache()
    main["lstm_fwd"]["predict"] = predict
    check_rnn_functions(kr, dev, gen)
    return main


def route_times(call, want, has_plan, timed=()):
    """Each route of the kernel wrappers' ``ROUTES`` that has a plan for
    the call (``has_plan(route)`` does not raise): ``call(route)``'s
    outputs against ``want`` (the plain version's), as the main check
    holds them, and the time of those in ``timed``.  Returns ({route: ms}
    of the timed routes, the largest error past RNN_TOL (0 if none), the
    routes checked)."""
    import torch

    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    times, worst, checked = {}, 0.0, []
    tol = RNN_TOL["bfloat16" if want[0].dtype == torch.bfloat16
                  else "float32"]
    for r in kr.ROUTES:
        try:
            has_plan(r)
        except MXNetError:
            continue
        got = call(r)
        err = max(rel_err(g, w) for g, w in zip(got, want))
        worst = max(worst, err - tol if err > tol else 0.0)
        del got
        checked.append(r)
        if r in timed:
            times[r] = cuda_ms(lambda: call(r), 10)  # noqa: B023
    return times, worst, checked


def rnn_layer_times(cell, t, T, N, H, I):
    """The port's layer (``input_projection``, then the kernel's autograd
    Function, as ``ops/rnn.py`` runs a layer) and cuDNN's, forward and
    backward (autograd through each, the graph kept across calls), fp32:
    each the least of three runs of 10 calls, the two layers in turns
    (port, cuDNN, cuDNN, port, port, cuDNN): at small shapes both are
    host-bound, and the host is shared."""
    import torch

    from mxnet_tpu_torch.ops.kernels import rnn as kr

    mod, state = cudnn_layer(cell, t, H, I, N)
    x = t["x"].detach().requires_grad_(True)
    wi = t["wi"].detach().requires_grad_(True)
    wh = t["wh"].detach().requires_grad_(True)

    def port():
        xp = kr.input_projection(x, wi, t["b"])
        if cell == "lstm":
            return kr.lstm_layer(xp, wh, t["h0"], t["c0"])[0]
        return kr.gru_layer(xp, wh, t["bh"], t["h0"])[0]

    y = port()
    yc = mod(x, state)[0]
    params = (x, mod.weight_ih_l0, mod.weight_hh_l0)
    calls = {
        "port_fwd": port, "cudnn_fwd": lambda: mod(x, state),
        "port_bwd": lambda: torch.autograd.grad(
            y, (x, wi, wh), t["dys"], retain_graph=True),
        "cudnn_bwd": lambda: torch.autograd.grad(
            yc, params, t["dys"], retain_graph=True)}
    out = {}
    for d in ("fwd", "bwd"):
        for order in (("port", "cudnn"), ("cudnn", "port"),
                      ("port", "cudnn")):
            for side in order:
                key = f"{side}_{d}"
                out[key] = min(out.get(key, float("inf")),
                               cuda_ms(calls[key], 10))
    return out


def check_rnn_functions(kr, dev, gen):
    """lstm_layer and gru_layer on the card (kernel forward and backward)
    against torch.autograd through the plain forward, fp32 at the DeepAR
    and GRU-phase shapes: every gradient within RNN_TOL of its largest
    magnitude."""
    import torch

    worst = 0.0
    for cell, T, N, H in (("lstm", 96, 32, 40), ("gru", 35, 32, 200)):
        t = rnn_inputs(cell, T, N, H, H, "float32", dev, gen)
        keys = ("xp", "wh", "h0", "c0") if cell == "lstm" else \
            ("xp", "wh", "bh", "h0")
        grads = []
        for fn in ((kr.lstm_layer, kr.lstm_layer_plain) if cell == "lstm"
                   else (kr.gru_layer, kr.gru_layer_plain)):
            ins = [t[k].clone().requires_grad_(True) for k in keys]
            outs = fn(*ins)
            loss = (outs[0] * t["dys"]).sum() + (outs[1] * t["dhn"]).sum()
            grads.append(torch.autograd.grad(loss, ins))
        worst = max(worst, max(rel_err(g, r) for g, r in zip(*grads)))
    ok = worst <= RNN_TOL["float32"]
    log(f"rnn kernels: lstm_layer/gru_layer on the card vs autograd of the "
        f"plain forward, fp32: max err / max |grad| {worst:.3g} (limit "
        f"{RNN_TOL['float32']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the RNN autograd Functions disagree with autograd "
                         "through the plain forward")


# -- phases 11-13: DeepAR -----------------------------------------------------


def deepar_net(mx, ctx, dropout=0.1):
    """GluonTS's DeepAR defaults: 2x40 LSTM, Student-t head, Xavier from
    seed 0 (deferred input width)."""
    mx.random.seed(0)
    net = mx.models.deepar(40, 2, dropout=dropout)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def deepar_data():
    """The port's GluonTS-style pipeline: 16 synthetic hourly series of 200
    points and a splitter of context 72, prediction 24."""
    import numpy as np

    from mxnet_tpu_torch.data import timeseries as dts

    ds = dts.synthetic_dataset(np.random.RandomState(0))
    return ds, dts.InstanceSplitter(DEEPAR_CONTEXT, DEEPAR_PREDICT, seed=0)


def train_deepar(mx, card):
    """20 Adam steps of DeepAR at batch 32 on fresh covariate batches, then
    predict; then card vs CPU.  Returns the launch counts of both runs, the
    median step, lstm_fwd's launches by route on each path and lstm_bwd's
    in training."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    gpu = mx.gpu(0)
    net = deepar_net(mx, gpu)
    ds, splitter = deepar_data()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    losses, step_ms, missing = [], [], []
    kernels.reset_counts()
    for step in range(DEEPAR_STEPS):
        inst = splitter.training_instances(ds, DEEPAR_BATCH)
        series = mx.nd.array(inst["target"], ctx=gpu)
        covs = mx.nd.array(inst["covariates"], ctx=gpu)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            nll = net(series, covs)
        nll.backward()
        if step == 0:
            for name, p in net.collect_params().items():
                g = p.data().grad
                if g is None or not bool(torch.isfinite(g).all()):
                    missing.append(name)
        trainer.step(DEEPAR_BATCH)
        losses.append(nll.asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 3:
            after4 = [p.data().detach().clone()
                      for p in net.collect_params().values()]
    counts = {k: (kernels.KERNEL_COUNTS[k].launches,
                  kernels.KERNEL_COUNTS[k].plain_calls_on_cuda)
              for k in ("lstm_fwd", "lstm_bwd")}
    routes = launches_by_route(kr.lstm_fwd_counts)
    bwd_routes = launches_by_route(kr.lstm_bwd_counts)
    n = DEEPAR_STEPS
    median_ms = statistics.median(step_ms[2:])
    eager_record("deepar", losses, after4, counts_now(), n, median_ms)
    log(f"deepar train: 2x40 LSTM, Student-t, dropout 0.1, b={DEEPAR_BATCH}"
        f" context {DEEPAR_CONTEXT} + prediction {DEEPAR_PREDICT}, 3 "
        f"covariates, Adam 1e-3, {n} steps; nll {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; step median {median_ms:.3f} ms over steps "
        f"3-{n} (first {step_ms[0]:.1f} ms), "
        f"{DEEPAR_BATCH / (median_ms / 1e3):.1f} series/s on {card}")
    log(f"deepar train: losses {[round(v, 4) for v in losses]}")
    log(f"deepar train: (launches, plain calls on cuda) {counts} (2 x {n} "
        f"= {2 * n} each); launches by route: lstm_fwd {routes}, lstm_bwd "
        f"{bwd_routes}")
    checks = {
        "finite_losses": all(np.isfinite(losses)),
        "first_backward_gradients": not missing,
        "nll_falls": statistics.mean(losses[-5:]) < losses[0],
        "launches": all(c[0] == 2 * n for c in counts.values()),
        "plain_calls_on_cuda": all(c[1] == 0 for c in counts.values()),
        "lstm_fwd_register_route": routes == {"split": 0, "reg": 2 * n,
                                              "mma": 0},
        "lstm_bwd_register_route": bwd_routes == {"split": 0, "reg": 2 * n},
    }
    if missing:
        log(f"deepar train: parameters without a finite gradient after the "
            f"first backward: {missing}")

    pred = splitter.prediction_instances(ds)
    plaunch, by_route = {}, {"deepar_train": routes}
    for label, reps in (("deepar_predict", 1), ("deepar_predict_b32", 2)):
        # reps 2: the 16 series twice, GluonTS's default predict batch
        context = mx.nd.array(np.tile(pred["target"], (reps, 1)), ctx=gpu)
        covs = np.tile(pred["covariates"], (reps, 1, 1))
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        samples = net.predict(context, prediction_length=DEEPAR_PREDICT,
                              num_samples=DEEPAR_SAMPLES, covariates=covs,
                              seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (kr.lstm_fwd_counts.launches,
               kr.lstm_fwd_counts.plain_calls_on_cuda)
        proutes = by_route[label] = launches_by_route(kr.lstm_fwd_counts)
        plaunch[label] = got[0]
        p50 = np.median(samples[0], axis=0)
        p90 = np.percentile(samples[0], 90, axis=0)
        nser = samples.shape[0]
        log(f"deepar predict: {nser} series x {DEEPAR_SAMPLES} samples "
            f"(N={nser * DEEPAR_SAMPLES}), {DEEPAR_PREDICT} steps in "
            f"{wall:.3f} s on {card}; lstm_fwd (launches, plain calls on "
            f"cuda) {got} (2 x {DEEPAR_PREDICT} = {2 * DEEPAR_PREDICT}), by "
            f"route {proutes}")
        log(f"deepar predict: series 0 p50[:6] "
            f"{np.round(p50[:6], 3).tolist()} p90[:6] "
            f"{np.round(p90[:6], 3).tolist()}")
        checks[f"{label}_launches"] = got == (2 * DEEPAR_PREDICT, 0)
        checks[f"{label}_tensor_core_route"] = proutes == {
            "split": 0, "reg": 0, "mma": 2 * DEEPAR_PREDICT}
        checks[f"{label}_samples"] = samples.shape == (
            nser, DEEPAR_SAMPLES, DEEPAR_PREDICT) and bool(
                np.isfinite(samples).all())
    del net, trainer
    torch.cuda.empty_cache()
    checks.update(deepar_card_vs_cpu(mx, splitter, ds))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"deepar checks failed: {failed}")
    return ({k: c[0] for k, c in counts.items()}, plaunch, median_ms,
            by_route, bwd_routes)


def launches_by_route(counts):
    """A kernel's launches by route since the counts were last reset."""
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    return {r: getattr(counts, f"{r}_launches") for r in kr.ROUTES
            if hasattr(counts, f"{r}_launches")}


def deepar_card_vs_cpu(mx, splitter, ds):
    """Batch 4, dropout 0, fp32 with TF32 off, the same weights on the card
    and on the CPU: the first NLL, l0_h2h_weight's gradient, 2 Adam steps'
    losses, the first predict step's (mu, sigma, nu) and predict's paths
    (4 samples, 3 steps) must agree."""
    import numpy as np
    import torch

    inst = splitter.training_instances(ds, 4)
    pred = splitter.prediction_instances(ds)
    ctx_np, cov_np = pred["target"][:4], pred["covariates"][:4]
    runs, weights = [], None
    for ctx in (mx.gpu(0), mx.cpu()):
        net = deepar_net(mx, ctx, dropout=0.0)
        batch = [mx.nd.array(inst[k], ctx=ctx)
                 for k in ("target", "covariates")]
        if weights is None:
            with mx.autograd.pause():
                net(*batch)
            weights = {k: p.data().detach().cpu().numpy().copy() for k, p in
                       net._collect_params_with_prefix().items()}
        else:
            mx.load_numpy_params(net, weights)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-3})
        losses = []
        for step in range(2):
            with mx.autograd.record():
                nll = net(*batch)
            nll.backward()
            if step == 0:
                grad = net._collect_params_with_prefix()[
                    "lstm.l0_h2h_weight"].grad().detach().cpu().numpy().copy()
            trainer.step(4)
            losses.append(nll.asscalar())
        mx.load_numpy_params(net, weights)
        dev = next(iter(net.collect_params().values())).data().device
        params = net.next_params(ctx_np, torch.from_numpy(cov_np).to(dev))
        paths = net.predict(ctx_np, prediction_length=3, num_samples=4,
                            covariates=cov_np[:, :DEEPAR_CONTEXT + 3], seed=1)
        runs.append((losses, grad, params, paths))
        del net, trainer
    (gl, gg, gp, gpath), (cl, cg, cp, cpath) = runs
    nll_err = abs(gl[0] - cl[0]) / abs(cl[0])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    grad_err = float(np.abs(gg - cg).max() / np.abs(cg).max())
    param_err = max(float(np.abs(a - b).max()) for a, b in zip(gp, cp))
    path_err = float(np.abs(gpath - cpath).max() / np.abs(cpath).max())
    log(f"deepar card vs cpu, b=4 dropout 0 fp32: first nll {gl[0]:.7f} vs "
        f"{cl[0]:.7f} rel err {nll_err:.3g} (limit {DEEPAR_NLL_RTOL}); "
        f"l0_h2h_weight gradient max abs err / max |grad| {grad_err:.3g} "
        f"(limit {DEEPAR_GRAD_RTOL}); 2 Adam steps' losses {gl} vs {cl} max "
        f"rel err {loss_err:.3g} (limit {DEEPAR_LOSS_RTOL}); first predict "
        f"step's (mu, sigma, nu) max abs err {param_err:.3g} (limit "
        f"{DEEPAR_PARAM_ATOL}); predict paths max err / max |path| "
        f"{path_err:.3g} (limit {DEEPAR_PATH_RTOL})")
    return {"card_vs_cpu_nll": nll_err <= DEEPAR_NLL_RTOL,
            "card_vs_cpu_grad": grad_err <= DEEPAR_GRAD_RTOL,
            "card_vs_cpu_losses": loss_err <= DEEPAR_LOSS_RTOL,
            "card_vs_cpu_predict_params": param_err <= DEEPAR_PARAM_ATOL,
            "card_vs_cpu_predict_paths": path_err <= DEEPAR_PATH_RTOL}


# -- phase 14: the GRU --------------------------------------------------------


def gru_net_and_data(mx):
    """The GRU regression net (Xavier from seed 0, deferred input width),
    its input and its fixed target on the card."""
    import numpy as np

    class GruRegression(mx.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.gru = mx.gluon.rnn.GRU(GRU_HIDDEN, num_layers=2)

        def hybrid_forward(self, F, x, target):
            return F.mean(F.square(self.gru(x) - target)) * 0.5

    gpu = mx.gpu(0)
    mx.random.seed(0)
    net = GruRegression()
    net.initialize(mx.init.Xavier(), ctx=gpu)
    rng = np.random.RandomState(5)
    x = mx.nd.array(rng.randn(GRU_T, GRU_BATCH, GRU_HIDDEN) * 0.5, ctx=gpu)
    target = mx.nd.array(np.tanh(rng.randn(GRU_T, GRU_BATCH, GRU_HIDDEN)),
                         ctx=gpu)
    return net, x, target


def train_gru(mx, card):
    """gluon.rnn.GRU(200, num_layers=2), TNC, T=35, N=32, input 200, 20
    Adam steps on an L2 loss against a fixed target.  Returns the launch
    counts, the median step and gru_fwd's and gru_bwd's launches by
    route."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels

    net, x, target = gru_net_and_data(mx)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    losses, step_ms = [], []
    kernels.reset_counts()
    for i in range(GRU_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = net(x, target)
        loss.backward()
        trainer.step(1)
        losses.append(loss.asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 3:
            after4 = [p.data().detach().clone()
                      for p in net.collect_params().values()]
    counts = {k: (kernels.KERNEL_COUNTS[k].launches,
                  kernels.KERNEL_COUNTS[k].plain_calls_on_cuda)
              for k in ("gru_fwd", "gru_bwd")}
    routes = {k: launches_by_route(kernels.KERNEL_COUNTS[k])
              for k in ("gru_fwd", "gru_bwd")}
    n = GRU_STEPS
    median_ms = statistics.median(step_ms[2:])
    eager_record("gru", losses, after4, counts_now(), n, median_ms)
    log(f"gru: gluon.rnn.GRU({GRU_HIDDEN}, num_layers=2) TNC T={GRU_T} "
        f"N={GRU_BATCH}, L2 loss, Adam 1e-3, {n} steps; loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; step median {median_ms:.3f} "
        f"ms over steps 3-{n} on {card}; (launches, plain calls on cuda) "
        f"{counts} (2 x {n} = {2 * n} each); launches by route {routes}")
    checks = {"finite_losses": all(np.isfinite(losses)),
              "loss_falls": losses[-1] < losses[0],
              "launches": all(c[0] == 2 * n for c in counts.values()),
              "plain_calls_on_cuda": all(c[1] == 0 for c in counts.values()),
              "gru_fwd_cluster_route": routes["gru_fwd"] == {
                  "split": 0, "cluster": 2 * n},
              "gru_bwd_cluster_route": routes["gru_bwd"] == {
                  "split": 0, "cluster": 2 * n}}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"gru checks failed: {failed}")
    return {k: c[0] for k, c in counts.items()}, median_ms, routes


# -- phase 15: captured steps -------------------------------------------------


def own_loss(out):
    """The loss of a block whose output is already its loss."""
    return out


def the_graph(trainer):
    """The one CUDA graph a trainer's captured step holds."""
    if hasattr(trainer, "_graphs"):  # DataParallelTrainer
        return next(iter(trainer._graphs.values())).graph
    closure = next(iter(trainer._whole_step_compiler._closures.values()))
    return next(iter(closure.graphs.values()))[0].graph


def captured_phase(label, card, step, tensors, steps, trainer):
    """``steps`` calls of ``step(i)`` (a captured training step), timed as
    the eager phase times its steps, against ``EAGER_RUNS[label]``: one
    graph captured, a replay a step after the warm-up, no fallback, the
    eager step's launches at every step, no plain call on CUDA, and the
    first 4 losses and the parameters after them (``tensors()``) bit for
    bit.  Then ``trainer``'s graph alone, replayed 5 times, gives the
    replay's time by CUDA events; the rest of the step median is the
    host's work before the replay.  Returns ``(checks, median_ms)``."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _imperative
    from mxnet_tpu_torch.gluon import trainer as mtrainer
    from mxnet_tpu_torch.ops import kernels

    eager = EAGER_RUNS[label]
    kernels.reset_counts()
    mtrainer.reset_trainer_step_stats()
    c0 = _imperative.graph_capture_count()
    r0 = _imperative.graph_replay_count()
    losses, step_ms, gains = [], [], []
    for i in range(steps):
        before = counts_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(i)
        losses.append(loss.asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gains.append(counts_gain(before, counts_now()))
        if i == 3:
            same_params = all(torch.equal(a, b) for a, b in
                              zip(tensors(), eager["params"]))
    captured = _imperative.graph_capture_count() - c0
    replays = _imperative.graph_replay_count() - r0
    fallbacks = mtrainer.trainer_step_stats()["whole_step_fallbacks"]
    plain = sum(c.plain_calls_on_cuda
                for c in kernels.KERNEL_COUNTS.values())
    want = eager["launches"]
    off = [i for i, g in enumerate(gains) if g != want]
    same_losses = losses[:4] == eager["losses"]
    median_ms = statistics.median(step_ms[2:])
    graph = the_graph(trainer)
    replay_ms = cuda_ms(graph.replay, 5, warmup=1)
    log(f"captured {label}: {steps} steps; step median {median_ms:.3f} ms "
        f"over steps 3-{steps} (eager {eager['median_ms']:.3f} ms, the same "
        f"call; first {step_ms[0]:.1f}, second {step_ms[1]:.1f} ms) on "
        f"{card}; the graph's replay alone {replay_ms:.3f} ms by events, "
        f"so {median_ms - replay_ms:.3f} ms of host work before it; graphs "
        f"captured {captured}, replays {replays}, whole_step_fallbacks "
        f"{fallbacks}, plain calls on cuda {plain}")
    log(f"captured {label}: launches a replay {gains[-1]} (eager a step "
        f"{want}); steps whose launches differ: {off}")
    log(f"captured {label}: first 4 losses {losses[:4]}, eager "
        f"{eager['losses']}: bit-identical {same_losses}; parameters after "
        f"4 steps bit-identical {same_params}; losses "
        f"{[round(v, 4) for v in losses]}")
    checks = {"one_capture": captured == 1,
              "replay_a_step": replays == steps - 1,
              "no_fallback": fallbacks == 0,
              "launches_equal_eager": not off,
              "plain_calls_on_cuda": plain == 0,
              "finite_losses": bool(np.isfinite(losses).all()),
              "losses_bit_identical": same_losses,
              "params_bit_identical": same_params}
    return checks, median_ms


def captured_bert(mx, card):
    """BERT-base MLM+NSP, b=32, s=128, AdamW, dropout 0.1, through
    ``Trainer(whole_step=True).whole_step``."""
    import numpy as np

    gpu = mx.gpu(0)
    net = pretrain_net(mx, gpu, dropout=0.1)
    data = synthetic_batch(np.random.RandomState(3), TRAIN_BATCH, TRAIN_SEQ,
                           30522)
    batch = [mx.nd.array(a, ctx=gpu) for a in data]
    trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01},
                               whole_step=True)
    params = list(net.collect_params().values())
    return captured_phase(
        "bert", card,
        lambda i: trainer.whole_step(net, own_loss, batch, batch_size=1),
        lambda: [p.data() for p in params], TRAIN_STEPS, trainer)


def captured_resnet(mx, card):
    """ResNet-50 b=128 bf16 through the captured ``DataParallelTrainer``,
    from the eager phase's starting weights; then ``step_many`` over 4
    stacked batches: 4 replays, no new capture, the eager launches 4
    times, finite losses."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _imperative

    x, y = synthetic_images(np.random.RandomState(0), RESNET_BATCH,
                            RESNET_IMAGE)
    xg, yg = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    trainer = resnet_trainer(mx, resnet50(mx, mx.gpu(0), fuse=True),
                             compute_dtype="bfloat16", capture=True)
    trainer.build(xg)
    with torch.no_grad():
        for p, p0 in zip(trainer._params, EAGER_RUNS["resnet"]["start"]):
            p.copy_(p0)
    checks, median_ms = captured_phase(
        "resnet", card, lambda i: trainer.step(xg, yg),
        lambda: trainer._params, RESNET_STEPS, trainer)
    more = [synthetic_images(np.random.RandomState(s), RESNET_BATCH,
                             RESNET_IMAGE) for s in (1, 2, 3)]
    xs = torch.stack([xg] + [torch.from_numpy(a).cuda() for a, _ in more])
    ys = torch.stack([yg] + [torch.from_numpy(b).cuda() for _, b in more])
    c0 = _imperative.graph_capture_count()
    r0 = _imperative.graph_replay_count()
    before = counts_now()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    many = trainer.step_many(xs, ys)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    gain = counts_gain(before, counts_now())
    want = {k: {n: 4 * v for n, v in d.items()}
            for k, d in EAGER_RUNS["resnet"]["launches"].items()}
    vals = many.asnumpy()
    log(f"captured resnet: step_many over 4 stacked batches {wall:.3f} ms "
        f"({wall / 4:.3f} ms a step), losses {vals.tolist()}; graphs "
        f"captured {_imperative.graph_capture_count() - c0}, replays "
        f"{_imperative.graph_replay_count() - r0}; launches {gain}")
    checks.update({
        "step_many_replays": (_imperative.graph_replay_count() - r0 == 4
                              and _imperative.graph_capture_count() == c0),
        "step_many_launches": gain == want,
        "step_many_losses": vals.shape == (4,) and bool(
            np.isfinite(vals).all())})
    del trainer, xs, ys
    torch.cuda.empty_cache()
    return checks, median_ms


def captured_deepar(mx, card):
    """DeepAR through ``Trainer(whole_step=True).whole_step`` on the eager
    phase's sequence of fresh covariate batches."""
    gpu = mx.gpu(0)
    net = deepar_net(mx, gpu)
    ds, splitter = deepar_data()
    batches = []
    for _ in range(DEEPAR_STEPS):
        inst = splitter.training_instances(ds, DEEPAR_BATCH)
        batches.append((mx.nd.array(inst["target"], ctx=gpu),
                        mx.nd.array(inst["covariates"], ctx=gpu)))
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3}, whole_step=True)
    params = list(net.collect_params().values())
    return captured_phase(
        "deepar", card,
        lambda i: trainer.whole_step(net, own_loss, batches[i],
                                     batch_size=DEEPAR_BATCH),
        lambda: [p.data() for p in params], DEEPAR_STEPS, trainer)


def captured_gru(mx, card):
    """The GRU phase through ``Trainer(whole_step=True).whole_step``."""
    net, x, target = gru_net_and_data(mx)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3}, whole_step=True)
    params = list(net.collect_params().values())
    return captured_phase(
        "gru", card,
        lambda i: trainer.whole_step(net, own_loss, (x, target),
                                     batch_size=1),
        lambda: [p.data() for p in params], GRU_STEPS, trainer)


def captured_steps(mx, card):
    """Phase 15 on every training path; returns the step medians,
    ``{path: (eager ms, captured ms)}``."""
    import torch

    medians, failed = {}, []
    for label, fn in (("bert", captured_bert), ("resnet", captured_resnet),
                      ("deepar", captured_deepar), ("gru", captured_gru)):
        checks, median_ms = fn(mx, card)
        medians[label] = (EAGER_RUNS[label]["median_ms"], median_ms)
        failed += [f"{label}: {k}" for k, ok in checks.items() if not ok]
        EAGER_RUNS.pop(label)
        torch.cuda.empty_cache()
    log(f"captured steps: step medians (eager, captured) ms {medians}")
    if failed:
        raise SystemExit(f"captured step checks failed: {failed}")
    return medians


# -- phase 16: checkpoints ----------------------------------------------------


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def timed_steps(step, n, gains=None):
    """``n`` calls of ``step()``, each timed on the host with the card
    synchronised before and after; returns ``(losses, ms)`` and appends
    each call's launch gain to ``gains``."""
    import torch

    losses, ms = [], []
    for _ in range(n):
        before = counts_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step().asscalar())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if gains is not None:
            gains.append(counts_gain(before, counts_now()))
    return losses, ms


def timed_save(save):
    """``save()`` on the host clock and its device copies by CUDA events;
    returns ``(result, host ms, device ms, commit clock start)``."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = save()
    end.record()
    hold_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return out, hold_ms, start.elapsed_time(end), t0


def same_tensors(a, b):
    import torch

    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def checkpoint_bert(mx, card, tmpdir):
    """Phase 16 (a): BERT-base MLM+NSP, b=32, s=128, AdamW, dropout 0.1,
    from phase 15's weights and batch.  A reference of 6 captured steps;
    run A saves after step 3 without ``sync`` and takes steps 4-6 while it
    drains; runs B (captured) and C (eager) restore it into a net and
    trainer with other weights and take steps 4-6."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.ops import kernels

    gpu = mx.gpu(0)
    data = synthetic_batch(np.random.RandomState(3), TRAIN_BATCH, TRAIN_SEQ,
                           30522)
    batch = [mx.nd.array(a, ctx=gpu) for a in data]

    def make(seed, whole_step):
        net = pretrain_net(mx, gpu, dropout=0.1, seed=seed)
        trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                                   {"learning_rate": 1e-4, "wd": 0.01},
                                   whole_step=whole_step)
        params = list(net.collect_params().values())
        return (lambda: trainer.whole_step(net, own_loss, batch,
                                           batch_size=1),
                net, trainer, lambda: [p.data().detach().clone()
                                       for p in params])

    kernels.reset_counts()
    step, net, trainer, weights = make(0, True)
    ref_losses, _ = timed_steps(step, 3)
    ref_w3 = weights()
    more, ref_ms = timed_steps(step, 3)
    ref_losses += more
    ref_w6 = weights()
    del step, net, trainer
    torch.cuda.empty_cache()

    ckdir = os.path.join(tmpdir, "bert")
    step, net, trainer, weights = make(0, True)
    a_losses, _ = timed_steps(step, 3)
    mgr = CheckpointManager(ckdir, keep_n=2)
    fut, hold_ms, copy_ms, t0 = timed_save(
        lambda: mgr.save(3, params=net, trainer=trainer))
    done = []
    fut.add_done_callback(lambda f: done.append(time.perf_counter()))
    more, a_ms = timed_steps(step, 3)
    a_losses += more
    mgr.wait_until_finished()
    commit_s = done[0] - t0
    nbytes = dir_bytes(ckdir)
    a_w6 = weights()
    # a second save reuses the first one's device and host buffers; 3
    # more steps run while it drains
    _, hold2_ms, copy2_ms, _ = timed_save(
        lambda: mgr.save(6, params=net, trainer=trainer))
    _, a2_ms = timed_steps(step, 3)
    mgr.wait_until_finished()
    del step, net, trainer, mgr
    torch.cuda.empty_cache()

    runs = {}
    for label, whole in (("B", True), ("C", False)):
        step, net, trainer, weights = make(1, whole)
        gains = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        meta = CheckpointManager(ckdir).restore(step=3, params=net,
                                                trainer=trainer)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        w3 = weights()
        losses, _ = timed_steps(step, 3, gains)
        runs[label] = {"restored": same_tensors(w3, ref_w3),
                       "losses": losses == ref_losses[3:],
                       "params": same_tensors(weights(), ref_w6),
                       "step": meta["step"] == 3,
                       "gains": gains, "restore_s": restore_s}
        del step, net, trainer, w3
        torch.cuda.empty_cache()
    plain = sum(c.plain_calls_on_cuda
                for c in kernels.KERNEL_COUNTS.values())
    flash = {k: {"launches": 12} for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}
    want = STEP_LAUNCHES["bert"]
    log(f"checkpoint bert: {nbytes} bytes written; save() held the training "
        f"thread {hold_ms:.3f} ms (its device copies {copy_ms:.3f} ms by "
        f"events; a second save {hold2_ms:.3f} ms, device {copy2_ms:.3f} "
        f"ms); committed {commit_s:.3f} s after the call; restore "
        f"B {runs['B']['restore_s']:.3f} s, C {runs['C']['restore_s']:.3f} "
        f"s; step median of steps 4-6 with the save in flight "
        f"{statistics.median(a_ms):.3f} ms (steps {[round(v, 3) for v in a_ms]}; "
        f"steps 7-9 during the second save {[round(v, 3) for v in a2_ms]}), "
        f"without {statistics.median(ref_ms):.3f} ms "
        f"({[round(v, 3) for v in ref_ms]}) on {card}")
    summary = {k: {n: v for n, v in r.items() if n != "gains"}
               for k, r in runs.items()}
    log(f"checkpoint bert: reference losses {ref_losses}; run A steps 4-6 "
        f"{a_losses[3:]}; runs B, C: {summary}")
    log(f"checkpoint bert: launches a step, B {runs['B']['gains']}, C "
        f"{runs['C']['gains']}; plain calls on cuda {plain}")
    checks = {
        "a_losses_bit_identical": a_losses == ref_losses,
        "a_params_bit_identical": same_tensors(a_w6, ref_w6),
        "committed": os.path.isdir(os.path.join(ckdir, "ckpt-00000003")),
        "plain_calls_on_cuda": plain == 0,
    }
    for label, r in runs.items():
        checks[f"{label}_restored_step3_weights"] = r["restored"]
        checks[f"{label}_losses_bit_identical"] = r["losses"] and r["step"]
        checks[f"{label}_params_bit_identical"] = r["params"]
        checks[f"{label}_launches"] = all(
            g == want and all(g.get(k, {}).get("launches") == 12
                              for k in flash)
            for g in r["gains"])
    shutil.rmtree(ckdir)
    return checks, {"bytes": nbytes, "save_hold_ms": [hold_ms, hold2_ms],
                    "save_copy_ms": [copy_ms, copy2_ms], "commit_s": commit_s,
                    "restore_s": [runs["B"]["restore_s"],
                                  runs["C"]["restore_s"]],
                    "median_ms_saving": [statistics.median(a_ms),
                                         statistics.median(a2_ms)],
                    "median_ms": statistics.median(ref_ms)}


def checkpoint_resnet(mx, card, tmpdir):
    """Phase 16 (b): ResNet-50 v1 NHWC b=128 bf16 through the captured
    ``DataParallelTrainer`` from phase 15's weights and batch: 3 steps,
    ``save_states(async_save=True)``, 3 more; a fresh, built trainer over
    the block (re-initialised with other weights) loads it and takes 3
    steps.  Then ``sync_to_block``, ``save_parameters`` and
    ``load_parameters`` into a fresh ResNet-50, whose b=64 fp32 predict
    forward must equal the source block's."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels

    gpu = mx.gpu(0)
    x, y = synthetic_images(np.random.RandomState(0), RESNET_BATCH,
                            RESNET_IMAGE)
    xg, yg = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    net = resnet50(mx, gpu, fuse=True)
    trainer = resnet_trainer(mx, net, compute_dtype="bfloat16", capture=True)
    trainer.build(xg)
    kernels.reset_counts()
    timed_steps(lambda: trainer.step(xg, yg), 3)
    prefix = os.path.join(tmpdir, "resnet50")
    fut, hold_ms, copy_ms, t0 = timed_save(
        lambda: trainer.save_states(prefix, async_save=True))
    done = []
    fut.add_done_callback(lambda f: done.append(time.perf_counter()))
    ref_losses, saving_ms = timed_steps(lambda: trainer.step(xg, yg), 3)
    fut.result()
    commit_s = done[0] - t0
    ref_w6 = [p.detach().clone() for p in trainer._params]
    nbytes = sum(os.path.getsize(f"{prefix}-{n}.npz")
                 for n in ("meta", "shards-p0"))
    _, plain_ms = timed_steps(lambda: trainer.step(xg, yg), 3)
    plain = sum(c.plain_calls_on_cuda
                for c in kernels.KERNEL_COUNTS.values())
    # a second save reuses the first one's device and host buffers
    fut, hold2_ms, copy2_ms, _ = timed_save(
        lambda: trainer.save_states(prefix + "-2", async_save=True))
    _, saving2_ms = timed_steps(lambda: trainer.step(xg, yg), 3)
    fut.result()
    del trainer
    torch.cuda.empty_cache()

    mx.random.seed(5)
    net.initialize(mx.init.Xavier(), ctx=gpu, force_reinit=True)
    fresh = resnet_trainer(mx, net, compute_dtype="bfloat16", capture=True)
    fresh.build(xg)  # a predict-mode probe of 2 samples, as in phase 7
    kernels.reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fresh.load_states(prefix)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    gains = []
    losses, _ = timed_steps(lambda: fresh.step(xg, yg), 3, gains)
    simple = {k: kernels.KERNEL_COUNTS[k].simple_launches
              for k in ("matmul_bn_stats", "bn_act_matmul_stats")}
    plain += sum(c.plain_calls_on_cuda
                 for c in kernels.KERNEL_COUNTS.values())
    resumed = {"losses": losses == ref_losses,
               "params": same_tensors([p.detach() for p in fresh._params],
                                      ref_w6)}
    expect = {"matmul_bn_stats": 20, "bn_stats": 16, "bn_act_matmul_stats": 16}
    want = STEP_LAUNCHES["resnet"]
    log(f"checkpoint resnet: {nbytes} bytes written; save_states held the "
        f"training thread {hold_ms:.3f} ms (its device copies {copy_ms:.3f} "
        f"ms by events; a second save {hold2_ms:.3f} ms, device "
        f"{copy2_ms:.3f} ms); written {commit_s:.3f} s after the call; "
        f"load_states {restore_s:.3f} s; step median of steps 4-6 with the "
        f"save in flight {statistics.median(saving_ms):.3f} ms (steps "
        f"{[round(v, 3) for v in saving_ms]}; steps 10-12 during the second "
        f"save {[round(v, 3) for v in saving2_ms]}), of steps 7-9 without "
        f"{statistics.median(plain_ms):.3f} ms "
        f"({[round(v, 3) for v in plain_ms]}) on {card}")
    log(f"checkpoint resnet: steps 4-6 {ref_losses}, resumed {losses}: "
        f"{resumed}; launches a step {gains}; simple-route launches "
        f"{simple}; plain calls on cuda {plain}")
    checks = {
        "resnet_resumed_losses_bit_identical": resumed["losses"],
        "resnet_resumed_params_bit_identical": resumed["params"],
        "resnet_launches": all(
            g == want and all(g.get(k, {}).get("launches") == v
                              for k, v in expect.items())
            for g in gains),
        "resnet_tma_route": all(v == 0 for v in simple.values()),
        "resnet_plain_calls_on_cuda": plain == 0,
    }

    # the trained weights through a .params file into a fresh ResNet-50
    fresh.sync_to_block()
    del fresh
    torch.cuda.empty_cache()
    fname = os.path.join(tmpdir, "resnet50.params")
    net.save_parameters(fname)
    copy = resnet50(mx, gpu, fuse=True)
    t2 = time.perf_counter()
    copy.load_parameters(fname)
    load_s = time.perf_counter() - t2
    xp = xg[:PREDICT_BATCH].contiguous()
    outs, bam = [], []
    for block in (net, net, copy):   # the source: eager, then captured
        before = counts_now()
        outs.append(block(xp).data.clone())
        torch.cuda.synchronize()
        bam.append(counts_gain(before, counts_now())
                   .get("bn_act_matmul", {}).get("launches", 0))
    same = all(torch.equal(outs[0], o) for o in outs[1:])
    log(f"checkpoint resnet: save_parameters {os.path.getsize(fname)} bytes, "
        f"load_parameters into a fresh resnet50_v1 {load_s:.3f} s; b="
        f"{PREDICT_BATCH} fp32 predict forwards (source eager, source "
        f"captured, copy) bit-identical {same}, bn_act_matmul launches {bam}")
    checks["resnet_params_file_forward_bit_identical"] = same
    checks["resnet_params_file_launches"] = bam == [16, 16, 16]
    del net, copy, xp, outs
    os.remove(fname)
    for p in (prefix, prefix + "-2"):
        for n in ("meta", "shards-p0"):
            os.remove(f"{p}-{n}.npz")
    torch.cuda.empty_cache()
    return checks, {"bytes": nbytes, "save_hold_ms": [hold_ms, hold2_ms],
                    "save_copy_ms": [copy_ms, copy2_ms], "commit_s": commit_s,
                    "restore_s": restore_s,
                    "median_ms_saving": [statistics.median(saving_ms),
                                         statistics.median(saving2_ms)],
                    "median_ms": statistics.median(plain_ms)}


def checkpoints(mx, card):
    """Phase 16 on BERT-base and ResNet-50, in a temporary directory of the
    checkout that is removed after."""
    tmpdir = tempfile.mkdtemp(prefix="ckpt-smoke-", dir=ROOT)
    try:
        checks, bert = checkpoint_bert(mx, card, tmpdir)
        more, resnet = checkpoint_resnet(mx, card, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    checks.update(more)
    log(f"checkpoints: {json.dumps({'bert': bert, 'resnet': resnet})}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"checkpoint checks failed: {failed}")
    return {"bert": bert, "resnet": resnet}


# -- phases 17-18b: Transformer-big and the recurrent cells ------------------


def nmt_blocks(mx):
    """examples/nmt/train_transformer.py's loss and teacher-forcing
    wrapper (copied: the example imports the JAX package)."""

    class LabelSmoothedCE(mx.gluon.loss.Loss):
        """Per-token label-smoothed cross entropy with padding mask."""

        def __init__(self, smoothing=0.1, weight=None, batch_axis=0,
                     **kwargs):
            super().__init__(weight, batch_axis, **kwargs)
            self._eps = smoothing

        def hybrid_forward(self, F, pred, label):
            # pred: (B, T, V) logits; label: (B, T) int (0 = padding)
            logp = F.log_softmax(pred)
            nll = -F.pick(logp, label, axis=-1)
            smooth = -F.mean(logp, axis=-1)
            loss = (1 - self._eps) * nll + self._eps * smooth
            mask = label != 0
            return F.sum(loss * mask) / (F.sum(mask) + 1e-6)

    class Seq2SeqTrainNet(mx.gluon.HybridBlock):
        """Wraps the model with teacher forcing: inputs (src, tgt_in)."""

        def __init__(self, model, **kwargs):
            super().__init__(**kwargs)
            self.model = model

        def hybrid_forward(self, F, src, tgt_in, src_valid_len=None):
            return self.model(src, tgt_in, src_valid_len)

    return LabelSmoothedCE, Seq2SeqTrainNet


def nmt_batches(mx):
    """Encoded pairs from numpy seed 0 through the port's
    ``NMTBucketIter``: the first ``TFM_STEPS`` batches as ``(bucket, (src,
    tgt_in, src_valid_len), tgt_out)``.  Each pair is the example's copy
    task (the target is the source, BOS 1 before it, EOS 2 after both)
    over ids 3..31,999 drawn with Zipf's law (exponent 1.1, as words
    are), at lengths uniform within each bucket, so most rows are
    padded."""
    import numpy as np

    from mxnet_tpu_torch.data import nmt

    rng = np.random.RandomState(0)
    zipf = 1.0 / np.arange(1, TFM_VOCAB - 2) ** 1.1
    zipf /= zipf.sum()
    pairs, lo = [], 0
    for hi in TFM_BUCKETS:
        for _ in range(TFM_BATCHES_A_BUCKET * TFM_BATCH):
            n = rng.randint(max(lo + 1, 2), hi + 1)
            ids = [int(i) + 3 for i in rng.choice(TFM_VOCAB - 3, n - 1,
                                                  p=zipf)]
            pairs.append((ids + [2], [1] + ids + [2]))
        lo = hi
    it = nmt.NMTBucketIter(pairs, TFM_BATCH, buckets=TFM_BUCKETS, seed=0)
    if it.dropped:
        raise SystemExit(f"nmt data: {it.dropped} pairs fit no bucket")
    out = []
    for _ in range(TFM_STEPS):
        b = it.next()
        src, tgt_in = b.data
        out.append((b.bucket_key, (src, tgt_in, b.src_valid_length),
                    b.label[0]))
    return out


def transformer_train_net(mx, seed=0):
    """``Seq2SeqTrainNet(transformer_big(32000, 32000))`` on the card,
    Xavier from ``seed`` (the generators reseeded first, so two nets made
    alike draw the same dropout masks)."""
    _, seq2seq = nmt_blocks(mx)
    mx.random.seed(seed)
    net = seq2seq(mx.models.transformer_big(TFM_VOCAB, TFM_VOCAB))
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    return net


def transformer_steps(mx, trainer, batches):
    """One ``trainer.step`` a batch, each timed to the loss on the host;
    returns ``(losses, step ms, launches gained a step, parameters after
    4 steps)``."""
    import torch

    losses, step_ms, gains, after4 = [], [], [], None
    for i, (_, x, y) in enumerate(batches):
        before = counts_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.step(x, y).asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gains.append(counts_gain(before, counts_now()))
        if i == 3:
            after4 = [p.detach().clone() for p in trainer._params]
    return losses, step_ms, gains, after4


def bucket_rates(batches, step_ms, skip):
    """``{bucket: (median ms, source+target tokens/s)}`` over each bucket's
    steps after its first ``skip`` (the eager first step; the captured
    run's warm-up and capture)."""
    out = {}
    for key in TFM_BUCKETS:
        ms = [t for (b, _, _), t in zip(batches, step_ms) if b == key]
        med = statistics.median(ms[skip:])
        out[key] = (med, 2 * TFM_BATCH * key / (med / 1e3))
    return out


def train_transformer(mx, card):
    """Phase 17: 20 eager ``DataParallelTrainer`` steps of Transformer-big
    on the bucketed batches, then the same 20 from the same weights
    captured; then card vs CPU.  Returns ``(eager launches, the captured
    trainer's net, the starting weights)``."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _imperative
    from mxnet_tpu_torch.gluon import trainer as mtrainer
    from mxnet_tpu_torch.models.transformer import positional_encoding
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import DataParallelTrainer

    ce, _ = nmt_blocks(mx)
    batches = nmt_batches(mx)
    pos = torch.from_numpy(positional_encoding(
        512, TFM_WIDTHS["units"])).cuda()
    attn = ("flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")
    runs = {}
    for capture in (False, True):
        net = transformer_train_net(mx)
        trainer = DataParallelTrainer(net, ce(), "adam", dict(TFM_OPT),
                                      capture=capture)
        trainer.build(batches[0][1])  # completes the deferred shapes
        if not capture:
            start = {k: p.data().detach().cpu().numpy().copy() for k, p in
                     net.model._collect_params_with_prefix().items()}
            n_params = sum(v.size for k, v in start.items()
                           if k != "pos_const")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        mtrainer.reset_trainer_step_stats()
        c0 = _imperative.graph_capture_count()
        r0 = _imperative.graph_replay_count()
        losses, step_ms, gains, after4 = transformer_steps(
            mx, trainer, batches)
        runs[capture] = dict(
            losses=losses, step_ms=step_ms, gains=gains, after4=after4,
            total={k: kernels.KERNEL_COUNTS[k].launches for k in attn},
            plain=sum(c.plain_calls_on_cuda
                      for c in kernels.KERNEL_COUNTS.values()),
            captures=_imperative.graph_capture_count() - c0,
            replays=_imperative.graph_replay_count() - r0,
            graphs=len(trainer._graphs),
            fallbacks=mtrainer.trainer_step_stats()["whole_step_fallbacks"],
            peak=torch.cuda.max_memory_allocated() / 2**30,
            rates=bucket_rates(batches, step_ms, 2 if capture else 1))
        const = next(raw for (_, p), raw in zip(trainer._named,
                                                trainer._params)
                     if p is net.model.pos_const)
        runs[capture]["const_kept"] = bool(torch.equal(const, pos))
        if capture:
            trainer.sync_to_block()
            runs[capture]["block_const_kept"] = bool(torch.equal(
                net.model.pos_const.data(), pos))
        else:
            del net
        del trainer
        torch.cuda.empty_cache()
    eager, cap = runs[False], runs[True]
    want = {k: TFM_ATTENTIONS for k in attn}
    keys = [b for b, _, _ in batches]
    log(f"transformer: Transformer-big ({n_params} parameters, 6+6 layers, "
        f"1024 units, 16 heads of 64, FFN 4096, dropout 0.3, vocab "
        f"{TFM_VOCAB}) through DataParallelTrainer, Adam lr "
        f"{TFM_OPT['learning_rate']} beta2 {TFM_OPT['beta2']}, label "
        f"smoothing 0.1, fp32 TF32 off, batch {TFM_BATCH}, buckets "
        f"{keys} on {card}")
    for label, run in (("eager", eager), ("captured", cap)):
        log(f"transformer {label}: loss {run['losses'][0]:.4f} -> "
            f"{run['losses'][-1]:.4f}; per bucket (median ms, src+tgt "
            f"tokens/s, padded) " + ", ".join(
                f"{k}: {ms:.3f} ms {tps:.0f}"
                for k, (ms, tps) in run["rates"].items())
            + f"; first step {run['step_ms'][0]:.1f} ms; peak memory "
            f"{run['peak']:.2f} GiB; launches {run['total']} "
            f"({TFM_ATTENTIONS} x {TFM_STEPS} each); plain calls on cuda "
            f"{run['plain']}")
    log(f"transformer: losses eager {[round(v, 4) for v in eager['losses']]}")
    log(f"transformer captured: graphs captured {cap['captures']} (one a "
        f"bucket: {cap['graphs']} held), replays {cap['replays']}, "
        f"whole_step_fallbacks {cap['fallbacks']}; first 4 losses "
        f"{cap['losses'][:4]}, eager {eager['losses'][:4]}")
    same_params = all(torch.equal(a, b) for a, b in
                      zip(cap["after4"], eager["after4"]))
    checks = {
        "finite_losses": bool(np.isfinite(eager["losses"]).all()
                              and np.isfinite(cap["losses"]).all()),
        "loss_falls": np.mean(eager["losses"][-5:]) < eager["losses"][0],
        "launches_a_step": all(
            {k: g.get(k, {}).get("launches", 0) for k in attn} == want
            for run in (eager, cap) for g in run["gains"]),
        "plain_calls_on_cuda": eager["plain"] == cap["plain"] == 0,
        "one_graph_a_bucket": cap["captures"] == cap["graphs"]
        == len(TFM_BUCKETS),
        "replay_a_step": cap["replays"] == TFM_STEPS - len(TFM_BUCKETS),
        "no_fallback": cap["fallbacks"] == 0,
        "captured_losses_bit_identical": cap["losses"][:4]
        == eager["losses"][:4],
        "captured_params_bit_identical": same_params,
        "constant_unchanged": eager["const_kept"] and cap["const_kept"]
        and cap["block_const_kept"],
    }
    for run in (eager, cap):
        run.pop("after4")
    checks.update(transformer_card_vs_cpu(mx, start, batches, ce))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"transformer checks failed: {failed}")
    return eager["total"], net, start


def big_model(mx, ctx, weights, dropout):
    """Transformer-big with ``dropout`` on ``ctx`` holding ``weights``."""
    model = mx.models.transformer.TransformerModel(
        TFM_VOCAB, TFM_VOCAB, dropout=dropout, **TFM_WIDTHS)
    model.initialize(mx.init.Zero(), ctx=ctx)
    mx.load_numpy_params(model, weights)
    return model


def transformer_card_vs_cpu(mx, weights, batches, ce):
    """The starting weights with dropout 0, batch 2 at bucket 16, through
    ``autograd.record``/``backward``/``gluon.Trainer`` (Adam) on the card
    and on the CPU: the first loss, ``dec_layers.0.cross_in_weight``'s
    gradient and the losses of 2 steps must agree."""
    import numpy as np

    _, x, y = next(b for b in batches if b[0] == TFM_BUCKETS[0])
    small = [a[:2] for a in x] + [y[:2]]
    out = []
    for ctx in (mx.gpu(0), mx.cpu()):
        model = big_model(mx, ctx, weights, 0.0)
        arrays = [mx.nd.array(a, ctx=ctx) for a in small]
        trainer = mx.gluon.Trainer(model.collect_params(), "adam",
                                   dict(TFM_OPT))
        loss_fn = ce()
        losses = []
        for step in range(2):
            with mx.autograd.record():
                loss = loss_fn(model(*arrays[:3]), arrays[3])
            loss.backward()
            if step == 0:
                grad = model.dec_layers[0].cross_in_weight.grad() \
                    .detach().cpu().numpy().copy()
            trainer.step(1)
            losses.append(loss.asscalar())
        out.append((losses, grad))
        del model, trainer
    (gl, gg), (cl, cg) = out
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    grad_err = float(np.abs(gg - cg).max() / np.abs(cg).max())
    log(f"transformer: card vs cpu, batch 2 at bucket {TFM_BUCKETS[0]}, "
        f"dropout 0, 2 Adam steps: losses card {gl} cpu {cl}, max rel err "
        f"{loss_err:.3g} (rtol {TRAIN_LOSS_RTOL}); dec_layers.0."
        f"cross_in_weight gradient max abs err / max |grad| {grad_err:.3g} "
        f"(rtol {TRAIN_GRAD_RTOL})")
    return {"card_vs_cpu_loss": loss_err <= TRAIN_LOSS_RTOL,
            "card_vs_cpu_grad": grad_err <= TRAIN_GRAD_RTOL}


def live_prefix(seq, eos=2):
    seq = list(seq)
    return seq[:seq.index(eos) + 1] if eos in seq else seq


def eos_model(mx, weights, s, v):
    """Phase 17's starting weights with ``out_proj``'s bias reset so that
    the argmax moves from step to step and some rows end early.

    Deep and untrained, the model maps every position to nearly the same
    last hidden state, so one token wins everywhere.  The bias first
    subtracts the mean logits of a teacher-forced pass (BOS and the
    source as the target), which leaves the part of the logits that
    moves with the position and the row.  Then EOS's bias is raised: along
    the greedy path of the centred model (eager, not hybridized), a row's
    first EOS comes at the first step where its EOS logit plus the rise
    beats every other logit; until then its path is the centred one.  The
    rise is set halfway between the 4th and 5th smallest of the rows'
    least gaps over the first 15 steps, so that half the rows are
    expected to emit EOS by step 15.  Returns ``(model, rise, the rows
    expected to)``."""
    import numpy as np
    import torch

    eos = 2
    model = big_model(mx, mx.gpu(0), weights, 0.3)
    bias = model.out_proj.bias.data()

    def logits(tgt):
        tgt = torch.from_numpy(np.ascontiguousarray(tgt, np.int32))
        return model(s.data, tgt.to(s.data.device), v.data).detach()

    src = s.asnumpy().astype(np.int32)
    forced = np.concatenate([np.ones_like(src[:, :1]), src[:, :-1]], axis=1)
    with torch.no_grad():
        bias.sub_(logits(forced).mean(dim=(0, 1)))
    greedy = model.greedy_decode(s, max_len=TFM_DECODE_LEN, src_valid_len=v)
    lg = logits(greedy[:, :-1]).cpu().numpy()
    gap = np.delete(lg, eos, axis=-1).max(-1) - lg[..., eos]
    least = gap[:, :15].min(axis=1)
    rise = float(np.sort(least)[3:5].mean())
    with torch.no_grad():
        bias[eos] += rise
    return model, rise, np.flatnonzero(least < rise).tolist()


def decode_transformer(mx, card, model, s, v, label, varied=False):
    """Phase 18: ``model`` (phase 17's trained model, or with ``varied``
    :func:`eos_model`'s), hybridized, in predict mode, decodes the 8
    bucket-32 sources ``s`` greedily and by beam search, three times each
    (the eager warm-up, the captures, the replays), then once more not
    hybridized (the eager forward at shapes already seen).  With
    ``varied`` the decoded tokens must differ, across the rows and along
    one at least, and some rows of both decodes must end with EOS.  Returns the forward launches of the three
    calls."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _imperative
    from mxnet_tpu_torch.ops import kernels

    model.hybridize()
    kernels.reset_counts()
    c0 = _imperative.graph_capture_count()
    runs, times = [], []
    for _ in range(3):
        call = []
        for fn in (lambda: model.greedy_decode(
                       s, max_len=TFM_DECODE_LEN, src_valid_len=v),
                   lambda: model.beam_search_decode(
                       s, beam_size=TFM_BEAM, max_len=TFM_DECODE_LEN,
                       alpha=TFM_ALPHA, src_valid_len=v)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call.append(fn())
            call.append((time.perf_counter() - t0) * 1e3)
        runs.append(call[0::2])
        times.append(call[1::2])
    launches = kernels.KERNEL_COUNTS["flash_attention_fwd"].launches
    plain = sum(c.plain_calls_on_cuda for c in kernels.KERNEL_COUNTS.values())
    captures = _imperative.graph_capture_count() - c0
    sigs = model._cached_op._seen_sigs
    beam_steps = sum(1 for sig in sigs
                     if sig[2][0][0][0] == TFM_BEAM * TFM_DECODE_ROWS)
    greedy, (seqs, scores) = runs[0]
    greedy_steps = greedy.shape[1] - 1
    same = all(np.array_equal(g, greedy) and np.array_equal(b[0], seqs)
               and np.array_equal(b[1], scores) for g, b in runs[1:])
    beam1, _ = model.beam_search_decode(s, beam_size=1,
                                        max_len=TFM_DECODE_LEN,
                                        src_valid_len=v)
    beam1_ok = all(
        g[:len(b)] == b or b[:len(g)] == g
        for g, b in ((live_prefix(g), live_prefix(b))
                     for g, b in zip(greedy, beam1)))
    vs_cpu = decode_card_vs_cpu(mx, model, s, v, greedy, label)
    # the eager forward once every shape has been seen (the warm-up call
    # also meets each shape first: the wrappers' and cuBLAS's first calls)
    model.hybridize(False)
    for fn in (lambda: model.greedy_decode(
                   s, max_len=TFM_DECODE_LEN, src_valid_len=v),
               lambda: model.beam_search_decode(
                   s, beam_size=TFM_BEAM, max_len=TFM_DECODE_LEN,
                   alpha=TFM_ALPHA, src_valid_len=v)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    eager_same = np.array_equal(runs[-2], greedy) and all(
        np.array_equal(a, b) for a, b in zip(runs[-1], (seqs, scores)))
    for kind, i, steps in (("greedy", 0, greedy_steps),
                           ("beam", 1, beam_steps)):
        log(f"decode {label} {kind}: {steps} steps; " + "; ".join(
            f"{what} {ms:.1f} ms ({ms / steps:.3f} ms a step, "
            f"{ms / TFM_DECODE_ROWS:.2f} ms a sentence)"
            for what, ms in (("warm-up (eager, each shape's first call)",
                              times[0][i]),
                             ("captures", times[1][i]),
                             ("replayed", times[2][i]),
                             ("eager, not hybridized", times[3 + i])))
            + f" on {card}")
    log(f"decode {label}: greedy {greedy.tolist()[:2]}...; beam scores "
        f"{scores.tolist()}; graphs captured {captures} for {len(sigs)} "
        f"signatures; forward launches {launches} ({TFM_ATTENTIONS} x 3 x "
        f"{greedy_steps + beam_steps}); plain calls on cuda {plain}; three "
        f"calls bit-identical {same}, and the unhybridized call "
        f"{eager_same}; beam 1 == greedy {beam1_ok}")
    checks = {"calls_bit_identical": same and eager_same,
              "one_graph_a_signature": captures == len(sigs)
              == greedy_steps + beam_steps,
              "beam1_is_greedy": beam1_ok,
              "launches_a_step": launches == TFM_ATTENTIONS * 3 * (
                  greedy_steps + beam_steps),
              "plain_calls_on_cuda": plain == 0,
              "finite_scores": bool(np.isfinite(scores).all())}
    if varied:
        live = [live_prefix(g)[1:] for g in greedy]
        ended = {"greedy": [i for i, g in enumerate(live) if g[-1:] == [2]],
                 "beam": [i for i, b in enumerate(seqs) if 2 in b[1:]]}
        words = [[t for t in g if t != 2] for g in live]
        distinct = len({t for w in words for t in w})
        moving = [i for i, w in enumerate(words) if len(set(w)) > 1]
        log(f"decode {label}: {distinct} distinct tokens but EOS over the "
            f"greedy rows' live prefixes, rows whose token moves {moving}; "
            f"rows ended with EOS: greedy "
            f"{ended['greedy']} (at steps "
            f"{[len(live[i]) for i in ended['greedy']]}), beam "
            f"{ended['beam']}; greedy ran {greedy_steps} steps, beam "
            f"{beam_steps} of {TFM_DECODE_LEN - 1}; beam's output widths "
            f"{[len(live_prefix(b)) for b in seqs]} padded to "
            f"{seqs.shape[1]}")
        checks.update(tokens_vary=distinct > 1 and bool(moving),
                      greedy_rows_end=bool(ended["greedy"]),
                      beam_rows_end=bool(ended["beam"]))
    checks.update(vs_cpu)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"decode {label} checks failed: {failed}")
    return launches


def decode_card_vs_cpu(mx, model, s, v, greedy, label):
    """The CPU, fed the card's greedy sequences (teacher forcing, one
    call), against the card's last-position logits at each step (the
    replayed prefixes): within ``CPU_ATOL``, and the card's token the
    CPU's argmax wherever the CPU's top-2 margin is above ``TFM_MARGIN``."""
    import numpy as np

    card = np.stack([model(s.data, mx.nd.array(greedy[:, :t + 1],
                                               ctx=mx.gpu(0)).data,
                           v.data)[:, -1].cpu().numpy()
                     for t in range(greedy.shape[1] - 1)], axis=1)
    # card: (rows, steps, vocab), the logits each decode step read
    weights = {k: p.data().detach().cpu().numpy() for k, p in
               model._collect_params_with_prefix().items()}
    cpu_model = big_model(mx, mx.cpu(), weights, 0.3)
    cpu = mx.nd.array(greedy[:, :-1], ctx=mx.cpu())
    logits = cpu_model(mx.nd.array(s.asnumpy(), ctx=mx.cpu()), cpu,
                       mx.nd.array(v.asnumpy(), ctx=mx.cpu())).asnumpy()
    err = float(np.abs(logits - card).max())
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > TFM_MARGIN
    agree = logits.argmax(-1) == greedy[:, 1:]
    log(f"decode {label}: card vs cpu (teacher forcing) last-position "
        f"logits max "
        f"abs err {err:.3g} over {card.shape[:2]} steps (atol {CPU_ATOL}); "
        f"{int(sure.sum())} of {sure.size} steps with a CPU top-2 margin "
        f"above {TFM_MARGIN}, the card's token the CPU's argmax at "
        f"{int((agree & sure).sum())} of them (and at "
        f"{int(agree.sum())} of all)")
    return {"card_vs_cpu_logits": err <= CPU_ATOL,
            "card_vs_cpu_tokens": bool(agree[sure].all())}


def check_cells(mx, card):
    """Phase 18b: ``HybridSequentialRNNCell`` of two ``LSTMCell(200)`` and
    of two ``GRUCell(200)``, unrolled over T=35, N=32 TNC on the card,
    given the weights of ``gluon.rnn.LSTM(200, num_layers=2)`` and
    ``GRU``, whose recurrence kernels (rows 11 and 13) are the yardstick:
    outputs within ``CELL_RTOL`` of the largest.  Returns the fused
    layers' forward launches, and the same by route."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels

    gpu = mx.gpu(0)
    rnn = mx.gluon.rnn
    launches, routes, failed = {}, {}, []
    for cell_cls, layer_cls, kernel in ((rnn.LSTMCell, rnn.LSTM, "lstm_fwd"),
                                        (rnn.GRUCell, rnn.GRU, "gru_fwd")):
        mx.random.seed(0)
        fused = layer_cls(GRU_HIDDEN, num_layers=2)
        fused.initialize(mx.init.Xavier(), ctx=gpu)
        x = mx.nd.array(np.random.RandomState(11).randn(
            GRU_T, GRU_BATCH, GRU_HIDDEN).astype(np.float32) * 0.5, ctx=gpu)
        kernels.reset_counts()
        want = fused(x)
        torch.cuda.synchronize()
        launches[kernel] = kernels.KERNEL_COUNTS[kernel].launches
        routes[kernel] = launches_by_route(kernels.KERNEL_COUNTS[kernel])
        stack = rnn.HybridSequentialRNNCell()
        for _ in range(2):
            stack.add(cell_cls(GRU_HIDDEN))
        stack.initialize(ctx=gpu)
        fp = fused._collect_params_with_prefix()
        mx.load_numpy_params(stack, {
            f"{layer}.{kind}": fp[f"l{layer}_{kind}"].data().detach().cpu()
            .numpy() for layer in range(2)
            for kind in ("i2h_weight", "h2h_weight", "i2h_bias",
                         "h2h_bias")})
        got, _ = stack.unroll(GRU_T, x, layout="TNC")
        want = want.asnumpy()
        err = float(np.abs(got.asnumpy() - want).max() / np.abs(want).max())
        ok = err <= CELL_RTOL and launches[kernel] == 2
        log(f"cells: 2 x {cell_cls.__name__}({GRU_HIDDEN}) unrolled T="
            f"{GRU_T} N={GRU_BATCH} TNC against {layer_cls.__name__}("
            f"{GRU_HIDDEN}, num_layers=2) ({launches[kernel]} {kernel} "
            f"launches) on {card}: max err / max |out| {err:.3g} (rtol "
            f"{CELL_RTOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(cell_cls.__name__)
    if failed:
        raise SystemExit(f"cells disagree with the fused layers: {failed}")
    return launches, routes


# -- phase 19: the kvstore on the card ----------------------------------------


def kv_api(mx, kv_type, ctxs, data):
    """init, push, pull, pushpull, broadcast, 2-bit compression (3 pushes)
    and ``set_optimizer`` (3 pushes each of SGD with momentum and Adam) of
    one key over ``ctxs``, from the numpy arrays of ``data``; every result
    as numpy, by name."""
    import numpy as np

    from mxnet_tpu_torch import kvstore as kvs

    def arr(a, c):
        return mx.nd.array(a, ctx=c)

    res = {}
    kv = kvs.create(kv_type)
    kv.init("w", arr(data["init"], ctxs[0]))
    kv.push("w", [arr(v, c) for v, c in zip(data["vals"], ctxs)])
    outs = [arr(np.zeros_like(data["init"]), c) for c in ctxs]
    kv.pull("w", out=outs)
    res["pull"] = [o.asnumpy() for o in outs]
    vs = [arr(v * 2 + 1, c) for v, c in zip(data["vals"], ctxs)]
    kv.pushpull("w", vs, out=vs)
    res["pushpull"] = [v.asnumpy() for v in vs]
    outs = [arr(np.zeros_like(data["init"]), c) for c in ctxs]
    kv.broadcast("b", arr(data["init"] * 3, ctxs[-1]), out=outs)
    res["broadcast"] = [o.asnumpy() for o in outs]
    kc = kvs.create(kv_type)
    kc.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kc.init(0, arr(np.zeros_like(data["init"]), ctxs[0]))
    for step, grads in enumerate(data["compress"]):
        vs = [arr(g, c) for g, c in zip(grads, ctxs)]
        kc.pushpull(0, vs, out=vs)
        res[f"compression_{step}"] = [v.asnumpy() for v in vs]
    for opt, args in KV_OPTIMIZERS:
        ko = kvs.create(kv_type)
        ko.set_optimizer(mx.optimizer.create(opt, **args))
        ko.init(0, arr(data["init"], ctxs[0]))
        for step, grads in enumerate(data["compress"]):
            ko.push(0, [arr(g, c) for g, c in zip(grads, ctxs)])
            o = arr(np.zeros_like(data["init"]), ctxs[-1])
            ko.pull(0, out=o)
            res[f"{opt}_{step}"] = [o.asnumpy()]
    return res


def bert_gradient_shapes(mx):
    """The shapes of BERT-base's trainable parameters (MLM+NSP)."""
    import numpy as np

    net = pretrain_net(mx, mx.gpu(0), dropout=0.0)
    data = synthetic_batch(np.random.RandomState(0), 2, 32, 30522)
    with mx.autograd.pause():
        net(*[mx.nd.array(a, ctx=mx.gpu(0)) for a in data])
    return [tuple(p.shape) for p in net.collect_params().values()
            if p.grad_req != "null"]


def kv_fused(mx, kv_type, slots, card_grads):
    """One multi-key pushpull of BERT-base's gradients (two values a key)
    into the values themselves; returns the stats and the results as CPU
    tensors."""
    from mxnet_tpu_torch import kvstore as kvs

    kv = kvs.create(kv_type)
    grads = [[g.to(c.torch_device(), copy=True) for g in slot]
             for slot, c in zip(card_grads, slots)]
    keys = list(range(len(grads[0])))
    for k in keys:
        kv.init(k, mx.nd.NDArray(grads[0][k].clone(), slots[0]))
    vals = [[mx.nd.NDArray(grads[s][k], slots[s]) for s in range(len(slots))]
            for k in keys]
    stats = kv.pushpull(keys, vals, out=vals)
    return kv, keys, vals, stats, [v[0].data.to("cpu", copy=True)
                                   for v in vals]


def check_kvstore(mx, card):
    """Phase 19: ``KVStore('device')`` and ``('nccl')`` on CUDA tensors
    against the same calls on CPU copies, bit for bit: init, push and pull
    of 5 values a key, pushpull, broadcast, 2-bit compression and
    ``set_optimizer``; then the fused multi-key pushpull of every
    BERT-base gradient (two values a key), timed.  Returns the fused
    pushpull's record."""
    import numpy as np
    import torch

    n_gpu = torch.cuda.device_count()
    rng = np.random.RandomState(19)
    data = {"init": rng.randn(256, 768).astype(np.float32),
            "vals": [rng.randn(256, 768).astype(np.float32)
                     for _ in range(KV_SLOTS)],
            "compress": [[(rng.randn(256, 768) * 0.6).astype(np.float32)
                          for _ in range(KV_SLOTS)] for _ in range(3)]}
    gpus = [mx.gpu(i % n_gpu) for i in range(KV_SLOTS)]
    cpus = [mx.cpu(i) for i in range(KV_SLOTS)]
    failed = []
    for kv_type in ("device", "nccl"):
        got = kv_api(mx, kv_type, gpus, data)
        want = kv_api(mx, kv_type, cpus, data)
        differ = {}
        for name in want:
            n_diff = sum(int((a != b).sum())
                         for a, b in zip(got[name], want[name]))
            if n_diff:
                differ[name] = (n_diff, max(
                    float(np.abs(a - b).max() / np.abs(b).max())
                    for a, b in zip(got[name], want[name])))
        log(f"kvstore {kv_type!r}: {KV_SLOTS} values a key on "
            f"{[str(c) for c in gpus]} against {[str(c) for c in cpus]}: "
            f"{len(want)} results ({', '.join(want)}); values that differ "
            f"(count, max err / max |value|): {differ or 'none'}")
        # Adam's sqrt rounds otherwise on the card (below): its updates
        # are held within KV_ADAM_RTOL, everything else bit for bit
        failed += [f"{kv_type}:{name}" for name, (_, err) in differ.items()
                   if not (name.startswith("adam") and err <= KV_ADAM_RTOL)]
    v = torch.from_numpy(np.abs(data["init"]) * 1e-2)
    sqrt_diff = {
        name: int((fn(v.cuda()).cpu() != fn(v)).sum())
        for name, fn in (("torch.sqrt", torch.sqrt),
                         ("torch._foreach_sqrt",
                          lambda t: torch._foreach_sqrt([t])[0]))}
    log(f"kvstore: the square roots of the same {v.numel()} fp32 values on "
        f"the card and on the CPU differ at {sqrt_diff} of them (Adam's "
        f"denominator; its results are held within {KV_ADAM_RTOL} "
        f"relative)")
    shapes = bert_gradient_shapes(mx)
    gen = torch.Generator(device="cuda").manual_seed(19)
    card_grads = [[torch.randn(s, generator=gen, device="cuda")
                   for s in shapes] for _ in range(2)]
    nbytes = sum(4 * int(np.prod(s)) for s in shapes)
    record = {}
    for kv_type in ("device", "nccl"):
        slots = [mx.gpu(s % n_gpu) for s in range(2)]
        kv, keys, vals, stats, got = kv_fused(mx, kv_type, slots,
                                              card_grads)
        ms = cuda_ms(lambda: kv.pushpull(keys, vals, out=vals), KV_ITERS,
                     warmup=1)
        del kv, vals
        _, _, _, cpu_stats, want = kv_fused(
            mx, kv_type, [mx.cpu(0), mx.cpu(1)], card_grads)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"kvstore {kv_type!r}: fused pushpull of BERT-base's {len(keys)} "
            f"gradients ({nbytes / 2**20:.1f} MiB a value, 2 values a key, "
            f"MXTPU_KVSTORE_BUCKET_MB default 32) on {[str(c) for c in slots]}: "
            f"{stats['buckets']} buckets, {stats['dispatches']} dispatches "
            f"(cpu(0), cpu(1): {cpu_stats['buckets']} buckets, "
            f"{cpu_stats['dispatches']} dispatches), {ms:.3f} ms a call "
            f"(CUDA events, {KV_ITERS} calls) on {card}; against the CPU "
            f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            failed.append(f"{kv_type}:fused")
        record[kv_type] = {"keys": len(keys), "bytes": nbytes,
                           "buckets": stats["buckets"],
                           "dispatches": stats["dispatches"], "ms": ms}
        del got, want
    del card_grads
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"kvstore on the card disagrees with the CPU: "
                         f"{failed}")
    return record


# -- phases 20 and 20b: BERT-base under dist_sync, and over several cards -----


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_port_pair():
    """A free port whose successor is free too (the launcher's parameter
    server binds PORT + 1)."""
    import socket

    for _ in range(50):
        port = free_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
    raise SystemExit("no free pair of ports")


def dist_halves(mx, data, ctx, parts):
    """The batch's rows split into ``parts`` equal slices, as NDArrays on
    ``ctx`` (a context, or one a slice)."""
    n = DIST_BATCH // parts
    ctxs = ctx if isinstance(ctx, list) else [ctx] * parts
    return [[mx.nd.array(a[r * n:(r + 1) * n], ctx=ctxs[r]) for a in data]
            for r in range(parts)]


def bert_ranks_worker(workdir):
    """A rank of phases 20, 23, 24, 25, 21, 22, 38, 39 and 40
    (``chip_smoke.py --bert-ranks-worker DIR`` under the port's launcher
    with one parameter server): one process group, the phases in turn
    (:func:`dist_worker`, :func:`zero_worker`, :func:`spmd_worker`,
    :func:`pp_worker`, :func:`mesh_phases`, :func:`async_worker`,
    :func:`elastic_worker`), as the tests share one launch."""
    import logging

    import torch

    sys.path.insert(0, str(ROOT))
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workdir = Path(workdir)
    dist.init()
    rank = dist.rank()
    ctx = mx.gpu(rank if torch.cuda.device_count() >= DIST_RANKS else 0)
    torch.cuda.set_device(ctx.device_id)
    for phase in (dist_worker, zero_worker, spmd_worker, pp_worker):
        phase(mx, ctx, rank, workdir)
        torch.cuda.empty_cache()
    mesh_phases(mx, ctx, workdir, "resnet,bert,moe")
    # phases 39 and 40 last: rank 1 leaves during phase 40
    out = {"rank": rank, "backend": dist.backend(), "device": str(ctx)}
    async_worker(mx, ctx, rank, workdir, out)
    torch.cuda.empty_cache()
    elastic_worker(mx, ctx, rank, workdir, out)
    with open(workdir / f"elastic-rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.shutdown()
    return 0


def dist_worker(mx, ctx, rank, workdir):
    """Phase 20 on one rank: BERT-base MLM+NSP from ``DIR/start.params``
    trains ``DIST_STEPS`` Adam steps on its half of ``DIR/batch.npz``
    through ``Trainer(kvstore='dist_sync')``, and writes
    ``DIR/rank<r>.json``."""
    import hashlib

    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.parallel import dist

    npz = np.load(workdir / "batch.npz")
    data = [npz[f"arr_{i}"] for i in range(len(npz.files))]
    batch = dist_halves(mx, data, ctx, DIST_RANKS)[rank]
    net = pretrain_net(mx, ctx, dropout=0.0)
    net.load_parameters(str(workdir / "start.params"), ctx=ctx)
    params = net._collect_params_with_prefix()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               dict(DIST_ADAM), kvstore="dist_sync")
    timed = {"ms": 0.0, "bytes": 0, "calls": 0}
    allreduce = dist.allreduce

    def timed_allreduce(value):
        t = value.data if isinstance(value, mx.nd.NDArray) else value
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = allreduce(value)
        torch.cuda.synchronize()
        timed["ms"] += (time.perf_counter() - t0) * 1e3
        timed["bytes"] += t.numel() * t.element_size()
        timed["calls"] += 1
        return out

    dist.allreduce = timed_allreduce
    out = {"rank": rank, "backend": dist.backend(), "device": str(ctx),
           "losses": [], "digests": [], "step_ms": [], "allreduce_ms": [],
           "allreduce_bytes": [], "allreduce_calls": []}
    kernels.reset_counts()
    for _ in range(DIST_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            loss = net(*batch)
        loss.backward()
        for k in ("ms", "bytes", "calls"):
            timed[k] = 0
        trainer.step(DIST_RANKS)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["allreduce_ms"].append(timed["ms"])
        out["allreduce_bytes"].append(timed["bytes"])
        out["allreduce_calls"].append(timed["calls"])
        total = allreduce(mx.nd.NDArray(loss.data.detach().reshape(1)))
        out["losses"].append(float(total.asnumpy()[0]) / DIST_RANKS)
        h = hashlib.sha256()
        for p in params.values():
            h.update(p.data().detach().cpu().numpy().tobytes())
        out["digests"].append(h.hexdigest())
    out["launches"] = {name: c.launches
                       for name, c in kernels.KERNEL_COUNTS.items()
                       if name.startswith("flash_attention")}
    out["plain_calls_on_cuda"] = fa.counts.plain_calls_on_cuda
    start = mx.nd.load(str(workdir / "start.params"))
    out["not_finite"] = [k for k, p in params.items()
                         if not bool(torch.isfinite(p.data()).all())]
    out["unchanged"] = [
        k for k, p in params.items() if p.grad_req != "null"
        and torch.equal(p.data().detach().cpu(), start[k].data)]
    dist.allreduce = allreduce
    with open(workdir / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def dist_reference(mx, net, data, ctxs):
    """One process: the batch as ``len(ctxs)`` slices, one a context of
    ``ctxs`` (a single context takes every slice), summed into one step;
    returns the losses (the mean of the slices') and the launches."""
    import torch

    from mxnet_tpu_torch.ops import kernels

    parts = dist_halves(mx, data, ctxs if len(ctxs) > 1 else ctxs[0],
                        DIST_RANKS)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(DIST_ADAM))
    losses, step_ms = [], []
    kernels.reset_counts()
    for _ in range(DIST_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.record():
            ls = [net(*p) for p in parts]
        mx.autograd.backward(ls)
        trainer.step(DIST_RANKS)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(sum(float(l.asscalar()) for l in ls) / DIST_RANKS)
    launches = {name: c.launches for name, c in kernels.KERNEL_COUNTS.items()
                if name.startswith("flash_attention")}
    return losses, launches, step_ms


def train_bert_dist(mx, card):
    """Phase 20: BERT-base MLM+NSP (12 layers, 768, fp32, dropout 0, Adam)
    trained by 2 ranks that the port's launcher starts, each on its half of
    a batch of DIST_BATCH x DIST_SEQ, for DIST_STEPS steps through
    ``Trainer(kvstore='dist_sync')``; rank r on gpu(r) with 2 or more
    cards (NCCL), both on gpu(0) with one (gloo).  Gates: the backend the
    rule names, both ranks' parameters bit-identical after every step,
    every trainable parameter finite and changed, 12 launches of each
    flash kernel a rank a step, no plain call, and the losses within
    ``DIST_LOSS_RTOL`` of one process training the same halves on gpu(0).
    Phase 20b then runs ``kvstore='device'`` over gpu(0) and gpu(1) where
    there are 2 cards.  Returns the launches by path."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.parallel import dist

    gpu = mx.gpu(0)
    n_gpu = torch.cuda.device_count()
    want_backend = dist.choose_backend(DIST_RANKS)
    data = synthetic_batch(np.random.RandomState(20), DIST_BATCH, DIST_SEQ,
                           30522)
    checks, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="dist-smoke-", dir=ROOT) as d:
        d = Path(d)
        np.savez(d / "batch.npz", *data)
        net = pretrain_net(mx, gpu, dropout=0.0)
        with mx.autograd.pause():
            net(*[mx.nd.array(a[:2], ctx=gpu) for a in data])
        net.save_parameters(str(d / "start.params"))
        torch.cuda.synchronize()
        pp = pp_inputs(mx, d)
        mesh_refs = (mesh_resnet_reference(mx, d), mesh_bert_reference(mx, d),
                     mesh_moe_reference(mx, d))
        # one launch, with a parameter server, for phases 20, 23, 24, 25,
        # 21, 22, 38, 39 and 40 (bert_ranks_worker)
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
               str(DIST_RANKS), "-s", "1", "--launcher", "local", "-p",
               str(free_port_pair()), sys.executable,
               str(ROOT / "chip_smoke.py"), "--bert-ranks-worker", str(d)]
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   MXTPU_DIST_TIMEOUT=str(ELASTIC_DIST_TIMEOUT_S))
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd, cwd=str(ROOT), env=env, text=True, capture_output=True,
            timeout=DIST_TIMEOUT_S + ZERO_TIMEOUT_S + SPMD_TIMEOUT_S
            + PP_TIMEOUT_S + MESH_TIMEOUT_S + ELASTIC_TIMEOUT_S)
        launch_s = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        tail = text.strip().splitlines()
        log("dist: the workers' log (last lines):\n  " + "\n  ".join(
            line for line in tail[-12:]))
        if proc.returncode:
            raise SystemExit(f"dist: the launch exited {proc.returncode}")
        ranks = [json.loads((d / f"rank{r}.json").read_text())
                 for r in range(DIST_RANKS)]
        ref_losses, ref_launches, ref_ms = dist_reference(mx, net, data,
                                                          [gpu])
        del net
        torch.cuda.empty_cache()
        device_run = None
        if n_gpu >= 2:
            net2 = pretrain_net(mx, [mx.gpu(0), mx.gpu(1)], dropout=0.0)
            net2.load_parameters(str(d / "start.params"),
                                 ctx=[mx.gpu(0), mx.gpu(1)])
            device_run = dist_reference(mx, net2, data,
                                        [mx.gpu(0), mx.gpu(1)])
            replicas_same = all(
                torch.equal(p.data(mx.gpu(0)).cpu(), p.data(mx.gpu(1)).cpu())
                for p in net2.collect_params().values())
            del net2
            torch.cuda.empty_cache()
        zero_launches = train_bert_zero(mx, card, d, data, ref_losses,
                                        want_backend, (launch_s, tail))
        zero_launches.update(train_bert_spmd(mx, card, d, data, ref_losses,
                                             want_backend, (launch_s, tail)))
        zero_launches.update(train_pipeline_lm(mx, card, d, (launch_s, tail),
                                               pp))
        mesh_ranks = mesh_records(d, "resnet,bert,moe")
        zero_launches.update(train_mesh_resnet(
            mx, card, d, mesh_ranks["resnet"], mesh_refs[0], want_backend))
        zero_launches.update(train_mesh_bert(mx, card, mesh_ranks["bert"],
                                             mesh_refs[1], want_backend))
        zero_launches.update(train_mesh_moe(mx, card, mesh_ranks["moe"],
                                            mesh_refs[2]))
        zero_launches.update(async_elastic(mx, card, d, data, text,
                                           proc.returncode))
    r0 = ranks[0]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                       ref_losses))
    same_params = all(r["digests"] == r0["digests"] for r in ranks)
    per_rank = 12 * DIST_STEPS
    checks.update({
        "backend": all(r["backend"] == want_backend for r in ranks),
        "ranks_bit_identical_every_step": same_params,
        "finite": not any(r["not_finite"] for r in ranks),
        "changed": not any(r["unchanged"] for r in ranks),
        "launches": all(n == per_rank for r in ranks
                        for n in r["launches"].values()),
        "plain_calls_on_cuda": all(r["plain_calls_on_cuda"] == 0
                                   for r in ranks),
        "losses_vs_one_process": loss_err <= DIST_LOSS_RTOL,
    })
    ar_ms = [statistics.median(r["allreduce_ms"][1:]) for r in ranks]
    step_ms = [statistics.median(r["step_ms"][1:]) for r in ranks]
    log(f"dist: BERT-base MLM+NSP fp32 dropout 0 Adam, {DIST_RANKS} ranks "
        f"({', '.join(r['device'] for r in ranks)}; backend "
        f"{r0['backend']}, the rule says {want_backend} with {n_gpu} "
        f"card(s)), {DIST_STEPS} steps of {DIST_BATCH // DIST_RANKS} x "
        f"{DIST_SEQ} a rank, kvstore='dist_sync' (update_on_kvstore "
        f"True): launch {launch_s:.1f} s (phases 20-25, 38); losses "
        f"{r0['losses']} vs one "
        f"process {ref_losses}: max rel err {loss_err:.3g} (rtol "
        f"{DIST_LOSS_RTOL}); parameters bit-identical across ranks after "
        f"every step: {same_params}; launches a rank {r0['launches']} "
        f"({per_rank} each); on {card}")
    log(f"dist: a step: median {step_ms} ms a rank (one process over both "
        f"halves: {statistics.median(ref_ms[1:]):.3f} ms); all-reduce "
        f"{ar_ms} ms a rank a step ({r0['allreduce_calls'][-1]} calls, "
        f"{r0['allreduce_bytes'][-1]} bytes a step, "
        f"{r0['allreduce_bytes'][-1] / (ar_ms[0] / 1e3) / 1e9:.3f} GB/s; "
        f"the {r0['backend']} path stages through the host) on {card}")
    launches["dist_bert_train"] = {k: sum(r["launches"][k] for r in ranks)
                                   for k in r0["launches"]}
    launches["dist_bert_reference"] = ref_launches
    launches.update(zero_launches)
    if device_run is None:
        log(f"dist 20b: kvstore='device' over gpu(0..n-1): needs 2 GPUs, "
            f"{n_gpu} visible")
    else:
        d_losses, d_launches, d_ms = device_run
        d_err = max(abs(a - b) / abs(b) for a, b in zip(d_losses,
                                                        ref_losses))
        checks["device_over_cards_losses"] = d_err <= DIST_LOSS_RTOL
        checks["device_over_cards_replicas"] = replicas_same
        checks["device_over_cards_launches"] = all(
            n == per_rank * 2 for n in d_launches.values())
        launches["device_bert_train"] = d_launches
        log(f"dist 20b: kvstore='device' over gpu(0), gpu(1): losses "
            f"{d_losses}, max rel err {d_err:.3g} against one card; "
            f"replicas bit-identical {replicas_same}; launches {d_launches}; "
            f"step median {statistics.median(d_ms[1:]):.3f} ms on {card}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"dist checks failed: {failed}")
    return launches


# -- phase 23: the Trainer's ZeRO over dist_sync ranks ------------------------


def zero_loss(out):
    """The pretraining block's output is its loss."""
    return out


def zero_worker(mx, ctx, rank, workdir):
    """Phase 23 on one rank: BERT-base from ``DIR/start.params`` on its
    half of ``DIR/batch.npz``, ``ZERO_STEPS`` whole steps through
    ``Trainer(kvstore='dist_sync', update_on_kvstore=False,
    whole_step=True)``, unsharded and then with ``zero_shard=True`` (saved
    into ``DIR/ckpt`` after ``ZERO_SAVE_AT`` steps); writes
    ``DIR/zero-rank<r>.json``."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.gluon import trainer as trainer_mod
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.parallel import mesh as mesh_mod

    npz = np.load(workdir / "batch.npz")
    data = [npz[f"arr_{i}"] for i in range(len(npz.files))]
    batch = tuple(dist_halves(mx, data, ctx, DIST_RANKS)[rank])
    out = {"rank": rank, "backend": dist.backend(), "device": str(ctx),
           "runs": {}}
    for label, zero in (("unsharded", False), ("zero", True)):
        net = pretrain_net(mx, ctx, dropout=0.0)
        net.load_parameters(str(workdir / "start.params"), ctx=ctx)
        params = list(net._collect_params_with_prefix().values())
        tr = mx.gluon.Trainer(net.collect_params(), "adam", dict(DIST_ADAM),
                              kvstore="dist_sync", update_on_kvstore=False,
                              whole_step=True, zero_shard=zero)
        mgr = CheckpointManager(workdir / "ckpt") if zero else None
        rec = {"losses": [], "digests": [], "step_ms": [], "comm": []}
        kernels.reset_counts()
        trainer_mod.reset_trainer_step_stats()
        for s in range(ZERO_STEPS):
            mesh_mod.reset_comm_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = tr.whole_step(net, zero_loss, batch,
                                 batch_size=DIST_RANKS)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["comm"].append(mesh_mod.comm_stats())
            rec["losses"].append(float(loss.asscalar()) / DIST_RANKS)
            rec["digests"].append(digest(p.data() for p in params))
            if mgr is not None and s + 1 == ZERO_SAVE_AT:
                t0 = time.perf_counter()
                mgr.save(s + 1, params=net, trainer=tr)
                rec["save_s"] = time.perf_counter() - t0
        rec["launches"] = {name: c.launches
                           for name, c in kernels.KERNEL_COUNTS.items()
                           if name.startswith("flash_attention")}
        rec["plain_calls_on_cuda"] = fa.counts.plain_calls_on_cuda
        rec["stats"] = trainer_mod.trainer_step_stats()
        rec["state_bytes"] = tr.optimizer_state_bytes()
        if zero:
            layout, world = tr._zero_layout
            # the most one chunk's zero pad adds to a rank's states
            rec["pad_bytes"] = max(
                (padded - total) * 4 * n_states
                for n_states, _dt, _idxs, total, padded in layout)
            rec["chunks"] = len(layout)
        out["runs"][label] = rec
        del tr, net, params, mgr
        torch.cuda.empty_cache()
    with open(workdir / f"zero-rank{rank}.json", "w") as f:
        json.dump(out, f)


def comm_rate(rec, kind):
    """Median ms a step, bytes a step and GB/s of one kind of collective
    over a run's steps after the first."""
    steps = rec["comm"][1:]
    ms = statistics.median(c[kind]["ms"] for c in steps)
    nbytes = steps[-1][kind]["bytes"]
    return ms, nbytes, (nbytes / (ms / 1e3) / 1e9 if ms else 0.0)


def train_bert_zero(mx, card, d, data, ref_losses, want_backend, launch):
    """Phase 23 (see the module docstring), in phase 20's directory ``d``
    (``start.params``, ``batch.npz``, the ranks' records) against its
    one-process losses ``ref_losses``; ``launch`` is the shared launch's
    ``(seconds, output lines)``.  Returns the launches by path."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.ops import kernels

    gpu = mx.gpu(0)
    launch_s, tail = launch
    log("zero: the workers' log (the route lines):\n  "
        + "\n  ".join([ln for ln in tail if "eagerly" in ln
                       or "backend" in ln][:4]))
    ranks = [json.loads((d / f"zero-rank{r}.json").read_text())
             for r in range(DIST_RANKS)]
    # the sharded checkpoint resumed in this process, unsharded, on gpu(0)
    manifest = json.loads((d / "ckpt" / f"ckpt-{ZERO_SAVE_AT:08d}" /
                           "MANIFEST.json").read_text())
    net = pretrain_net(mx, gpu, dropout=0.0)
    with mx.autograd.pause():
        net(*[mx.nd.array(a[:2], ctx=gpu) for a in data])
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(DIST_ADAM))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = CheckpointManager(d / "ckpt").restore(params=net, trainer=trainer)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    parts = dist_halves(mx, data, gpu, DIST_RANKS)
    kernels.reset_counts()
    resumed = []
    for _ in range(ZERO_STEPS - ZERO_SAVE_AT):
        with mx.autograd.record():
            ls = [net(*p) for p in parts]
        mx.autograd.backward(ls)
        trainer.step(DIST_RANKS)
        resumed.append(sum(float(l.asscalar()) for l in ls) / DIST_RANKS)
    resume_launches = {k: c.launches for k, c in kernels.KERNEL_COUNTS.items()
                       if k.startswith("flash_attention")}
    del net, trainer, parts
    torch.cuda.empty_cache()
    shutil.rmtree(d / "ckpt", ignore_errors=True)

    runs = {label: [r["runs"][label] for r in ranks]
            for label in ("unsharded", "zero")}
    z0, u0 = runs["zero"][0], runs["unsharded"][0]
    gaps = {label: max(abs(a - b) / abs(b) for a, b in zip(
        rs[0]["losses"], ref_losses[:ZERO_STEPS])) for label, rs in
        runs.items()}
    resume_gap = max(abs(a - b) / abs(b) for a, b in zip(
        resumed, z0["losses"][ZERO_SAVE_AT:]))
    per_rank = 12 * ZERO_STEPS
    checks = {
        "zero_backend": all(r["backend"] == want_backend for r in ranks),
        "zero_manifest_two_processes": manifest["num_processes"] == DIST_RANKS
        and meta["step"] == ZERO_SAVE_AT
        and sum(f.startswith("trainer-shard") for f in manifest["files"])
        == DIST_RANKS,
    }
    for label, rs in runs.items():
        checks[f"zero_{label}_ranks_bit_identical"] = all(
            r["digests"] == rs[0]["digests"] for r in rs)
        checks[f"zero_{label}_launches"] = all(
            n == per_rank for r in rs for n in r["launches"].values())
        checks[f"zero_{label}_plain_calls_on_cuda"] = all(
            r["plain_calls_on_cuda"] == 0 for r in rs)
        checks[f"zero_{label}_losses_vs_one_process"] = \
            gaps[label] <= DIST_LOSS_RTOL
        checks[f"zero_{label}_whole_steps_eager"] = all(
            r["stats"]["whole_step_eager"] == ZERO_STEPS
            and r["stats"]["whole_step_fallbacks"] == 0 for r in rs)
    checks["zero_steps_sharded"] = all(
        r["stats"]["zero_steps"] == ZERO_STEPS
        and r["stats"]["zero_fallbacks"] == 0 for r in runs["zero"])
    checks["zero_state_bytes_half"] = all(
        z["state_bytes"]["per_replica"]
        <= u["state_bytes"]["per_replica"] / 2 + z["pad_bytes"]
        for z, u in zip(runs["zero"], runs["unsharded"]))
    if want_backend == "gloo":
        checks["zero_bit_identical_to_unsharded"] = (
            z0["digests"] == u0["digests"] and z0["losses"] == u0["losses"])
    checks["zero_resumed_vs_uninterrupted"] = resume_gap <= DIST_LOSS_RTOL
    rs_ms, rs_bytes, rs_gbs = comm_rate(z0, "grad")
    ag_ms, ag_bytes, ag_gbs = comm_rate(z0, "param")
    ar_ms, ar_bytes, ar_gbs = comm_rate(u0, "grad")
    log(f"zero: BERT-base MLM+NSP fp32 dropout 0 Adam, {DIST_RANKS} ranks "
        f"({', '.join(r['device'] for r in ranks)}; backend "
        f"{ranks[0]['backend']}), {ZERO_STEPS} whole steps of "
        f"{DIST_BATCH // DIST_RANKS} x {DIST_SEQ} a rank through "
        f"Trainer(kvstore='dist_sync', update_on_kvstore=False, "
        f"whole_step=True), unsharded then zero_shard=True ({z0['chunks']} "
        f"flat chunks): launch {launch_s:.1f} s (phases 20-25, 38); "
        f"losses unsharded "
        f"{u0['losses']}, sharded {z0['losses']}, phase 20's one process "
        f"{ref_losses[:ZERO_STEPS]}: max rel gaps {gaps} (rtol "
        f"{DIST_LOSS_RTOL}); sharded bit-identical to unsharded: "
        f"{z0['digests'] == u0['digests']}; launches a rank a run "
        f"{z0['launches']} ({per_rank} each); on {card}")
    log(f"zero: a step: median unsharded "
        f"{[statistics.median(r['step_ms'][1:]) for r in runs['unsharded']]}"
        f" ms, sharded "
        f"{[statistics.median(r['step_ms'][1:]) for r in runs['zero']]} ms a "
        f"rank; unsharded all-reduce {ar_ms:.3f} ms, {ar_bytes} bytes, "
        f"{ar_gbs:.3f} GB/s; sharded reduce-scatter {rs_ms:.3f} ms, "
        f"{rs_bytes} bytes, {rs_gbs:.3f} GB/s; all-gather {ag_ms:.3f} ms, "
        f"{ag_bytes} bytes, {ag_gbs:.3f} GB/s a step (the "
        f"{ranks[0]['backend']} path; comm_stats, host clock); optimizer "
        f"state a rank {z0['state_bytes']['per_replica']} bytes sharded vs "
        f"{u0['state_bytes']['per_replica']} unsharded (pad at most "
        f"{z0['pad_bytes']} bytes); on {card}")
    log(f"zero: checkpoint after step {ZERO_SAVE_AT}: save (both ranks, "
        f"synchronous, 2-process manifest) "
        f"{[round(r['save_s'], 3) for r in runs['zero']]} s a rank; restore "
        f"into one unsharded process on gpu(0) {restore_s:.3f} s "
        f"(resharding 2 -> 1); resumed losses {resumed} vs uninterrupted "
        f"{z0['losses'][ZERO_SAVE_AT:]}: max rel gap {resume_gap:.3g} (rtol "
        f"{DIST_LOSS_RTOL}); on {card}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"zero checks failed: {failed}")
    return {"zero_bert_train": {
                k: sum(r["launches"][k] for rs in runs.values() for r in rs)
                for k in z0["launches"]},
            "zero_bert_resume": resume_launches}


# -- phase 24: the Trainer on a mesh ------------------------------------------


def spmd_worker(mx, ctx, rank, workdir):
    """Phase 24 on one rank: BERT-base from ``DIR/start.params`` on the global
    batch of ``DIR/batch.npz`` (a loss a half), ``SPMD_STEPS`` whole
    steps through ``Trainer(mesh_shape=...)`` for each of ``SPMD_RUNS``
    (the mp=2 run saved into ``DIR/spmd-ckpt`` after ``SPMD_SAVE_AT``
    steps); writes ``DIR/spmd-rank<r>.json``."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.gluon import trainer as trainer_mod
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.parallel import mesh as mesh_mod
    from mxnet_tpu_torch.parallel.spmd import products

    npz = np.load(workdir / "batch.npz")
    batch = tuple(npz[f"arr_{i}"] for i in range(len(npz.files)))
    out = {"rank": rank, "backend": dist.backend(), "device": str(ctx),
           "runs": {}}
    for label, shape, zero in SPMD_RUNS:
        net = pretrain_net(mx, ctx, dropout=0.0,
                           groups=DIST_BATCH // DIST_RANKS)
        net.load_parameters(str(workdir / "start.params"), ctx=ctx)
        named = dict(net.collect_params().items())
        params = list(net._collect_params_with_prefix().values())
        tr = mx.gluon.Trainer(net.collect_params(), "adam", dict(DIST_ADAM),
                              whole_step=True, mesh_shape=shape,
                              zero_shard=zero)
        mgr = CheckpointManager(workdir / "spmd-ckpt") \
            if label == "mp2" else None
        rec = {"losses": [], "digests": [], "step_ms": [], "comm": [],
               "peak": 0,
               "full_param_bytes": sum(4 * int(np.prod(p.shape))
                                       for p in params),
               "full_state_bytes": sum(8 * int(np.prod(p.shape))
                                       for p in tr._params)}
        kernels.reset_counts()
        trainer_mod.reset_trainer_step_stats()
        products.reset_split_counts()
        for s in range(SPMD_STEPS):
            mesh_mod.reset_comm_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = tr.whole_step(net, zero_loss, batch,
                                 batch_size=DIST_RANKS)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["peak"] = max(rec["peak"], torch.cuda.max_memory_allocated())
            rec["comm"].append(mesh_mod.comm_stats())
            rec["losses"].append(float(loss.asscalar()) / DIST_RANKS)
            comp = tr._whole_step_compiler
            rec["param_bytes"] = comp.param_bytes_per_device(net)
            rec["state_bytes"] = comp.state_bytes_per_device()
            rec["digests"].append(digest(p.data() for p in params))
            if mgr is not None and s + 1 == SPMD_SAVE_AT:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mgr.save(s + 1, params=net, trainer=tr)
                rec["save_s"] = time.perf_counter() - t0
        rec["launches"] = {name: c.launches
                           for name, c in kernels.KERNEL_COUNTS.items()
                           if name.startswith("flash_attention")}
        rec["plain_calls_on_cuda"] = fa.counts.plain_calls_on_cuda
        rec["stats"] = trainer_mod.trainer_step_stats()
        rec["splits"] = products.split_counts()
        rec["gathered"] = list(comp.gathered)
        rec["gathered_bytes"] = sum(4 * int(np.prod(named[n].shape))
                                    for n in comp.gathered)
        out["runs"][label] = rec
        del tr, net, params, named, mgr, comp
        torch.cuda.empty_cache()
    with open(workdir / f"spmd-rank{rank}.json", "w") as f:
        json.dump(out, f)


def train_bert_spmd(mx, card, d, data, ref_losses, want_backend, launch):
    """Phase 24 (see the module docstring), in phase 20's directory ``d``
    (``start.params``, ``batch.npz``, the ranks' records) against its
    one-process losses ``ref_losses``; ``launch`` is the shared launch's
    ``(seconds, output lines)``.  Returns the launches by path."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.ops import kernels

    gpu = mx.gpu(0)
    launch_s, tail = launch
    log("spmd: the workers' log (the route lines):\n  "
        + "\n  ".join([ln for ln in tail if "eagerly" in ln
                       or "backend" in ln][:4]))
    ranks = [json.loads((d / f"spmd-rank{r}.json").read_text())
             for r in range(DIST_RANKS)]
    # the mp=2 save restored in this process, without a mesh, on gpu(0)
    ckpt = d / "spmd-ckpt"
    manifest = json.loads((ckpt / f"ckpt-{SPMD_SAVE_AT:08d}" /
                           "MANIFEST.json").read_text())
    half = DIST_BATCH // DIST_RANKS
    net = pretrain_net(mx, gpu, dropout=0.0, groups=half)
    with mx.autograd.pause():
        net(*[mx.nd.array(a[:half], ctx=gpu) for a in data])
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(DIST_ADAM),
                               whole_step=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = CheckpointManager(ckpt).restore(params=net, trainer=trainer)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    kernels.reset_counts()
    resumed = float(trainer.whole_step(
        net, zero_loss, tuple(mx.nd.array(a, ctx=gpu) for a in data),
        batch_size=DIST_RANKS).asscalar()) / DIST_RANKS
    resume_launches = {k: c.launches for k, c in kernels.KERNEL_COUNTS.items()
                       if k.startswith("flash_attention")}
    del net, trainer
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)

    runs = {label: [r["runs"][label] for r in ranks]
            for label, _, _ in SPMD_RUNS}
    mp0, dz0 = runs["mp2"][0], runs["dp2_zero"][0]
    gaps = {label: max(abs(a - b) / abs(b) for a, b in zip(
        rs[0]["losses"], ref_losses[:SPMD_STEPS])) for label, rs in
        runs.items()}
    resume_gap = abs(resumed - mp0["losses"][SPMD_SAVE_AT]) / abs(
        mp0["losses"][SPMD_SAVE_AT])
    per_rank = 12 * SPMD_STEPS
    checks = {
        "spmd_backend": all(r["backend"] == want_backend for r in ranks),
        "spmd_manifest_one_process": manifest["num_processes"] == 1
        and manifest.get("mesh_shape") == "mp=2"
        and meta["step"] == SPMD_SAVE_AT
        and manifest["files"] == ["params-shard0.params", "rng-shard0.json",
                                  "rng-shard1.json",
                                  "trainer-shard0.states"],
        "spmd_resumed_vs_uninterrupted": resume_gap <= MESH_LOSS_RTOL,
        "spmd_mp2_params_at_rest": all(
            r["param_bytes"] <= SPMD_SHARE * r["full_param_bytes"]
            for r in runs["mp2"]),
        "spmd_mp2_states_at_rest": all(
            r["state_bytes"] <= SPMD_SHARE * r["full_state_bytes"]
            for r in runs["mp2"]),
        "spmd_dp2_zero_states_at_rest": all(
            r["state_bytes"] <= SPMD_SHARE * r["full_state_bytes"]
            for r in runs["dp2_zero"]),
        "spmd_mp2_products_on_shards": all(
            r["splits"]["column"] + r["splits"]["row"]
            == SPMD_SPLITS * SPMD_STEPS for r in runs["mp2"]),
        "spmd_mp2_no_split_weight_gathered": all(
            not any("dense" in n or n.endswith(("attn_in_weight",
                                                "attn_out_weight"))
                    for n in r["gathered"]) and r["gathered"]
            for r in runs["mp2"]),
        "spmd_mp2_param_traffic_is_the_gathers": all(
            c["param"]["bytes"] == r["gathered_bytes"]
            for r in runs["mp2"] for c in r["comm"]),
    }
    for label, rs in runs.items():
        checks[f"spmd_{label}_ranks_bit_identical"] = all(
            r["digests"] == rs[0]["digests"] and r["losses"]
            == rs[0]["losses"] for r in rs)
        checks[f"spmd_{label}_launches"] = all(
            n == per_rank for r in rs for n in r["launches"].values())
        checks[f"spmd_{label}_plain_calls_on_cuda"] = all(
            r["plain_calls_on_cuda"] == 0 for r in rs)
        checks[f"spmd_{label}_losses_vs_one_process"] = \
            gaps[label] <= MESH_LOSS_RTOL
        checks[f"spmd_{label}_spmd_steps"] = all(
            r["stats"]["spmd_steps"] == SPMD_STEPS
            and r["stats"]["whole_step_fallbacks"] == 0 for r in rs)
    shape_of = {label: shape for label, shape, _ in SPMD_RUNS}
    for label, rs in runs.items():
        SPMD_PEAK[label] = [r["peak"] for r in rs]
        r0 = rs[0]
        rates = {k: comm_rate(r0, k) for k in ("act", "param", "grad",
                                               "loss")}
        log(f"spmd {label}: BERT-base MLM+NSP fp32 dropout 0 Adam, "
            f"{DIST_RANKS} ranks ({', '.join(r['device'] for r in ranks)}; "
            f"backend {ranks[0]['backend']}), {SPMD_STEPS} whole steps of "
            f"the global batch {DIST_BATCH} x {DIST_SEQ} through "
            f"Trainer(whole_step=True, mesh_shape={shape_of[label]!r}"
            f"{', zero_shard=True' if label == 'dp2_zero' else ''}): launch "
            f"{launch_s:.1f} s (both runs); losses {r0['losses']} vs phase "
            f"20's one process {ref_losses[:SPMD_STEPS]}: max rel gap "
            f"{gaps[label]:.3g} (rtol {MESH_LOSS_RTOL}); launches a rank "
            f"{r0['launches']} ({per_rank} each); products on a shard "
            f"{r0['splits']}; on {card}")
        log(f"spmd {label}: a step: median "
            f"{[statistics.median(r['step_ms'][1:]) for r in rs]} ms a rank; "
            f"collectives a step (comm_stats, host clock; median ms, bytes, "
            f"GB/s): " + "; ".join(
                f"{k} {v[0]:.3f} ms {v[1]} B {v[2]:.3f} GB/s"
                for k, v in rates.items())
            + f"; a rank at rest: parameters {r0['param_bytes']} of "
            f"{r0['full_param_bytes']} bytes, Adam states "
            f"{r0['state_bytes']} of {r0['full_state_bytes']}; gathered for "
            f"compute {len(r0['gathered'])} parameters, "
            f"{r0['gathered_bytes']} bytes; peak memory a rank "
            f"{[r['peak'] / 2**30 for r in rs]} GiB; on {card}")
    log(f"spmd: checkpoint of the mp=2 run after step {SPMD_SAVE_AT}: save "
        f"(full arrays gathered on both ranks, written once by rank 0) "
        f"{[round(r['save_s'], 3) for r in runs['mp2']]} s a rank; restore "
        f"into one process without a mesh on gpu(0) {restore_s:.3f} s; the "
        f"resumed step's loss {resumed} vs uninterrupted "
        f"{mp0['losses'][SPMD_SAVE_AT]}: rel gap {resume_gap:.3g} (rtol "
        f"{MESH_LOSS_RTOL}); on {card}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"spmd checks failed: {failed}")
    return {"spmd_bert_train": {
                k: sum(r["launches"][k] for rs in runs.values() for r in rs)
                for k in mp0["launches"]},
            "spmd_bert_resume": resume_launches}


# -- phase 25: the pp and sp axes at GPT-2 small's widths ---------------------


def pp_tree(flat, stages):
    """The pipeline LM's tree from ``pp-weights.npz``'s flat keys, its blocks
    stacked for ``stages`` stages (the draws are the same numbers whatever
    the stacking)."""
    tree = {}
    for key, v in flat.items():
        g, k = key.split(".")
        if g == "blocks":
            v = v.reshape((stages, PP_LAYERS // stages) + v.shape[2:])
        tree.setdefault(g, {})[k] = v
    return tree


def gpt2_scale(params, n_layers, d_model, d_ff):
    """Rescale ``init_pipeline_lm``'s draws of the block weights, in place,
    to GPT-2's published init: N(0, 0.02), the residual projections (``wo``,
    ``w2``) 0.02 / sqrt(2 n_layers); the embeddings and head are drawn at
    0.02 already.  The JAX package's own scales put ``wqkv`` at sqrt(2/3)
    whatever the width: at 768 the attention logits' spread is ~500, the
    first loss ~260, and fp32 rounding moves the gradients by O(1)."""
    import torch

    resid = 0.02 / (2 * n_layers) ** 0.5
    scale = {"wqkv": 0.02 / (2 / 3) ** 0.5,
             "wo": resid / (2 / d_model) ** 0.5,
             "w1": 0.02 / (2 / d_model) ** 0.5,
             "w2": resid / (2 / d_ff) ** 0.5}
    with torch.no_grad():
        for k, f in scale.items():
            params["blocks"][k].mul_(f)
    return params


def pp_launches(kernels):
    return {name: c.launches for name, c in kernels.KERNEL_COUNTS.items()
            if name.startswith("flash_attention")}


def pp_worker(mx, ctx, rank, workdir):
    """Phase 25 on one rank (after phase 24, in the same launch): the
    collectives on CUDA tensors against CPU tensors, the pipeline LM at
    GPT-2 small's widths from ``DIR/pp-weights.npz`` on
    ``DIR/pp-batch.npz`` over ``{pp:2}`` (the first step's gradients, then
    ``PP_STEPS`` steps) and over ``{sp:2}`` (``PP_SP_STEPS`` steps), and
    ring and Ulysses attention over ``{sp:2}``; writes
    ``DIR/pp-rank<r>.json`` and ``DIR/pp-grads-rank<r>.npz``."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.attention import sdpa_reference
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.parallel import mesh as mesh_mod
    from mxnet_tpu_torch.parallel import pipeline_lm as plm
    from mxnet_tpu_torch.parallel.ring_attention import ring_attention
    from mxnet_tpu_torch.parallel.ulysses import ulysses_attention

    with np.load(workdir / "pp-weights.npz") as z:
        flat = {k: z[k] for k in z.files}
    with np.load(workdir / "pp-batch.npz") as z:
        toks, tgts = z["tokens"], z["targets"]
    out = {"rank": rank, "backend": dist.backend(), "device": str(ctx)}

    # (c) the ring shift and the all-to-all at the main path's shapes
    mesh = mesh_mod.make_mesh({"dp": 1, "tp": 1, "pp": PP_RANKS}, ctx)
    group = mesh.group(("pp",))
    gen = torch.Generator().manual_seed(25 + rank)
    act = torch.randn(PP_BATCH // PP_MICRO, PP_CTX, PP_D, generator=gen)
    qkv = torch.randn(3, PP_BATCH // PP_MICRO, PP_HEADS, PP_CTX // PP_RANKS,
                      PP_D // PP_HEADS, generator=gen)
    calls = ((act, lambda t: mesh_mod.ring_shift(t, group)),
             (qkv, lambda t: mesh_mod.all_to_all(t, group, 2, 3)))
    out["collectives_bit_identical"] = all(
        torch.equal(fn(t.cuda()).cpu(), fn(t)) for t, fn in calls)
    times = {}
    for (t, fn), kind in zip(calls, ("p2p", "a2a")):
        t = t.cuda()
        mesh_mod.reset_comm_stats()
        for _ in range(PP_COMM_ITERS):
            fn(t)
        torch.cuda.synchronize()
        times[kind] = mesh_mod.comm_stats()[kind]
    out["collective_times"] = times

    # (a) {pp:2}: the first step's gradients, then PP_STEPS Adam steps
    tr = plm.PipelineLMTrainer(pp_tree(flat, PP_RANKS), mesh, PP_HEADS,
                               n_micro=PP_MICRO, lr=PP_LR)
    start = {(g, k): v.detach().clone() for g, s in tr.params.items()
             for k, v in s.items()}
    loss0, grads = tr.loss_and_grads(toks, tgts)
    mine = {}
    if group.index == 0:
        mine["embed.tok"] = grads["embed"]["tok"]
        mine["blocks.wqkv0"] = grads["blocks"]["wqkv"][0]
    if group.index == PP_RANKS - 1:
        mine["head.w"] = grads["head"]["w"]
    np.savez(workdir / f"pp-grads-rank{rank}.npz",
             **{k: v.cpu().numpy() for k, v in mine.items()})
    del grads, mine
    rec = {"loss0": loss0, "losses": [], "step_ms": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    mesh_mod.reset_comm_stats()
    for _ in range(PP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["losses"].append(tr.step(toks, tgts))
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
    rec["launches"] = pp_launches(kernels)
    rec["plain_calls_on_cuda"] = fa.counts.plain_calls_on_cuda
    rec["comm"] = mesh_mod.comm_stats()
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["finite"] = all(bool(torch.isfinite(v).all()) for s in
                        tr.params.values() for v in s.values())
    rec["unchanged"] = [f"{g}.{k}" for (g, k), v in start.items()
                        if torch.equal(v, tr.params[g][k])]
    rec["stage"] = group.index
    out["pp2"] = rec
    del tr, start
    torch.cuda.empty_cache()

    # (b) {sp:2}: Ulysses inside every block, PP_SP_STEPS Adam steps
    mesh = mesh_mod.make_mesh({"dp": 1, "sp": PP_RANKS, "tp": 1, "pp": 1},
                              ctx)
    tr = plm.PipelineLMTrainer(pp_tree(flat, 1), mesh, PP_HEADS,
                               n_micro=PP_MICRO, lr=PP_LR)
    rec = {"losses": [], "step_ms": [], "digests": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    mesh_mod.reset_comm_stats()
    for _ in range(PP_SP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["losses"].append(tr.step(toks, tgts))
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["digests"].append(digest(v for g in sorted(tr.params) for _, v in
                                     sorted(tr.params[g].items())))
    rec["launches"] = pp_launches(kernels)
    rec["plain_calls_on_cuda"] = fa.counts.plain_calls_on_cuda
    rec["comm"] = mesh_mod.comm_stats()
    rec["peak"] = torch.cuda.max_memory_allocated()
    out["sp2"] = rec
    del tr
    torch.cuda.empty_cache()

    # (d) ring and Ulysses attention over {sp:2} against the oracle
    mesh = mesh_mod.make_mesh({"sp": PP_RANKS}, ctx)
    rng = np.random.RandomState(26)
    q, k, v = (torch.from_numpy(rng.rand(*PP_ATTN).astype(np.float32) * 0.5)
               .to(ctx.torch_device()) for _ in range(3))
    ref = sdpa_reference(q, k, v, causal=True)
    attn = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        got = fn(q, k, v, mesh=mesh, causal=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PP_COMM_ITERS):
            fn(q, k, v, mesh=mesh, causal=True)
        torch.cuda.synchronize()
        attn[name] = {"max_abs_err": (got - ref).abs().max().item(),
                      "ms": (time.perf_counter() - t0) * 1e3 / PP_COMM_ITERS}
    out["attention"] = attn
    with open(workdir / f"pp-rank{rank}.json", "w") as f:
        json.dump(out, f)


def pp_rounding_floor(mx, plm, params, toks, tgts):
    """What fp32 rounding alone does to ``reference_lm_loss`` from
    ``params`` on gpu(0): the loss and the largest gradient gaps (of
    ``embed.tok`` and ``head.w``, of their largest value) between the whole
    batch at once and the same rows in ``PP_MICRO`` micro-batches (the mean
    of their losses)."""
    import numpy as np
    import torch

    dev = mx.gpu(0).torch_device()
    runs = []
    for parts in (1, PP_MICRO):
        tree = {g: {k: v.to(dev, copy=True).requires_grad_()
                    for k, v in s.items()} for g, s in params.items()}
        total = 0.0
        for x, y in zip(np.array_split(toks, parts),
                        np.array_split(tgts, parts)):
            loss = plm.reference_lm_loss(tree, x, y, PP_HEADS) / parts
            loss.backward()
            total += float(loss.detach())
        runs.append((total, {k: tree[g][k].grad for g, k in
                             (("embed", "tok"), ("head", "w"))}))
        del tree
    (a, ga), (b, gb) = runs
    out = {"loss": a, "loss_rel_gap": abs(a - b) / abs(a)}
    out.update({k: ((ga[k] - gb[k]).abs().max() / ga[k].abs().max()).item()
                for k in ga})
    torch.cuda.empty_cache()
    return out


def pp_inputs(mx, d):
    """Phase 25's inputs, written into phase 20's directory ``d`` before
    the shared launch: GPT-2 small's weights (``pp-weights.npz``, the JAX
    package's init rescaled by :func:`gpt2_scale`) and one batch
    (``pp-batch.npz``); returns them with the JAX init's rounding floor
    and this phase's seconds so far."""
    import numpy as np

    from mxnet_tpu_torch.parallel import pipeline_lm as plm

    t0 = time.perf_counter()
    rng = np.random.RandomState(25)
    toks = rng.randint(0, PP_VOCAB, (PP_BATCH, PP_CTX))
    tgts = np.roll(toks, -1, axis=1)
    jax_init = plm.init_pipeline_lm(PP_VOCAB, PP_D, PP_LAYERS, PP_FF,
                                    PP_HEADS, PP_CTX, PP_RANKS, ctx=mx.cpu())
    floor = pp_rounding_floor(mx, plm, jax_init, toks, tgts)
    params = gpt2_scale(jax_init, PP_LAYERS, PP_D, PP_FF)
    del jax_init
    np.savez(d / "pp-weights.npz", **{f"{g}.{k}": v.numpy() for g, s in
                                      params.items() for k, v in s.items()})
    np.savez(d / "pp-batch.npz", tokens=toks, targets=tgts)
    return {"toks": toks, "tgts": tgts, "params": params, "floor": floor,
            "s": time.perf_counter() - t0}


def train_pipeline_lm(mx, card, d, launch, inputs):
    """Phase 25 (see the module docstring): its ranks ran in phase 20's
    launch (``launch``: its seconds and output lines) from
    :func:`pp_inputs`' ``inputs`` in ``d``.  Returns the launches by
    path."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.parallel import pipeline_lm as plm

    gpu = mx.gpu(0)
    want_backend = dist.choose_backend(PP_RANKS)
    t_phase = time.perf_counter() - inputs["s"]
    toks, tgts, floor = inputs["toks"], inputs["tgts"], inputs["floor"]
    params = inputs.pop("params")
    launch_s, _ = launch
    ranks = [json.loads((d / f"pp-rank{r}.json").read_text())
             for r in range(PP_RANKS)]
    got = {}
    for r in range(PP_RANKS):
        with np.load(d / f"pp-grads-rank{r}.npz") as z:
            got.update({k: z[k] for k in z.files})
    # the one-process reference on gpu(0) from the same weights
    tree = {g: {k: v.to(gpu.torch_device(), copy=True)
                .requires_grad_() for k, v in s.items()}
            for g, s in params.items()}
    del params
    kernels.reset_counts()
    loss = plm.reference_lm_loss(tree, toks, tgts, PP_HEADS)
    loss.backward()
    ref_loss = float(loss.detach())
    ref_launches = pp_launches(kernels)
    want = {"embed.tok": tree["embed"]["tok"].grad,
            "blocks.wqkv0": tree["blocks"]["wqkv"].grad[0, 0],
            "head.w": tree["head"]["w"].grad}
    grad_err = {k: ((torch.from_numpy(got[k]).to(w.device) - w).abs()
                    .max() / w.abs().max()).item()
                for k, w in want.items()}
    del tree, want, loss
    torch.cuda.empty_cache()
    pp, sp = [r["pp2"] for r in ranks], [r["sp2"] for r in ranks]
    pp_gap = abs(pp[0]["loss0"] - ref_loss) / ref_loss
    sp_gap = abs(sp[0]["losses"][0] - ref_loss) / ref_loss
    checks = {
        "pp_backend": all(r["backend"] == want_backend for r in ranks),
        "pp_collectives_bit_identical_to_cpu": all(
            r["collectives_bit_identical"] for r in ranks),
        "pp2_losses_finite_and_falling": all(
            np.isfinite(p["losses"]).all() and p["losses"][-1]
            < p["losses"][0] for p in pp),
        "pp2_first_loss_vs_one_process": pp_gap <= PP_LOSS_RTOL,
        "pp2_gradients_vs_one_process": max(grad_err.values())
        <= PP_GRAD_TOL,
        "pp2_parameters_finite_and_changed": all(
            p["finite"] and not p["unchanged"] for p in pp),
        "pp2_launches": all(n == PP_LAYERS // PP_RANKS * PP_MICRO * PP_STEPS
                            for p in pp for n in p["launches"].values())
        and all(len(p["launches"]) == 3 for p in pp),
        "sp2_first_loss_vs_one_process": sp_gap <= PP_LOSS_RTOL,
        "sp2_ranks_bit_identical": all(
            s["digests"] == sp[0]["digests"] and s["losses"]
            == sp[0]["losses"] for s in sp),
        "sp2_launches": all(n == PP_LAYERS * PP_MICRO * PP_SP_STEPS
                            for s in sp for n in s["launches"].values())
        and all(len(s["launches"]) == 3 for s in sp),
        "plain_calls_on_cuda": all(p["plain_calls_on_cuda"] == 0
                                   for p in pp + sp),
        "attention_vs_oracle": all(
            a["max_abs_err"] <= PP_ATTN_TOL for r in ranks
            for a in r["attention"].values()),
    }
    devices = ", ".join(r["device"] for r in ranks)
    log(f"pp: GPT-2 small's widths (vocab {PP_VOCAB}, context {PP_CTX}, "
        f"{PP_LAYERS} x {PP_D}, {PP_HEADS} heads, FFN {PP_FF}; fp32, TF32 "
        f"off), {PP_RANKS} ranks ({devices}; backend {ranks[0]['backend']},"
        f" the rule says {want_backend}), batch {PP_BATCH} x {PP_CTX} in "
        f"{PP_MICRO} micro-batches, Adam lr {PP_LR}: launch {launch_s:.1f} s"
        f" (phases 20-25 and 38)"
        f"; on {card}")
    log(f"pp {{pp:2}}: first loss {pp[0]['loss0']} vs one process "
        f"{ref_loss}: rel gap {pp_gap:.3g} (rtol {PP_LOSS_RTOL}); gradients "
        f"against one process (of their largest value): "
        + ", ".join(f"{k} {v:.3g}" for k, v in grad_err.items())
        + f" (limit {PP_GRAD_TOL}); losses {pp[0]['losses']}; launches a "
        f"rank {[p['launches'] for p in pp]} "
        f"({PP_LAYERS // PP_RANKS * PP_MICRO} each a step); step median "
        f"{[statistics.median(p['step_ms'][1:]) for p in pp]} ms a rank; "
        f"p2p over {PP_STEPS} steps {[p['comm']['p2p'] for p in pp]}; peak "
        f"memory {[p['peak'] / 2**30 for p in pp]} GiB a rank; on {card}")
    log(f"pp {{sp:2}}: losses {sp[0]['losses']} (first vs one process: rel "
        f"gap {sp_gap:.3g}); ranks bit-identical after every step "
        f"{checks['sp2_ranks_bit_identical']}; launches a rank "
        f"{[s['launches'] for s in sp]} ({PP_LAYERS * PP_MICRO} each a step);"
        f" step median {[statistics.median(s['step_ms'][1:]) for s in sp]} "
        f"ms a rank; a2a {[s['comm']['a2a'] for s in sp]}, gradient "
        f"all-reduce {[s['comm']['grad'] for s in sp]} over {PP_SP_STEPS} "
        f"steps; peak memory {[s['peak'] / 2**30 for s in sp]} GiB a rank; "
        f"on {card}")
    mb, n = PP_BATCH // PP_MICRO, PP_COMM_ITERS
    act_shape = (mb, PP_CTX, PP_D)
    qkv_shape = (3, mb, PP_HEADS, PP_CTX // PP_RANKS, PP_D // PP_HEADS)
    for r in ranks:
        c = r["collective_times"]
        log(f"pp: rank {r['rank']}: the ring shift of a {act_shape} "
            f"activation {c['p2p']['bytes'] / n:.0f} B in "
            f"{c['p2p']['ms'] / n:.3f} ms, the all-to-all of a {qkv_shape} "
            f"q/k/v {c['a2a']['bytes'] / n:.0f} B in {c['a2a']['ms'] / n:.3f}"
            f" ms (comm_stats, host clock, CUDA tensors; bit-identical to "
            f"CPU tensors {r['collectives_bit_identical']}); ring and "
            f"Ulysses attention {PP_ATTN} causal: {r['attention']} (limit "
            f"{PP_ATTN_TOL} against sdpa_reference); on {card}")
    log(f"pp: the JAX package's init at these widths (wqkv drawn at "
        f"sqrt(2/3)), one process on gpu(0), the whole batch against its 4 "
        f"micro-batches: first loss {floor['loss']}, rel gap "
        f"{floor['loss_rel_gap']:.3g}; gradient gaps of their largest value:"
        f" embed.tok {floor['tok']:.3g}, head.w {floor['w']:.3g} (fp32 "
        f"rounding alone; phase 25 trains from GPT-2's published init "
        f"scale, gpt2_scale); on {card}")
    log(f"pp: phase 25 took {time.perf_counter() - t_phase:.1f} s besides "
        f"its ranks' part of the shared launch; bubble "
        f"n_micro/(n_micro+P-1) = {PP_MICRO}/{PP_MICRO + PP_RANKS - 1}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"pp checks failed: {failed}")
    return {"pp_lm_train": {k: sum(p["launches"][k] for p in pp)
                            for k in pp[0]["launches"]},
            "sp_lm_train": {k: sum(s["launches"][k] for s in sp)
                            for k in sp[0]["launches"]},
            "pp_lm_reference": ref_launches}


# -- phases 21-22: DataParallelTrainer over a mesh ----------------------------


def digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_step_record(step, mesh_mod):
    """One timed step (``step()`` runs it): the loss, the step's
    time, its collectives by kind and its launches by kernel and route."""
    import torch

    before = counts_now()
    mesh_mod.reset_comm_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step().asnumpy())
    torch.cuda.synchronize()
    return {"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
            "comm": mesh_mod.comm_stats(),
            "launches": counts_gain(before, counts_now())}


def mesh_worker_resnet(mx, ctx, mesh, workdir, out):
    """Phase 21 on one rank: 6 bf16 steps of fused ResNet-50 at the global
    batch, then 2 fp32 steps at b=16 112^2 from DIR/ref-start.params."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.parallel import mesh as mesh_mod

    net = resnet50(mx, ctx, fuse=True)
    x, y = synthetic_images(np.random.RandomState(0), RESNET_BATCH,
                            RESNET_IMAGE)
    xg, yg = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    tr = resnet_trainer(mx, net, compute_dtype="bfloat16", capture=True,
                        mesh=mesh)
    tr.build(xg)
    start = [p.detach().clone() for p in tr._params]
    names = [n for n, _ in tr._named]
    steps = []
    for _ in range(MESH_RESNET_STEPS):
        rec = mesh_step_record(lambda: tr.step(xg, yg), mesh_mod)
        rec["digest"] = digest(tr._params)
        steps.append(rec)
    out["resnet"] = {
        "steps": steps, "eager_reason": tr.eager_reason,
        "eager_steps": tr.stats["mesh_eager_steps"],
        "not_finite": [n for n, p in zip(names, tr._params)
                       if not bool(torch.isfinite(p).all())],
        "unchanged": [n for n, p0, p, t in zip(names, start, tr._params,
                                               tr._trainable)
                      if t and torch.equal(p0, p)],
        "stats_still": [n for n, p0, p in zip(names, start, tr._params)
                        if "running" in n and torch.equal(p0, p)]}
    del tr, net, xg, yg
    torch.cuda.empty_cache()
    # the cross-replica check: fp32 from the main process's weights
    net = resnet50(mx, ctx, fuse=True)
    x, y = synthetic_images(np.random.RandomState(1), MESH_REF_BATCH,
                            MESH_REF_IMAGE)
    with mx.autograd.pause():
        net(mx.nd.array(x[:2], ctx=ctx))
    net.load_parameters(str(workdir / "ref-start.params"), ctx=ctx)
    tr = resnet_trainer(mx, net, mesh=mesh)
    losses = [float(tr.step(x, y).asnumpy())]
    tr.sync_to_block()
    after1 = {k: p.data().detach().cpu().numpy().copy()
              for k, p in net._collect_params_with_prefix().items()}
    losses.append(float(tr.step(x, y).asnumpy()))
    out["resnet_ref"] = {"losses": losses}
    if mesh.rank == 0:
        np.savez(workdir / "ref-mesh.npz", **after1)


def mesh_worker_bert(mx, ctx, workdir, out):
    """Phase 22 on one rank: BERT-base (a loss a row) from
    DIR/bert-start.params, 4 AdamW steps on the global batch, three ways:
    {dp:2}; {dp:2} with shard_opt_states and remat; {tp:2} with
    shard_params."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    from mxnet_tpu_torch.parallel import mesh as mesh_mod

    npz = np.load(workdir / "bert-batch.npz")
    batch = tuple(torch.from_numpy(npz[f"arr_{i}"]).cuda()
                  for i in range(len(npz.files)))
    y = torch.zeros(MESH_BERT_BATCH, device="cuda")
    # phase 21 ran first in this process: its b=2 forward that completes
    # the deferred shapes sends 6 products the tile rule refuses to the
    # plain version, as the JAX entry does (ops/kernels/conv_fused.py)
    kernels.reset_counts()
    for label, shape, kw in (
            ("dp", {"dp": 2}, {}),
            ("dp_zero_remat", {"dp": 2},
             dict(shard_opt_states=True, remat=True)),
            ("tp", {"tp": 2}, dict(shard_params=True))):
        net = pretrain_net(mx, ctx, dropout=0.0, rows=True)
        net.load_parameters(str(workdir / "bert-start.params"), ctx=ctx)
        tr = DataParallelTrainer(net, lambda out, _: out, "adamw",
                                 dict(MESH_ADAMW),
                                 mesh=mesh_mod.make_mesh(shape), **kw)
        tr.build(batch)
        sharded = [i for i, sp in enumerate(tr._specs) if sp]
        rec = {
            "state_bytes": sum(t.numel() * t.element_size()
                               for st in tr._states if st for t in st),
            "full_state_bytes": sum(
                2 * int(np.prod(shape)) * 4 for shape, t in
                zip(tr._full_shapes, tr._trainable) if t),
            "sharded_params": len(sharded),
            "sharded_half": all(
                2 * tr._params[i].numel() == int(np.prod(tr._full_shapes[i]))
                for i in sharded),
            "remat_children": getattr(tr, "_remat_count", None),
            "steps": [], "peak": 0}
        for _ in range(MESH_BERT_STEPS):
            torch.cuda.reset_peak_memory_stats()
            st = mesh_step_record(lambda: tr.step(batch, y), mesh_mod)
            rec["peak"] = max(rec["peak"], torch.cuda.max_memory_allocated())
            st["digest"] = digest(tr._full_values())
            rec["steps"].append(st)
        rec["plain_calls_on_cuda"] = sum(
            c.plain_calls_on_cuda for c in kernels.KERNEL_COUNTS.values())
        out[label] = rec
        del tr, net
        torch.cuda.empty_cache()


def mesh_worker(workdir, phases):
    """A rank of phases 21, 22 and 38 (``chip_smoke.py --mesh-worker DIR
    PHASES`` under the port's launcher; PHASES among ``resnet``, ``bert``
    and ``moe``, comma-separated, run in turn): writes
    ``DIR/<phase>-rank<r>.json`` a phase."""
    import logging

    import torch

    sys.path.insert(0, str(ROOT))
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_mod.make_mesh()  # joins the group: {"dp": world size}
    ctx = mx.gpu(mesh.rank if torch.cuda.device_count() >= mesh.size else 0)
    torch.cuda.set_device(ctx.device_id)
    mesh_phases(mx, ctx, Path(workdir), phases)
    dist.barrier()
    dist.shutdown()
    return 0


def mesh_phases(mx, ctx, workdir, phases):
    """Phases ``phases`` (among ``resnet``, ``bert`` and ``moe``,
    comma-separated) in turn on this rank, over ``make_mesh()`` of the
    process group it is in: ``DIR/<phase>-rank<r>.json`` a phase."""
    import torch

    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh()
    for phase in phases.split(","):
        out = {"rank": mesh.rank, "backend": dist.backend(),
               "mesh": mesh.shape, "device": str(ctx),
               "cards": torch.cuda.device_count()}
        if phase == "resnet":
            mesh_worker_resnet(mx, ctx, mesh, workdir, out)
        elif phase == "moe":
            mesh_worker_moe(mx, ctx, workdir, out)
        else:
            mesh_worker_bert(mx, ctx, workdir, out)
        with open(workdir / f"{phase}-rank{mesh.rank}.json", "w") as f:
            json.dump(out, f)
        torch.cuda.empty_cache()


def mesh_launch(workdir, phase, one_card):
    """Start MESH_RANKS ranks of ``chip_smoke.py --mesh-worker`` through the
    port's launcher (``one_card``: only gpu(0) visible to them) for
    ``phase`` (``resnet``, ``bert`` or both, comma-separated: one launch);
    returns their records in rank order, a list a phase for several."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(MESH_RANKS), "--launcher", "local", "-p", str(free_port()),
           sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
           str(workdir), phase]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if one_card:
        env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES",
                                              "0").split(",")[0]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, text=True,
                          capture_output=True, timeout=MESH_TIMEOUT_S)
    tail = (proc.stdout + proc.stderr).strip().splitlines()
    log(f"mesh {phase}: the workers' log ({time.perf_counter() - t0:.1f} s; "
        "lines about the backend and the eager rule, and the last lines):\n  "
        + "\n  ".join([ln for ln in tail if "backend" in ln
                       or "eagerly" in ln][:6] + tail[-8:]))
    if proc.returncode:
        raise SystemExit(f"mesh {phase}: the launch exited {proc.returncode}")
    return mesh_records(workdir, phase)


def mesh_records(workdir, phase):
    """The ranks' records of ``phase`` (comma-separated: a dict by
    phase), read and removed."""
    out = {}
    for ph in phase.split(","):
        out[ph] = [json.loads((workdir / f"{ph}-rank{r}.json").read_text())
                   for r in range(MESH_RANKS)]
        for f in workdir.glob(f"{ph}-rank*.json"):
            f.unlink()
    return out[phase] if len(out) == 1 else out


def per_step(steps, key, kind, field):
    import statistics as st

    return st.median(s[key][kind][field] for s in steps[1:])


def mesh_resnet_checks(ranks, want_backend, label):
    """Phase 21's gates on the ranks' records; returns ``(checks, launches
    a rank a step)``."""
    r0 = ranks[0]["resnet"]
    n = MESH_RESNET_STEPS
    per = [{k: v.get("launches", 0) for k, v in s["launches"].items()}
           for s in r0["steps"]]
    expect = {"matmul_bn_stats": 20, "bn_stats": 16,
              "bn_act_matmul_stats": 16}
    simple = sum(s["launches"].get(k, {}).get("simple_launches", 0)
                 for s in r0["steps"] for k in expect)
    scalar = sum(s["launches"].get("bn_stats", {}).get("scalar_launches", 0)
                 for s in r0["steps"])
    plain = sum(v.get("plain_calls_on_cuda", 0) for s in r0["steps"]
                for v in s["launches"].values())
    checks = {
        f"{label}_backend": all(r["backend"] == want_backend for r in ranks),
        f"{label}_mesh": all(r["mesh"] == {"dp": MESH_RANKS} for r in ranks),
        f"{label}_ranks_bit_identical_every_step": all(
            [s["digest"] for s in r["resnet"]["steps"]]
            == [s["digest"] for s in r0["steps"]] for r in ranks),
        f"{label}_finite": not any(r["resnet"]["not_finite"] for r in ranks),
        f"{label}_changed": not any(r["resnet"]["unchanged"] for r in ranks),
        f"{label}_stats_move": not any(r["resnet"]["stats_still"]
                                       for r in ranks),
        f"{label}_launches": all(p.get(k) == v for p in per
                                 for k, v in expect.items()),
        f"{label}_tma_route": simple == 0 and scalar == 0,
        f"{label}_plain_calls_on_cuda": plain == 0,
        f"{label}_eager_by_rule": all(
            r["resnet"]["eager_reason"] and r["resnet"]["eager_steps"] == n
            for r in ranks),
        f"{label}_stats_allreduced": all(
            s["comm"]["stats"]["calls"] == 2 * 53 for s in r0["steps"]),
    }
    return checks, per[-1]


def mesh_resnet_reference(mx, d):
    """Phase 21's one-process reference: 2 fp32 steps at b=16, 112^2 from
    the weights it saves as ``d/ref-start.params``; returns the losses,
    the starting weights and the weights after step 1."""
    import numpy as np
    import torch

    gpu = mx.gpu(0)
    x, y = synthetic_images(np.random.RandomState(1), MESH_REF_BATCH,
                            MESH_REF_IMAGE)
    net = resnet50(mx, gpu, fuse=True)
    trainer = resnet_trainer(mx, net)
    trainer.build(mx.nd.array(x, ctx=gpu))
    net.save_parameters(str(d / "ref-start.params"))
    start = {k: p.data().detach().cpu().numpy().copy()
             for k, p in net._collect_params_with_prefix().items()}
    losses = [float(trainer.step(x, y).asnumpy())]
    trainer.sync_to_block()
    one = {k: p.data().detach().cpu().numpy().copy()
           for k, p in net._collect_params_with_prefix().items()}
    losses.append(float(trainer.step(x, y).asnumpy()))
    del net, trainer
    torch.cuda.empty_cache()
    return losses, start, one


def train_mesh_resnet(mx, card, d, ranks, reference, want_backend):
    """Phase 21 (and 21b): fused ResNet-50 over make_mesh() = {dp:2}, the
    ranks' records ``ranks`` against ``reference``.  Returns the launches
    of both ranks' 6 steps by kernel."""
    import statistics as st

    import numpy as np
    import torch

    n_gpu = torch.cuda.device_count()
    losses, start, one = reference
    checks = {}
    mesh = dict(np.load(d / "ref-mesh.npz"))
    c, per = mesh_resnet_checks(ranks, want_backend, "mesh_resnet")
    checks.update(c)
    # the cross-replica check against one process over the 16 images
    ml = ranks[0]["resnet_ref"]["losses"]
    gaps = {"loss1": abs(ml[0] - losses[0]) / abs(losses[0]),
            "loss2": abs(ml[1] - losses[1]) / abs(losses[1])}
    for w, k in (("fc", RESNET_FC_KEY), ("top", RESNET_TOP_KEY),
                 ("deep", RESNET_DEEP_KEY)):
        u1, u2 = one[k] - start[k], mesh[k] - start[k]
        gaps[w] = float(np.linalg.norm(u2 - u1) / np.linalg.norm(u1))
    gaps["stats"] = max(
        float(np.abs(mesh[k] - one[k]).max() / np.abs(one[k]).max())
        for k in one if "running" in k)
    limits = {"loss1": RESNET_LOSS1_RTOL, "loss2": RESNET_LOSS2_RTOL,
              "fc": RESNET_FC_UPDATE_RTOL, "top": RESNET_TOP_UPDATE_RTOL,
              "deep": RESNET_UPDATE_RTOL, "stats": MESH_STATS_RTOL}
    for k, v in gaps.items():
        checks[f"mesh_resnet_cross_replica_{k}"] = v <= limits[k]
    r0 = ranks[0]["resnet"]["steps"]
    log(f"mesh resnet: ResNet-50 v1 NHWC fused, bf16 compute, SGD "
        f"momentum, {MESH_RESNET_STEPS} steps at the global batch "
        f"{RESNET_BATCH} x {RESNET_IMAGE}^2 over {ranks[0]['mesh']} "
        f"({', '.join(r['device'] for r in ranks)}; backend "
        f"{ranks[0]['backend']}, the rule's for 2 ranks on one card: "
        f"gloo); losses {[round(s['loss'], 5) for s in r0]}; ranks "
        f"bit-identical every step "
        f"{checks['mesh_resnet_ranks_bit_identical_every_step']}; "
        f"launches a rank a step {per}; eager by rule: "
        f"{ranks[0]['resnet']['eager_reason']!r}; on {card}")
    log(f"mesh resnet: a step: median "
        f"{[st.median(s['ms'] for s in r['resnet']['steps'][1:]) for r in ranks]}"
        f" ms a rank (one process at b={RESNET_BATCH}: phase 7); "
        f"gradient all-reduce {per_step(r0, 'comm', 'grad', 'ms'):.3f} "
        f"ms, {per_step(r0, 'comm', 'grad', 'bytes')} bytes in "
        f"{per_step(r0, 'comm', 'grad', 'calls')} call(s) a step; "
        f"BatchNorm statistics {per_step(r0, 'comm', 'stats', 'calls')} "
        f"all-reduces a step ({per_step(r0, 'comm', 'stats', 'bytes')} "
        f"bytes, {per_step(r0, 'comm', 'stats', 'ms'):.3f} ms); loss "
        f"{per_step(r0, 'comm', 'loss', 'ms'):.3f} ms; on {card}")
    log(f"mesh resnet: cross-replica check, b={MESH_REF_BATCH} "
        f"{MESH_REF_IMAGE}^2 fp32, 2 steps, {{dp:2}} against one "
        f"process over the same images and weights on gpu(0): losses "
        f"{ml} vs {losses}; gaps "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f"; limits {limits}")
    launches = {"mesh_resnet_train": {
        k: sum(s["launches"].get(k, {}).get("launches", 0)
               for r in ranks for s in r["resnet"]["steps"])
        for k in ("matmul_bn_stats", "bn_stats", "bn_act_matmul_stats")}}
    if n_gpu < 2:
        log(f"mesh resnet 21b: {{dp:2}} over gpu(0), gpu(1) with NCCL: "
            f"needs 2 GPUs, {n_gpu} visible")
    else:
        ranks2 = mesh_launch(d, "resnet", one_card=False)
        c2, per2 = mesh_resnet_checks(ranks2, "nccl", "mesh_resnet_nccl")
        checks.update(c2)
        l1 = [s["loss"] for s in r0]
        l2 = [s["loss"] for s in ranks2[0]["resnet"]["steps"]]
        gap = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
        checks["mesh_resnet_nccl_losses"] = gap <= RESNET_ROUTE_RTOL[-1]
        log(f"mesh resnet 21b: over {[r['device'] for r in ranks2]} "
            f"with {ranks2[0]['backend']}: losses {l2}, max rel gap to "
            f"phase 21 {gap:.3g}; gradient all-reduce "
            f"{per_step(ranks2[0]['resnet']['steps'], 'comm', 'grad', 'ms'):.3f}"
            f" ms a step; launches a rank a step {per2}; on {card}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"mesh resnet checks failed: {failed}")
    return launches


def mesh_bert_reference(mx, d):
    """Phase 22's one-process reference: the losses of MESH_BERT_STEPS
    eager steps over the global batch, from the weights and batch it
    saves as ``d/bert-start.params`` and ``d/bert-batch.npz``."""
    import numpy as np
    import torch

    gpu = mx.gpu(0)
    data = synthetic_batch(np.random.RandomState(22), MESH_BERT_BATCH,
                           MESH_BERT_SEQ, 30522)
    np.savez(d / "bert-batch.npz", *data)
    net = pretrain_net(mx, gpu, dropout=0.0, rows=True)
    batch = tuple(torch.from_numpy(a).cuda() for a in data)
    with mx.autograd.pause():
        net(*[b[:2] for b in batch])
    net.save_parameters(str(d / "bert-start.params"))
    tr = mx.parallel.DataParallelTrainer(net, lambda out, _: out,
                                         "adamw", dict(MESH_ADAMW),
                                         capture=False)
    y = torch.zeros(MESH_BERT_BATCH, device="cuda")
    ref = [float(tr.step(batch, y).asnumpy())
           for _ in range(MESH_BERT_STEPS)]
    del tr, net, batch
    torch.cuda.empty_cache()
    return ref


def train_mesh_bert(mx, card, ranks, ref, want_backend):
    """Phase 22: BERT-base MLM+NSP (a loss a row) through the trainer on 2
    ranks: {dp:2}; {dp:2} with ZeRO states and remat; {tp:2} with sharded
    parameters; the ranks' records ``ranks`` against the one-process
    losses ``ref``.  Returns the launches by kernel of both ranks' runs."""
    import statistics as st

    checks = {}
    runs = {k: [r[k] for r in ranks] for k in ("dp", "dp_zero_remat", "tp")}
    want = {"dp": (12, 12, 12), "dp_zero_remat": (24, 12, 12),
            "tp": (12, 12, 12)}
    kinds = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    gaps = {}
    for label, rs in runs.items():
        losses = [s["loss"] for s in rs[0]["steps"]]
        gaps[label] = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        checks[f"{label}_ranks_bit_identical"] = all(
            [s["digest"] for s in r["steps"]]
            == [s["digest"] for s in rs[0]["steps"]] for r in rs)
        checks[f"{label}_launches"] = all(
            s["launches"].get(k, {}).get("launches", 0) == n
            for r in rs for s in r["steps"] for k, n in zip(kinds,
                                                            want[label]))
        checks[f"{label}_plain_calls_on_cuda"] = all(
            r["plain_calls_on_cuda"] == 0 for r in rs)
    checks["backend"] = all(r["backend"] == want_backend for r in ranks)
    for label in ("dp_zero_remat", "tp"):
        checks[f"{label}_losses_vs_one_process"] = gaps[label] \
            <= MESH_LOSS_RTOL
    a, plain = runs["dp_zero_remat"][0], runs["dp"][0]
    checks["zero_remat_bit_identical_to_dp"] = (
        [s["loss"] for s in a["steps"]] == [s["loss"] for s in plain["steps"]]
        and [s["digest"] for s in a["steps"]]
        == [s["digest"] for s in plain["steps"]])
    share = a["state_bytes"] / a["full_state_bytes"]
    checks["zero_state_bytes_half"] = 0.45 <= share <= 0.55
    checks["remat_wraps_the_model"] = a["remat_children"] == 1
    tp = runs["tp"][0]
    checks["tp_params_half_at_rest"] = tp["sharded_params"] > 0 \
        and tp["sharded_half"]
    for label, rs in runs.items():
        steps = rs[0]["steps"]
        log(f"mesh bert {label}: BERT-base MLM+NSP (a loss a row) fp32 "
            f"dropout 0 AdamW, {MESH_BERT_STEPS} steps at the global batch "
            f"{MESH_BERT_BATCH} x {MESH_BERT_SEQ} over {label} (backend "
            f"{ranks[0]['backend']}): losses {[s['loss'] for s in steps]}, max "
            f"rel gap to one process {gaps[label]:.3g} (limit "
            f"{MESH_LOSS_RTOL}); flash launches a rank a step "
            f"{ {k: steps[-1]['launches'].get(k, {}).get('launches') for k in kinds} };"
            f" step median {[st.median(s['ms'] for s in r['steps'][1:]) for r in rs]}"
            f" ms a rank; gradient all-reduce "
            f"{per_step(steps, 'comm', 'grad', 'ms'):.3f} ms, "
            f"{per_step(steps, 'comm', 'grad', 'bytes')} bytes in "
            f"{per_step(steps, 'comm', 'grad', 'calls')} call(s); parameter "
            f"all-gathers {per_step(steps, 'comm', 'param', 'calls')} "
            f"({per_step(steps, 'comm', 'param', 'bytes')} bytes, "
            f"{per_step(steps, 'comm', 'param', 'ms'):.3f} ms) a step; "
            f"optimizer states {rs[0]['state_bytes'] / 2**20:.1f} of "
            f"{rs[0]['full_state_bytes'] / 2**20:.1f} MiB a rank; "
            f"{rs[0]['sharded_params']} parameters sharded at rest; peak "
            f"memory of a step a rank {[r['peak'] / 2**30 for r in rs]} GiB"
            + (f" (phase 24's Trainer(mesh_shape='mp=2'), whose products "
               f"compute on the shards: "
               f"{[b / 2**30 for b in SPMD_PEAK.get('mp2', [])]} GiB)"
               if label == "tp" else "") + f"; on {card}")
    log(f"mesh bert: one process over the global batch on gpu(0): losses "
        f"{ref}; {{dp:2}} with ZeRO and remat bit-identical to {{dp:2}}: "
        f"{checks['zero_remat_bit_identical_to_dp']}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"mesh bert checks failed: {failed}")
    return {"mesh_bert_train": {
        k: sum(s["launches"].get(k, {}).get("launches", 0)
               for rs in runs.values() for r in rs for s in r["steps"])
        for k in kinds}}


# -- phase 26: the input tier -------------------------------------------------


def write_mnist_files(root, n_train=MNIST_TRAIN, n_test=MNIST_TEST):
    """MNIST-format idx files (train-*/t10k-*) of ``n_train`` and ``n_test``
    28x28 uint8 rows: train_mnist.py's separable digits (a bright band of 6
    rows at 2k for class k over noise of 0.1) drawn from seed 0, scaled to
    uint8."""
    import struct

    import numpy as np

    n = n_train + n_test
    rng = np.random.RandomState(0)
    x = rng.rand(n, 28, 28).astype(np.float32) * 0.1
    y = rng.randint(0, 10, n)
    for k in range(10):
        x[y == k, 2 * k:2 * k + 6, :] += 0.9
    img = np.clip(np.round(x * 255), 0, 255).astype(np.uint8)
    for pre, sl in (("train", slice(0, n_train)), ("t10k", slice(n_train, n))):
        m = img[sl].shape[0]
        with open(os.path.join(root, f"{pre}-images-idx3-ubyte"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, m, 28, 28))
            f.write(img[sl].tobytes())
        with open(os.path.join(root, f"{pre}-labels-idx1-ubyte"), "wb") as f:
            f.write(struct.pack(">II", 2049, m))
            f.write(y[sl].astype(np.uint8).tobytes())


def lenet_step(mx, net, trainer, loss_fn, x, y):
    with mx.autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
    loss.backward()
    trainer.step(x.shape[0])
    return out, loss


def train_lenet(mx, card, root):
    """Phase 26 (a): LeNet on MNIST files as train_mnist.py trains it, on a
    shuffle of the first ``LENET_ROWS`` rows (a sixth of the epoch) on the
    card; validation through ``io.MNISTIter``; the first
    ``LENET_REF_STEPS`` steps again on the CPU from the same weights and
    batches."""
    import numpy as np
    import torch

    gpu, cpu = mx.gpu(0), mx.cpu()
    t0 = time.perf_counter()
    write_mnist_files(root)
    gen_s = time.perf_counter() - t0
    vision = mx.gluon.data.vision
    to_tensor = vision.transforms.ToTensor()
    mx.random.seed(42)
    np.random.seed(0)   # RandomSampler's stream
    train = vision.MNIST(root, train=True,
                         transform=lambda x, y: (to_tensor(x), y))
    loader = mx.gluon.data.DataLoader(
        train, batch_size=LENET_BATCH, num_workers=DATA_WORKERS,
        sampler=mx.gluon.data.RandomSampler(LENET_ROWS))

    def build(ctx):
        net = mx.gluon.model_zoo.vision.lenet()
        net.initialize(mx.init.Xavier(), ctx=ctx)
        net(mx.nd.array(np.zeros((1, 1, 28, 28), np.float32), ctx=ctx))
        net.hybridize()
        return net, mx.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": 0.05, "momentum": 0.9})

    net, trainer = build(gpu)
    start = {k: p.data().detach().cpu().numpy().copy()
             for k, p in net._collect_params_with_prefix().items()}
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    mx.pipeline.reset_pipeline_stats()
    first, card_losses, n = [], [], 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for x, y in loader:
        if len(first) < LENET_REF_STEPS:
            first.append((x.asnumpy(), y.asnumpy()))
        out, loss = lenet_step(mx, net, trainer, loss_fn,
                               x.as_in_context(gpu), y.as_in_context(gpu))
        metric.update([y], [out])
        if len(card_losses) < LENET_REF_STEPS:
            card_losses.append(float(loss.asnumpy().mean()))
        n += x.shape[0]
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t1
    train_acc = metric.get()[1]
    stats = mx.pipeline.pipeline_stats()
    metric.reset()
    val = mx.io.MNISTIter(image=os.path.join(root, "t10k-images-idx3-ubyte"),
                          label=os.path.join(root, "t10k-labels-idx1-ubyte"),
                          batch_size=LENET_BATCH, shuffle=False)
    t2 = time.perf_counter()
    for batch in val:
        metric.update([batch.label[0]], [net(batch.data[0])])
    val_s = time.perf_counter() - t2
    val_acc = metric.get()[1]

    cnet, ctrainer = build(cpu)
    mx.load_numpy_params(cnet, start)
    cpu_losses = []
    for xb, yb in first:
        _, loss = lenet_step(mx, cnet, ctrainer, loss_fn,
                             mx.nd.array(xb, ctx=cpu),
                             mx.nd.array(yb, ctx=cpu))
        cpu_losses.append(float(loss.asnumpy().mean()))
    gaps = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    log(f"input tier lenet: {MNIST_TRAIN} + {MNIST_TEST} MNIST rows written "
        f"in {gen_s:.2f} s; {n} samples ({len(loader)} steps of "
        f"{LENET_BATCH}, DataLoader with {DATA_WORKERS} workers) in "
        f"{epoch_s:.3f} s ({n / epoch_s:.0f} samples/s), train accuracy "
        f"{train_acc:.4f}; the consumer waited {stats['wait_ms']:.1f} ms in "
        f"all, batches built in {stats['host_build_ms']:.1f} worker-ms; "
        f"validation through MNISTIter {val_acc:.4f} in {val_s:.3f} s on "
        f"{card}")
    log(f"input tier lenet: first {LENET_REF_STEPS} losses card "
        f"{card_losses}, cpu {cpu_losses}, relative gaps "
        f"{[f'{g:.2e}' for g in gaps]} (limit {LENET_LOSS_RTOL})")
    checks = {"lenet_val_accuracy": val_acc >= LENET_MIN_ACC,
              "lenet_card_vs_cpu": len(gaps) == LENET_REF_STEPS
              and max(gaps) <= LENET_LOSS_RTOL,
              "lenet_finite": bool(np.isfinite(card_losses).all())}
    record = {"samples_per_s": n / epoch_s, "epoch_s": epoch_s,
              "train_accuracy": train_acc, "val_accuracy": val_acc,
              "loss_gaps": gaps, "wait_ms": stats["wait_ms"]}
    return checks, record


def image_loader(mx, images, labels):
    """The ResNet-50 input pipeline of phase 26 (b): a shuffled DataLoader
    over the uint8 images with RandomFlipLeftRight, ToTensor and ImageNet's
    Normalize, as a pipeline, then NHWC as train_imagenet.py makes it for
    ``--layout NHWC``.  The NHWC map runs one batch at a time, in order,
    and keeps a copy of each host batch in ``built``."""
    import torch

    tv = mx.gluon.data.vision.transforms
    aug = tv.Compose([tv.RandomFlipLeftRight(), tv.ToTensor(),
                      tv.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    ds = mx.gluon.data.ArrayDataset(images, labels).transform_first(aug)
    loader = mx.gluon.data.DataLoader(ds, batch_size=RESNET_BATCH,
                                      shuffle=True, num_workers=DATA_WORKERS)
    built = []

    def nhwc(batch):
        x, y = batch
        x = mx.nd.NDArray(x.data.permute(0, 2, 3, 1).contiguous(), x.context)
        built.append((x.data.clone(), torch.as_tensor(y.data).clone()))
        return x, y

    return loader, nhwc, built


def pipeline_resnet(mx, card, root, captured_ms):
    """Phase 26 (b): ResNet-50 fed by a DataLoader pipeline through phase
    15's captured step; a checkpoint after ``DATA_SAVE_AT`` steps resumed
    into a fresh trainer and pipeline."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels

    gpu, cpu = mx.gpu(0), mx.cpu()
    rng = np.random.RandomState(0)
    images = mx.nd.array(rng.randint(0, 256, (DATA_IMAGES, RESNET_IMAGE,
                                              RESNET_IMAGE, 3),
                                     dtype=np.uint8), ctx=cpu)
    labels = rng.randint(0, 1000, DATA_IMAGES).astype(np.float32)
    steps = DATA_IMAGES // RESNET_BATCH

    # the host build time of one batch, on this thread
    loader, nhwc, _ = image_loader(mx, images, labels)
    idxs = list(range(RESNET_BATCH))
    t0 = time.perf_counter()
    nhwc(loader._fetch_batch(idxs))
    build_ms = (time.perf_counter() - t0) * 1e3

    np.random.seed(0)
    loader, nhwc, built = image_loader(mx, images, labels)
    pipe = loader.as_pipeline().map(nhwc, inflight=1).prefetch_to_device(
        gpu, depth=2)
    net = resnet50(mx, gpu, fuse=True)
    trainer = resnet_trainer(mx, net, compute_dtype="bfloat16", capture=True)
    trainer.build(torch.zeros(2, RESNET_IMAGE, RESNET_IMAGE, 3,
                              device=gpu.torch_device()))
    mgr = mx.checkpoint.CheckpointManager(os.path.join(root, "ckpt"))
    prefix = os.path.join(root, "resnet50")
    mx.pipeline.reset_pipeline_stats()
    kernels.reset_counts()
    seen, losses, step_ms, wait_ms, gains = [], [], [], [], []
    save_s = None
    for i in range(steps):
        before = counts_now()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x, y = next(pipe)
        wait_ms.append((time.perf_counter() - t1) * 1e3)
        seen.append((x.data.clone(), y.data.clone()))   # what the stream read
        losses.append(trainer.step(x, y).asscalar())
        step_ms.append((time.perf_counter() - t1) * 1e3)
        gains.append(counts_gain(before, counts_now()))
        if i + 1 == DATA_SAVE_AT:
            t2 = time.perf_counter()
            mgr.save(DATA_SAVE_AT, pipeline=pipe, sync=True)
            trainer.save_states(prefix)
            save_s = time.perf_counter() - t2
    stats = mx.pipeline.pipeline_stats()
    launches = {k: c.launches for k, c in kernels.KERNEL_COUNTS.items()}
    simple = {k: kernels.KERNEL_COUNTS[k].simple_launches
              for k in ("matmul_bn_stats", "bn_act_matmul_stats")}
    plain = sum(c.plain_calls_on_cuda for c in kernels.KERNEL_COUNTS.values())
    leftover = list(pipe)
    torch.cuda.synchronize()
    same_host = len(built) == steps and all(
        torch.equal(a.cpu(), b) and torch.equal(c.cpu(), d)
        for (a, c), (b, d) in zip(seen, built))
    del trainer
    torch.cuda.empty_cache()

    # the resume: a fresh trainer over re-initialised weights, a fresh
    # pipeline, the checkpoint's states
    mx.random.seed(5)
    net.initialize(mx.init.Xavier(), ctx=gpu, force_reinit=True)
    fresh = resnet_trainer(mx, net, compute_dtype="bfloat16", capture=True)
    fresh.build(torch.zeros(2, RESNET_IMAGE, RESNET_IMAGE, 3,
                            device=gpu.torch_device()))
    fresh.load_states(prefix)
    np.random.seed(123)   # the restored stream must not draw again
    loader2, nhwc2, built2 = image_loader(mx, images, labels)
    pipe2 = loader2.as_pipeline().map(nhwc2, inflight=1).prefetch_to_device(
        gpu, depth=2)
    t3 = time.perf_counter()
    mgr.restore(pipeline=pipe2)
    restore_s = time.perf_counter() - t3
    kernels.reset_counts()
    resumed, rgains = [], []
    for _ in range(steps - DATA_SAVE_AT):
        before = counts_now()
        x, y = next(pipe2)
        resumed.append((x.data.clone(), y.data.clone(),
                        fresh.step(x, y).asscalar()))
        rgains.append(counts_gain(before, counts_now()))
    rlaunches = {k: c.launches for k, c in kernels.KERNEL_COUNTS.items()}
    plain += sum(c.plain_calls_on_cuda
                 for c in kernels.KERNEL_COUNTS.values())
    rest = list(pipe2)
    torch.cuda.synchronize()
    same_batches = all(torch.equal(a, b) and torch.equal(c, d)
                       for (a, c, _), (b, d) in zip(resumed,
                                                    seen[DATA_SAVE_AT:]))
    same_losses = [v for _, _, v in resumed] == losses[DATA_SAVE_AT:]
    expect = {"matmul_bn_stats": 20, "bn_stats": 16, "bn_act_matmul_stats": 16}
    per_step_ok = all(all(g.get(k, {}).get("launches") == v
                          for k, v in expect.items()) for g in gains + rgains)
    median = statistics.median(step_ms[2:])
    b = max(stats["batches"], 1)
    log(f"input tier resnet: {steps} steps of b={RESNET_BATCH} {RESNET_IMAGE}^2"
        f" bf16 fed by DataLoader({DATA_WORKERS} workers) -> NHWC -> "
        f"prefetch_to_device(gpu(0), 2): step median {median:.3f} ms over "
        f"steps 3-{steps} (steps {[round(v, 3) for v in step_ms]}); phase "
        f"15's device-resident captured median {captured_ms:.3f} ms in this "
        f"run, on {card}")
    log(f"input tier resnet: the consumer waited {stats['wait_ms'] / b:.3f} "
        f"ms a step (steps {[round(v, 3) for v in wait_ms]}, median of steps "
        f"3-{steps} {statistics.median(wait_ms[2:]):.3f}); h2d_ms {stats['h2d_ms'] / b:.3f} a batch (pinned staging "
        f"and the copies' enqueue); prefetch hits {stats['prefetch_hits']}, "
        f"misses {stats['prefetch_misses']}; batches built in "
        f"{stats['host_build_ms']:.1f} worker-ms; one batch built on one "
        f"thread in {build_ms:.1f} ms; storage {mx.storage.Storage.get().stats()}")
    log(f"input tier resnet: every batch the stream read equal to the host "
        f"batch {same_host}; saved after step {DATA_SAVE_AT} in {save_s:.3f} s "
        f"(pipeline state {dir_bytes(os.path.join(root, 'ckpt'))} bytes), "
        f"restored in {restore_s:.3f} s; steps {DATA_SAVE_AT + 1}-{steps} "
        f"resumed: losses {[v for _, _, v in resumed]} vs {losses[DATA_SAVE_AT:]}"
        f" bit-identical {same_losses}, batches bit-identical {same_batches}; "
        f"launches a step {gains[-1]}; simple-route launches {simple}; plain "
        f"calls on cuda {plain}")
    checks = {"resnet_batches_equal_host": same_host,
              "resnet_epoch_consumed": not leftover and not rest
              and len(resumed) == steps - DATA_SAVE_AT,
              "resnet_resumed_losses_bit_identical": same_losses,
              "resnet_resumed_batches_bit_identical": same_batches,
              "resnet_launches": per_step_ok,
              "resnet_tma_route": all(v == 0 for v in simple.values()),
              "resnet_plain_calls_on_cuda": plain == 0,
              "resnet_finite": bool(np.isfinite(losses).all())}
    record = {"median_ms": median, "captured_ms": captured_ms,
              "wait_ms_a_step": stats["wait_ms"] / b,
              "wait_ms_median": statistics.median(wait_ms[2:]),
              "build_worker_ms_a_batch": stats["host_build_ms"] / b,
              "h2d_ms_a_batch": stats["h2d_ms"] / b, "build_ms": build_ms,
              "launches": {k: launches[k] for k in expect},
              "resumed_launches": {k: rlaunches[k] for k in expect}}
    del fresh, net, seen, resumed, built
    torch.cuda.empty_cache()
    return checks, record


def input_tier(mx, card, captured_ms):
    """Phase 26 in a temporary directory of the checkout that is removed
    after; returns the ResNet path's launches of rows 7, 8 and 10."""
    t0 = time.perf_counter()
    tmpdir = tempfile.mkdtemp(prefix="data-smoke-", dir=ROOT)
    try:
        checks, lenet = train_lenet(mx, card, tmpdir)
        more, resnet = pipeline_resnet(mx, card, tmpdir, captured_ms)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    checks.update(more)
    log(f"input tier: {json.dumps({'lenet': lenet, 'resnet': resnet})}; "
        f"phase 26 took {time.perf_counter() - t0:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"input tier checks failed: {failed}")
    return {"pipeline_resnet_train": resnet["launches"],
            "pipeline_resnet_resumed": resnet["resumed_launches"]}


# -- phase 27: the image and text tiers ---------------------------------------


def write_jpeg_records(mx, path):
    """Phase 27's indexed .rec: ``JPEG_DISTINCT`` smooth 500x375 RGB images
    from seed 0 (sinusoids plus 20 levels of noise), each encoded once at
    quality 95 and written under ``JPEG_RECORDS / JPEG_DISTINCT`` ids, with
    labels in [0, 1000).  Returns the mean JPEG size in bytes."""
    import numpy as np

    rio = mx.recordio
    rng = np.random.RandomState(0)
    h, w = JPEG_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    payloads = []
    for k in range(JPEG_DISTINCT):
        img = np.stack([128 + 60 * np.sin(xx / (17 + k % 13) + c + k)
                        + 50 * np.cos(yy / (23 + k % 7) - c)
                        for c in range(3)], -1)
        img = np.clip(img + rng.randint(0, 20, img.shape), 0, 255)
        _, jpeg = rio.unpack(rio.pack_img(rio.IRHeader(0, 0.0, 0, 0),
                                          img.astype(np.uint8), quality=95))
        payloads.append(jpeg)
    labels = rng.randint(0, 1000, JPEG_RECORDS)
    rec = rio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(JPEG_RECORDS):
        rec.write_idx(i, rio.pack(rio.IRHeader(0, float(labels[i]), i, 0),
                                  payloads[i % JPEG_DISTINCT]))
    rec.close()
    return sum(len(p) for p in payloads) / len(payloads)


def jpeg_resnet(mx, card, root, captured_ms):
    """Phase 27 (a): ResNet-50 fed from JPEG records through
    ``ImageRecordIter`` with train_imagenet.py's recipe, NHWC, through
    phase 15's captured ``DataParallelTrainer`` step for one pass."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.storage import Storage
    from mxnet_tpu_torch.utils import native

    gpu = mx.gpu(0)
    path = os.path.join(root, "train.rec")
    t0 = time.perf_counter()
    jpeg_bytes = write_jpeg_records(mx, path)
    write_s = time.perf_counter() - t0
    lib = native.load()
    want_lane = "native" if lib is not None else "python"
    refused = None
    recipe = IMAGENET_RECIPE
    if lib is None:
        try:
            mx.io.ImageRecordIter(path, use_native=True, **recipe)
        except mx.MXNetError as e:
            refused = str(e)
    else:
        # the native lane's augmentation streams are its threads': a batch
        # is reproducible on one thread only (ROADMAP, reference caveat (l))
        recipe = dict(recipe, preprocess_threads=1)

    # the host iterator alone, one pass: the reference batches
    with mx.cpu():
        host = mx.io.ImageRecordIter(path, **recipe)
    t1 = time.perf_counter()
    ref = [(b.data[0].data.clone(), b.label[0].data.clone()) for b in host]
    alone_s = time.perf_counter() - t1
    # the host decode of one batch, on this thread
    recs = [host._rec.read_idx(k) for k in host._keys[:RESNET_BATCH]]
    t2 = time.perf_counter()
    if host.lane == "python":
        Storage.get().free(host._decode_batch(recs, 0))
        decode_ms = (time.perf_counter() - t2) * 1e3
    else:
        decode_ms = None   # the native lane decodes on its own threads
    del host

    it = mx.io.ImageRecordIter(path, **recipe)
    net = resnet50(mx, gpu, fuse=True)
    trainer = resnet_trainer(mx, net, compute_dtype="bfloat16", capture=True)
    trainer.build(torch.zeros(2, RESNET_IMAGE, RESNET_IMAGE, 3,
                              device=gpu.torch_device()))
    start = [p.detach().clone() for p in trainer._params]
    kernels.reset_counts()
    seen, losses, step_ms, wait_ms, gains = [], [], [], [], []
    for _ in range(JPEG_RECORDS // RESNET_BATCH):
        before = counts_now()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        batch = it.next()
        wait_ms.append((time.perf_counter() - t3) * 1e3)
        x, y = batch.data[0].data, batch.label[0].data
        seen.append((x.clone(), y.clone()))   # what the card received
        xh = mx.nd.NDArray(x.permute(0, 2, 3, 1).contiguous(), gpu)
        losses.append(trainer.step(xh, batch.label[0]).asscalar())
        step_ms.append((time.perf_counter() - t3) * 1e3)
        gains.append(counts_gain(before, counts_now()))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in kernels.KERNEL_COUNTS.items()}
    simple = {k: kernels.KERNEL_COUNTS[k].simple_launches
              for k in ("matmul_bn_stats", "bn_act_matmul_stats")}
    plain = sum(c.plain_calls_on_cuda for c in kernels.KERNEL_COUNTS.values())
    leftover = list(it)
    same = len(seen) == len(ref) and all(
        torch.equal(a.cpu(), c) and torch.equal(b.cpu(), d)
        for (a, b), (c, d) in zip(seen, ref))
    params = trainer._params
    finite = all(bool(torch.isfinite(p).all()) for p in params)
    changed = [i for i, (p, p0) in enumerate(zip(params, start))
               if torch.equal(p, p0)]
    expect = {"matmul_bn_stats": 20, "bn_stats": 16, "bn_act_matmul_stats": 16}
    per_step_ok = all(all(g.get(k, {}).get("launches") == v
                          for k, v in expect.items()) for g in gains)
    median = statistics.median(step_ms[2:])
    n_img = len(ref) * RESNET_BATCH
    log(f"image tier resnet: {JPEG_RECORDS} JPEG records of "
        f"{JPEG_HW[1]}x{JPEG_HW[0]} ({jpeg_bytes / 1e3:.1f} KB a JPEG) "
        f"written in {write_s:.2f} s; lane {it.lane} ({it.lane_reason}); "
        f"utils.native.load_error(): {native.load_error()}; "
        f"use_native=True refused: {refused}")
    log(f"image tier resnet: the host iterator alone (cpu(), "
        f"{recipe['preprocess_threads']} threads, "
        f"prefetch 2) decoded {n_img} records in {alone_s:.3f} s "
        f"({n_img / alone_s:.1f} samples/s); one batch of {RESNET_BATCH} "
        f"decoded on this thread in "
        f"{'n/a' if decode_ms is None else f'{decode_ms:.1f}'} ms")
    log(f"image tier resnet: {len(step_ms)} steps of b={RESNET_BATCH} "
        f"{RESNET_IMAGE}^2 bf16 fed by ImageRecordIter -> NHWC: step median "
        f"{median:.3f} ms over steps 3-{len(step_ms)} (steps "
        f"{[round(v, 3) for v in step_ms]}); phase 15's device-resident "
        f"captured median {captured_ms:.3f} ms in this run, on {card}; the "
        f"consumer waited {statistics.median(wait_ms[2:]):.3f} ms a step "
        f"(median of steps 3-{len(wait_ms)}; steps "
        f"{[round(v, 3) for v in wait_ms]})")
    log(f"image tier resnet: every card batch bit-identical to the cpu() "
        f"iterator's {same}; losses {losses}; parameters finite {finite}, "
        f"unchanged {changed}; launches a step {gains[-1]}; simple-route "
        f"launches {simple}; plain calls on cuda {plain}; storage "
        f"{Storage.get().stats()}")
    checks = {"jpeg_lane": it.lane == want_lane,
              "jpeg_use_native_refused": lib is not None or refused is not None,
              "jpeg_batches_equal_host": same,
              "jpeg_pass_consumed": not leftover and len(seen) == 6,
              "jpeg_finite": bool(np.isfinite(losses).all()) and finite,
              "jpeg_params_changed": not changed,
              "jpeg_launches": per_step_ok,
              "jpeg_tma_route": all(v == 0 for v in simple.values()),
              "jpeg_plain_calls_on_cuda": plain == 0}
    record = {"lane": it.lane, "alone_samples_per_s": n_img / alone_s,
              "decode_ms": decode_ms, "median_ms": median,
              "captured_ms": captured_ms,
              "wait_ms_median": statistics.median(wait_ms[2:]),
              "launches": {k: launches[k] for k in expect}}
    del trainer, net, seen, ref, it
    torch.cuda.empty_cache()
    return checks, record


def corpus_bert(mx, card, root, captured_ms):
    """Phase 27 (b): BERT-base MLM+NSP fed from a text corpus through
    ``data.bert.BertPretrainPipeline`` and ``pipeline/`` into phase 15's
    captured whole step."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _imperative
    from mxnet_tpu_torch.data import bert as dbert
    from mxnet_tpu_torch.gluon import trainer as mtrainer
    from mxnet_tpu_torch.ops import kernels

    gpu = mx.gpu(0)
    path = os.path.join(root, "corpus.txt")
    with open(path, "w") as f:
        f.write("\n".join(dbert.synthetic_corpus(np.random.RandomState(0),
                                                 **CORPUS)) + "\n")
    with open(path) as f:
        lines = f.readlines()
    t0 = time.perf_counter()
    tok = mx.data.WordPieceTokenizer.build([ln for ln in lines if ln.strip()],
                                           vocab_size=WORDPIECE_VOCAB)
    tok_s = time.perf_counter() - t0
    built = []

    def host_batches():
        src = dbert.BertPretrainPipeline(lines, tok, seq_len=TRAIN_SEQ, seed=0)
        for b in src.batches(TRAIN_BATCH, CORPUS_STEPS):
            built.append({k: v.copy() for k, v in b.items()})
            yield b

    keys = ("input_ids", "token_types", "mlm_targets_k", "nsp_labels",
            "mask_weight_k", "valid_length", "masked_positions")
    pipe = mx.pipeline.Pipeline(mx.pipeline.IterableSource(
        host_batches())).prefetch_to_device(gpu, 2)
    net = pretrain_net(mx, gpu, dropout=0.1)
    trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 1e-4, "wd": 0.01},
                               whole_step=True)
    kernels.reset_counts()
    mtrainer.reset_trainer_step_stats()
    c0 = _imperative.graph_capture_count()
    seen, losses, step_ms, gains = [], [], [], []
    for _ in range(CORPUS_STEPS):
        before = counts_now()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = next(pipe)
        seen.append({k: v.data.clone() for k, v in b.items()})
        batch = [b[k] for k in keys]
        losses.append(trainer.whole_step(net, own_loss, batch,
                                         batch_size=1).asscalar())
        step_ms.append((time.perf_counter() - t1) * 1e3)
        gains.append(counts_gain(before, counts_now()))
    torch.cuda.synchronize()
    captures = _imperative.graph_capture_count() - c0
    fallbacks = mtrainer.trainer_step_stats()["whole_step_fallbacks"]
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    launches = {k: kernels.KERNEL_COUNTS[k].launches for k in flash}
    plain = sum(c.plain_calls_on_cuda for c in kernels.KERNEL_COUNTS.values())
    leftover = list(pipe)
    same = len(built) == len(seen) == CORPUS_STEPS and all(
        np.array_equal(s[k].cpu().numpy(), h[k])
        and s[k].cpu().numpy().dtype == h[k].dtype
        for s, h in zip(seen, built) for k in h)
    per_step_ok = all(all(g.get(k, {}).get("launches") == 12 for k in flash)
                      for g in gains)
    median = statistics.median(step_ms[2:])
    log(f"text tier bert: corpus of {sum(1 for ln in lines if ln.strip())} "
        f"sentences; WordPiece vocabulary {len(tok)} entries (asked "
        f"{WORDPIECE_VOCAB}) built in {tok_s:.2f} s, in a 30,522-row model; "
        f"{CORPUS_STEPS} captured whole steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"fed by BertPretrainPipeline -> IterableSource -> "
        f"prefetch_to_device(gpu(0), 2): step median {median:.3f} ms over "
        f"steps 3-{CORPUS_STEPS} (steps {[round(v, 3) for v in step_ms]}); "
        f"phase 15's device-resident captured median {captured_ms:.3f} ms in "
        f"this run, on {card}")
    log(f"text tier bert: losses {[round(v, 4) for v in losses]}; graphs "
        f"captured {captures}, whole_step_fallbacks {fallbacks}; every batch "
        f"the stream read equal to its host dict {same}; launches a step "
        f"{gains[-1]}; plain calls on cuda {plain}")
    checks = {"corpus_batches_equal_host": same,
              "corpus_consumed": not leftover,
              "corpus_finite": bool(np.isfinite(losses).all()),
              "corpus_loss_falls": losses[-1] < losses[0],
              "corpus_one_graph": captures == 1,
              "corpus_no_fallback": fallbacks == 0,
              "corpus_launches": per_step_ok,
              "corpus_plain_calls_on_cuda": plain == 0}
    record = {"vocab": len(tok), "median_ms": median,
              "captured_ms": captured_ms, "losses": losses,
              "launches": launches}
    del trainer, net, seen
    torch.cuda.empty_cache()
    return checks, record


def image_text_tier(mx, card, captured):
    """Phase 27 in a temporary directory of the checkout that is removed
    after; returns each path's launches of its kernels."""
    t0 = time.perf_counter()
    tmpdir = tempfile.mkdtemp(prefix="data-smoke-", dir=ROOT)
    try:
        checks, resnet = jpeg_resnet(mx, card, tmpdir, captured["resnet"][1])
        more, bert = corpus_bert(mx, card, tmpdir, captured["bert"][1])
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    checks.update(more)
    log(f"image and text tiers: {json.dumps({'resnet': resnet, 'bert': bert})}"
        f"; phase 27 took {time.perf_counter() - t0:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"image and text tier checks failed: {failed}")
    return {"jpeg_resnet_train": resnet["launches"],
            "corpus_bert_train": bert["launches"]}

# -- phase 28: resilience and telemetry around BERT-base training -------------


def supervised_bert(mx, gpu, mgr, data, record):
    """One supervised job of phase 28: returns the Supervisor's result
    (the final parameters as host copies, the net and the trainer) and
    fills ``record`` (batch log, per-step launches, losses, CUDA-event
    step times, captures an attempt)."""
    import torch

    from mxnet_tpu_torch import _imperative

    sup = mx.resilience.Supervisor(mgr, on_preemption="resume",
                                   max_restarts=4)

    def train(ctx):
        record["captures"].append(_imperative.graph_capture_count())
        net = pretrain_net(mx, gpu, dropout=0.0)
        with mx.autograd.pause():   # complete the deferred shapes
            net(*[mx.nd.array(a[:2], ctx=gpu) for a in data[0]])
        trainer = mx.gluon.Trainer(net.collect_params(), "adamw",
                                   {"learning_rate": 1e-4, "wd": 0.01},
                                   whole_step=True)
        pipe = mx.pipeline.Pipeline(data).prefetch_to_device(gpu, 2)
        start = 0
        if ctx.manager.latest() is not None:
            meta = ctx.manager.restore(params=net, trainer=trainer,
                                       pipeline=pipe)
            start = meta["step"] + 1
        cur = {"step": start - 1}
        ctx.set_preemption_state(lambda: dict(
            step=cur["step"], params=net, trainer=trainer, pipeline=pipe))
        for step, batch in enumerate(pipe, start):
            before = counts_now()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            loss = trainer.whole_step(net, own_loss, list(batch),
                                      batch_size=1)
            e1.record()
            record["losses"][step] = loss.asscalar()
            record["events"].append((step, e0, e1))
            record["gains"].append(counts_gain(before, counts_now()))
            record["batches"][step] = batch[0].asnumpy().tobytes()
            cur["step"] = step
            save = dict(params=net, trainer=trainer, pipeline=pipe,
                        sync=True) if step % RES_SAVE_EVERY == 1 else None
            ctx.step_done(step, save=save)
        params = [p.data().detach().cpu().clone()
                  for p in net.collect_params().values()]
        return params, net, trainer

    out = sup.run(train)
    record["captures"].append(_imperative.graph_capture_count())
    return out


def timed_whole_steps(mx, net, trainer, arrays, gpu, n=10):
    """``n`` captured whole steps of ``net`` on one batch, each timed on
    the host clock with its loss read back (ms)."""
    import torch

    batch = [mx.nd.array(a, ctx=gpu) for a in arrays]
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.whole_step(net, own_loss, batch, batch_size=1).asscalar()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def resilience_telemetry(mx, card, captured_ms):
    """Phase 28 (see the module docstring).  ``captured_ms`` is phase 15's
    captured BERT step median.  Returns the flash kernels' launches by
    path."""
    import gc
    import math
    import signal
    import urllib.request

    import numpy as np
    import torch

    from mxnet_tpu_torch import engine, profiler, resilience, telemetry
    from mxnet_tpu_torch.gluon import trainer as mtrainer
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.resilience import stats as rstats
    from mxnet_tpu_torch.telemetry import flight, health, tracer

    gpu = mx.gpu(0)
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    data = [synthetic_batch(np.random.RandomState(280 + i), TRAIN_BATCH,
                            TRAIN_SEQ, 30522) for i in range(RES_STEPS)]
    checks = {}
    sigterm = signal.getsignal(signal.SIGTERM)
    root = Path(tempfile.mkdtemp(prefix="res-smoke-", dir=ROOT))
    try:
        trace_path = root / "phase28.trace.json"
        telemetry.start_trace(str(trace_path))
        flight.enable(directory=root / "clean")
        monitor = telemetry.HealthMonitor(tick_sec=0).arm()
        server = telemetry.MetricsServer(port=0, host="127.0.0.1").start()
        kernels.reset_counts()
        mtrainer.reset_trainer_step_stats()
        runs, windows, mem = {}, {}, {}
        t_phase = time.perf_counter()
        for label in ("clean", "chaos"):
            rec = {"batches": {}, "losses": {}, "events": [], "gains": [],
                   "captures": []}
            mgr = mx.checkpoint.CheckpointManager(root / label, keep_n=2)
            plan = None
            if label == "chaos":
                flight.enable(directory=root / label)
                rstats.reset_resilience_stats()
                plan = resilience.parse_plan(json.dumps(RES_PLAN))
                resilience.install_plan(plan)
            t0 = time.perf_counter()
            try:
                params, net, trainer = supervised_bert(mx, gpu, mgr, data,
                                                       rec)
            finally:
                if plan is not None:
                    resilience.clear_plan()
            rec["s"] = time.perf_counter() - t0
            rec["fired"] = plan.fired() if plan is not None else []
            rec["resilience"] = dict(profiler.sections()["resilience"])
            windows[label] = monitor.tick()
            torch.cuda.synchronize()
            rec["event_ms"] = [(s, a.elapsed_time(b))
                               for s, a, b in rec["events"]]
            rec["params"] = params
            gc.collect()
            mem[label] = torch.cuda.memory_allocated()
            # one checkpoint buffer set: the manager's device copies of
            # every parameter and state
            rec["buffer_bytes"] = sum(
                t.numel() * t.element_size()
                for t in mgr._snapshot._device.values())
            if label == "clean":
                # the clean run's whole_step scopes, as the monitor read them
                rec["scope_ms"] = list(health._step_ring)
                del net, trainer
            else:
                rec["hooks_noop_after_clear"] = \
                    engine.fault_point is engine._fault_noop
                rec["armed_ms"] = timed_whole_steps(mx, net, trainer,
                                                    data[0], gpu)
            del mgr
            gc.collect()
            torch.cuda.empty_cache()
            runs[label] = rec
        train_counts = {k: kernels.KERNEL_COUNTS[k].launches for k in flash}
        plain = sum(c.plain_calls_on_cuda
                    for c in kernels.KERNEL_COUNTS.values())
        train_s = time.perf_counter() - t_phase
        scrape = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=30).read()
        scrape = scrape.decode()
        healthz = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30).read())

        # a short serving pass under the trace
        kernels.reset_counts()
        BertServing = serving_block(mx)
        mx.random.seed(0)
        bert = mx.models.bert_base(use_decoder=False, use_classifier=False)
        bert.initialize(init=mx.init.Normal(0.02), ctx=gpu)
        spec = mx.serve.BucketSpec(batch_sizes=(1, 4), example_shape=(None,),
                                   lengths=(128,), dtype="int32")
        rng = np.random.RandomState(28)
        reqs = [rng.randint(1, 30522, size=int(n)).astype(np.int32)
                for n in rng.randint(16, 129, size=RES_SERVE_REQUESTS)]
        srv = mx.serve.ModelServer(BertServing(bert), spec, ctx=gpu).start()
        futs = [srv.submit(r) for r in reqs]
        answers = [f.result(120) for f in futs]
        serve_scrape = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=30).read()
        serve_scrape = serve_scrape.decode()
        srv.shutdown()
        serve_counts = {k: kernels.KERNEL_COUNTS[k].launches for k in flash}
        plain += sum(c.plain_calls_on_cuda
                     for c in kernels.KERNEL_COUNTS.values())
        del srv, bert
        torch.cuda.empty_cache()

        telemetry.stop_trace()
        flight.disable()
        monitor.disarm()
        server.stop()
        # every hook disarmed: the same steps again
        kernels.reset_counts()
        disarmed_ms = timed_whole_steps(mx, net, trainer, data[0], gpu)
        disarmed_counts = {k: kernels.KERNEL_COUNTS[k].launches
                           for k in flash}
        del net, trainer
        torch.cuda.empty_cache()
        events = json.loads(trace_path.read_text())["traceEvents"]
        dumps = sorted((root / "chaos").glob("flight-*.json"))
        reasons = [json.loads(f.read_text())["reason"] for f in dumps]
    finally:
        shutil.rmtree(root, ignore_errors=True)

    clean, chaos = runs["clean"], runs["chaos"]
    want_fired = sorted([("engine.h2d", "delay")] * 2 + [
        ("train.step", "kill"), ("checkpoint.commit", "truncate"),
        ("train.step", "raise")])
    got_fired = sorted((f["site"], f["action"]) for f in chaos["fired"])
    res = chaos["resilience"]
    attempts = {lbl: [b - a for a, b in zip(r["captures"], r["captures"][1:])]
                for lbl, r in runs.items()}
    per_step_ok = all(all(g.get(k, {}).get("launches") == 12 for k in flash)
                      for r in runs.values() for g in r["gains"])
    whole = [e for e in events if e.get("ph") == "X"
             and e.get("name") == "whole_step" and e.get("cat") == "trainer"]
    saves = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("checkpoint.save.")]
    retries = [e for e in events if e.get("ph") == "i"
               and e.get("name") == "resilience.retry"]
    req_b = [e for e in events if e.get("ph") == "b"
             and e.get("name") == "serve.request"]
    req_e = [e for e in events if e.get("ph") == "e"
             and e.get("name") == "serve.request"]
    w_clean, w_chaos = windows["clean"], windows["chaos"]
    peak = monitor.peak_flops
    want_peak = next((v for k, v in health._PEAK_FLOPS_TABLE
                      if k in torch.cuda.get_device_name(0).lower()), None)
    clean_ev = [ms for s, ms in clean["event_ms"]][2:]
    for k in flash:
        train_counts[k] += disarmed_counts[k]
    mem_gap = mem["chaos"] - mem["clean"]
    checks.update({
        "res_fired_exactly_the_plan": got_fired == want_fired,
        "res_restarts": res["restarts"] == 2,
        "res_retries": res["retries"] == {"preemption": 1, "transient": 1},
        "res_fallback_restores": res["fallback_restores"] == 1,
        "res_time_lost": res["time_lost_ms"] > 0,
        "res_params_bit_identical": len(clean["params"])
        == len(chaos["params"]) and all(
            torch.equal(a, b) for a, b in zip(clean["params"],
                                              chaos["params"])),
        "res_batch_log_bit_identical": clean["batches"] == chaos["batches"]
        and len(clean["batches"]) == RES_STEPS,
        "res_launches_every_step": per_step_ok,
        "res_one_capture_an_attempt": attempts["clean"] == [1]
        and attempts["chaos"] == [1] * (res["restarts"] + 1),
        "res_no_fallback":
            mtrainer.trainer_step_stats()["whole_step_fallbacks"] == 0,
        "res_plain_calls_on_cuda": plain == 0,
        "res_trace_scopes": bool(whole) and bool(saves)
        and len(retries) == 2,
        "res_flight_dump_sigterm": "sigterm" in reasons,
        "res_metrics_resilience": "mxtpu_resilience_restarts 2" in scrape,
        "res_metrics_health": "mxtpu_health_goodput" in scrape
        and "mxtpu_health_steps" in scrape,
        "res_healthz": healthz.get("status") in ("ok", "degraded"),
        "res_goodput_below_one": w_chaos["goodput"] is not None
        and w_chaos["goodput"] < 1,
        "res_mfu": w_chaos["mfu"] is not None
        and math.isfinite(w_chaos["mfu"]) and w_chaos["mfu"] > 0,
        "res_h100_peak": want_peak is not None and peak == want_peak,
        "res_memory_after_restarts": mem_gap <= chaos["buffer_bytes"],
        "res_sigterm_handler_restored":
            signal.getsignal(signal.SIGTERM) == sigterm,
        "res_hooks_noop": chaos["hooks_noop_after_clear"]
        and tracer.span_begin is tracer._noop
        and health.scope_end is health._noop
        and engine.fault_point is engine._fault_noop,
        "res_serve_spans": len(req_b) == len(req_e) == RES_SERVE_REQUESTS,
        "res_serve_answers": len(answers) == RES_SERVE_REQUESTS and all(
            np.isfinite(a[0]).all() for a in answers),
        "res_serve_metrics": f"mxtpu_serve_served{{server=" in serve_scrape
        and any(ln.startswith("mxtpu_serve_served{")
                and ln.endswith(f" {RES_SERVE_REQUESTS}")
                for ln in serve_scrape.splitlines()),
    })
    log(f"resilience: BERT-base MLM+NSP fp32 dropout 0 AdamW, {RES_STEPS} "
        f"captured whole steps of {TRAIN_BATCH} x {TRAIN_SEQ} from a "
        f"pipeline, saved every {RES_SAVE_EVERY} (keep_n=2, sync), under "
        f"Supervisor(on_preemption='resume'): clean {clean['s']:.1f} s, "
        f"chaos {chaos['s']:.1f} s (phase {train_s:.1f} s with the disarmed "
        f"steps); fired {chaos['fired']}; resilience section {res}; "
        f"captures an attempt {attempts}; chaos parameters and batch log "
        f"bit-identical to the clean run's: "
        f"{checks['res_params_bit_identical']}, "
        f"{checks['res_batch_log_bit_identical']}; losses clean "
        f"{[round(clean['losses'][k], 4) for k in sorted(clean['losses'])]}"
        f"; on {card}")
    log(f"resilience: health windows (host scopes) clean {w_clean}; chaos "
        f"{w_chaos}; peak {peak:.4g} FLOP/s (datasheet, "
        f"{torch.cuda.get_device_name(0)})")
    log(f"resilience: the clean run's step by the health monitor (mean of "
        f"its whole_step scopes, host) {w_clean['step_ms_mean']:.3f} ms, p95 "
        f"{w_clean['step_p95_ms']:.3f} ms (every step); median over steps "
        f"3-{RES_STEPS}: scopes {statistics.median(clean['scope_ms'][2:]):.3f}"
        f" ms, CUDA events around the same calls "
        f"{statistics.median(clean_ev):.3f} ms (scopes "
        f"{[round(ms, 3) for ms in clean['scope_ms']]}; events "
        f"{[round(ms, 3) for s, ms in clean['event_ms']]}); step median "
        f"with a loss read a step (host clock, steps 3-10 of 10): armed "
        f"{statistics.median(chaos['armed_ms'][2:]):.3f} ms, disarmed "
        f"{statistics.median(disarmed_ms[2:]):.3f} ms (phase 15's captured "
        f"BERT {captured_ms:.3f} ms, dropout 0.1); on {card}")
    log(f"resilience: device memory after the clean run {mem['clean']} "
        f"bytes, after the chaos run {mem['chaos']} (gap {mem_gap}, one "
        f"checkpoint buffer set {chaos['buffer_bytes']}); trace "
        f"{len(events)} events, {len(whole)} whole_step scopes, "
        f"{len(saves)} checkpoint.save.* scopes, {len(retries)} retry "
        f"instants, {len(req_b)} serve.request spans; flight dumps "
        f"{reasons}; /healthz {healthz}; launches train {train_counts}, "
        f"serve {serve_counts}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"resilience and telemetry checks failed: {failed}")
    return {"resilience_bert_train": train_counts,
            "resilience_bert_serve": serve_counts}



# -- phase 29: int8 BERT-base serving -----------------------------------------


def int8_bert_block(mx):
    import torch

    class BertLogits(mx.gluon.HybridBlock):
        """Token ids (B, S) -> (MLM logits, NSP logits); id 0 pads."""

        def __init__(self, bert, **kwargs):
            super().__init__(**kwargs)
            self.bert = bert

        def hybrid_forward(self, F, ids):
            valid = (ids != 0).sum(dim=1).to(torch.float32)
            return self.bert(ids, torch.zeros_like(ids), valid)

    return BertLogits


def host_params(net):
    return {k: p.data().detach().cpu().numpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


def int_mm_times():
    """The int8 products of int8 BERT-base at b=8, s=512 and of a decode
    step (``torch._int_mm`` through ``int8_matmul``'s padding rule, a
    library call: the JAX package computes them outside Pallas too), each
    exact against a float64 product and timed beside the float32
    ``torch.matmul`` of the same shape, by CUDA events."""
    import torch

    from mxnet_tpu_torch.ops import quantization as q

    gen = torch.Generator(device="cuda").manual_seed(29)
    out = {}
    for name, (m, k, n) in (("ffn1", (4096, 768, 3072)),
                            ("ffn2", (4096, 3072, 768)),
                            ("mlm_decoder", (4096, 768, 30522)),
                            ("pooler_b8", (8, 768, 768)),
                            ("decode_proj_16_slots", (16, DEC_EMBED,
                                                      DEC_VOCAB))):
        x8 = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                           device="cuda", generator=gen)
        w8 = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                           device="cuda", generator=gen)
        xf, wf = x8.float(), w8.float()
        exact = torch.equal(q.int8_matmul(x8, w8).double(),
                            x8.double() @ w8.double().t())
        out[name] = {"mkn": [m, k, n], "padded_to": list(q.int_mm_shape(
            m, k, n)), "exact": exact,
            "int8_ms": cuda_ms(lambda: q.int8_matmul(x8, w8), iters=20),
            "fp32_ms": cuda_ms(lambda: torch.matmul(xf, wf.t()), iters=20)}
        del x8, w8, xf, wf
    torch.cuda.empty_cache()
    return out


def int8_bert_serving(mx, card, tmpdir):
    """Phase 29 (see the module docstring).  Returns the flash forward's
    launches over the served and warm-up batches and the server's traffic
    histograms (phase 31 derives a bucket grid from them)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _imperative
    from mxnet_tpu_torch.contrib import quantization as qz
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops import quantization as q
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    gpu, cpu = mx.gpu(0), mx.cpu()
    BertLogits = int8_bert_block(mx)
    mx.random.seed(0)
    bert = mx.models.bert_base(vocab_size=30522)
    bert.initialize(init=mx.init.Normal(0.02), ctx=gpu)
    net = BertLogits(bert)
    net(mx.nd.array(np.ones((1, 8), np.int32), ctx=gpu))   # shapes
    fp32_host = host_params(net)   # for the CPU's float32 reference
    rng = np.random.RandomState(29)
    # ids from 1: every calibration row is full length
    calib = [rng.randint(1, 30522, size=INT8_CALIB_SHAPE).astype(np.int32)
             for _ in range(INT8_CALIB_BATCHES)]
    qz.reset_quantize_stats()
    t0 = time.perf_counter()
    with gpu:
        # the served block is the one quantize_net marks int8, so the
        # server books its batches and reloads by re-quantizing
        qz.quantize_net(net, calib_data=calib, calib_mode="naive")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    wrapped = [p[:-1] for p, _ in qz._iter_quantized(net)]
    qstats = qz.quantize_stats()
    spec = mx.serve.BucketSpec(batch_sizes=(1, 4, 8), example_shape=(None,),
                               lengths=(128, 256, 512), dtype="int32")
    batches = []   # (the requests' examples, the padded batch) per batch
    pad = spec.pad_batch

    def recording_pad(examples, batch, length):
        padded = pad(examples, batch, length)
        batches.append((list(examples), padded))
        return padded

    spec.pad_batch = recording_pad
    reqs = [rng.randint(1, 30522, size=int(n)).astype(np.int32)
            for n in rng.randint(16, 513, size=INT8_SERVE_REQUESTS)]
    # a float32 training checkpoint of other weights, for the reload
    mx.random.seed(1)
    other = mx.models.bert_base(vocab_size=30522)
    other.initialize(init=mx.init.Normal(0.02), ctx=gpu)
    other = BertLogits(other)
    x8 = mx.nd.array(pad([r[:512] for r in reqs[:8]], 8, 512), ctx=gpu)
    # the float32 model with both heads at the largest bucket, eager and
    # replayed (a hybridized call: warm-up, capture, then replays)
    fp32_ms = cuda_ms(lambda: other(x8), iters=3)
    other.hybridize()
    fp32_replay_ms = cuda_ms(lambda: other(x8), iters=5)
    other.hybridize(False)
    mgr = mx.checkpoint.CheckpointManager(os.path.join(tmpdir, "ckpt"))
    t0 = time.perf_counter()
    mgr.save(1, params=other, sync=True)
    save_s = time.perf_counter() - t0
    del other
    torch.cuda.empty_cache()
    server = mx.serve.ModelServer(net, spec, ctx=gpu, checkpoint=mgr)
    results = [None] * INT8_SERVE_REQUESTS

    kernels.reset_counts()
    q.reset_int_mm_counts()
    c0 = _imperative.graph_capture_count()
    r0 = _imperative.graph_replay_count()
    t0 = time.perf_counter()
    server.start()
    t_warm = time.perf_counter() - t0
    captured = _imperative.graph_capture_count() - c0

    def client(idx):
        futs = [(i, server.submit(reqs[i])) for i in idx]
        for i, f in futs:
            results[i] = f.result(timeout=300)

    threads = [threading.Thread(target=client, args=(
        range(c, INT8_SERVE_REQUESTS, SERVE_THREADS),))
        for c in range(SERVE_THREADS)]
    t1 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t1
    launches = fa.counts.launches
    plain_on_cuda = sum(c.plain_calls_on_cuda
                        for c in kernels.KERNEL_COUNTS.values())
    replays = _imperative.graph_replay_count() - r0
    mm_counts = dict(q.int_mm_counts)
    if any(t.is_alive() for t in threads):
        server.shutdown(drain=False, timeout=120)
        raise SystemExit("int8 serve: client threads did not finish")
    st = server.stats()
    n_buckets = st["warmup_batches"]
    n_forwards = st["batches"] + 2 * n_buckets
    int8_batches = qz.quantize_stats()["int8_serve_batches"]
    checks = {
        "int8_layers": len(wrapped) == 28
        and not any("attn" in w for w in wrapped)
        and qstats["layers_quantized"] == 28
        and qstats["calib_batches"] == INT8_CALIB_BATCHES,
        "int8_served": st["served"] == INT8_SERVE_REQUESTS
        and st["failed"] == 0,
        "int8_post_warmup_compiles": st["graph"]["post_warmup_compiles"]
        == 0,
        "int8_graphs_captured": captured == n_buckets == 9,
        "int8_replay_a_batch": replays == st["batches"] + n_buckets,
        "int8_flash_launches": launches == 12 * n_forwards > 0,
        "int8_plain_calls_on_cuda": plain_on_cuda == 0,
        "int8_batches_booked": int8_batches == st["batches"],
        "int8_shapes": all(
            mlm.shape == (len(r), 30522) and nsp.shape == (2,)
            and np.isfinite(mlm).all() and np.isfinite(nsp).all()
            for r, (mlm, nsp) in zip(reqs, results)),
    }
    log(f"int8 serve: BERT-base (30522 words) quantize_net naive over "
        f"{INT8_CALIB_BATCHES} x {INT8_CALIB_SHAPE} in {quant_s:.2f} s: "
        f"{len(wrapped)} int8 layers (24 FFN Dense, pooler, MLM transform "
        f"and decoder, NSP; attention projections float32); warm-up "
        f"{n_buckets} buckets in {t_warm:.2f} s; "
        f"{st['served']}/{INT8_SERVE_REQUESTS} served in {st['batches']} "
        f"batches, {wall:.3f} s wall, {INT8_SERVE_REQUESTS / wall:.2f} req/s"
        f"; latency p50 {st['latency']['p50_ms']} ms p99 "
        f"{st['latency']['p99_ms']} ms; bucket hits {st['bucket_hits']}; "
        f"graph {st['graph']}; CUDA graphs captured {captured}, replays "
        f"{replays}; flash launches {launches} (12 x {n_forwards} forwards)"
        f"; int8 products called eagerly or at capture {mm_counts}; "
        f"quantize section {qz.quantize_stats()}; on {card}")

    # the CPU on the same weights: float32, then int8 with the card's
    # quantized weights and ranges
    t0 = time.perf_counter()
    cbert = mx.models.bert_base(vocab_size=30522)
    cbert.initialize(ctx=cpu)
    cnet = BertLogits(cbert)
    with cpu:
        cnet(mx.nd.array(np.ones((1, 8), np.int32)))   # deferred shapes
    mx.load_numpy_params(cnet, fp32_host)
    del fp32_host
    order = sorted(range(INT8_SERVE_REQUESTS), key=lambda i: len(reqs[i]))
    picks = order[:INT8_CPU_REQUESTS]

    def cpu_logits():
        return {i: [o.asnumpy()[0] for o in cnet(
            mx.nd.array(reqs[i][None], ctx=cpu))] for i in picks}

    fp32_out = cpu_logits()
    with cpu:
        qz.quantize_net(cnet)   # ranges come with the card's arrays
    mx.load_numpy_params(cnet, host_params(net))
    int8_out = cpu_logits()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    ends = []   # (card vs CPU int8, CPU int8 vs float32, card vs float32)
    agree = []
    for i in picks:
        for k in (0, 1):   # MLM, NSP
            ends.append((rel(results[i][k], int8_out[i][k]),
                         rel(int8_out[i][k], fp32_out[i][k]),
                         rel(results[i][k], fp32_out[i][k])))
        agree.append(float((results[i][0].argmax(-1)
                            == int8_out[i][0].argmax(-1)).mean()))
    # layer by layer: the same input through the card's and the CPU's
    # quantized layer
    layers = dict(qz._iter_quantized(net))
    clayers = dict(qz._iter_quantized(cnet))
    flips = {}
    last = max(int(p.split(".")[3]) for p in layers
               if p.startswith("bert.encoder.layers."))
    for path in ("bert.encoder.layers.0.ffn1.",
                 f"bert.encoder.layers.{last}.ffn2.", "bert.pooler.",
                 "bert.mlm_transform.", "bert.mlm_decoder.",
                 "bert.nsp_classifier."):
        lg, lc = layers[path], clayers[path]
        k_in = lg.qweight.shape[1]
        x = (rng.randn(INT8_LAYER_ROWS, k_in)
             * float(lg.in_max.data()) / 3).astype(np.float32)
        yg = lg(torch.from_numpy(x).to(lg.qweight.data().device)) \
            .cpu().numpy()
        yc = lc(torch.from_numpy(x)).detach().numpy()
        if lg._activation is None:    # requantized: output levels
            quantum = max(abs(float(lg.out_min.data())),
                          abs(float(lg.out_max.data()))) / 127.0
            diff = np.abs(yg - yc) / quantum
            flips[path[5:-1]] = (float((diff > 0.5).mean()),
                                 float(diff.max()))
        else:                           # dequantized, then the activation
            flips[path[5:-1]] = (0.0, float(np.abs(yg - yc).max()))
    cpu_s = time.perf_counter() - t0
    del cnet, cbert
    checks["int8_card_vs_cpu_logits"] = all(
        c <= INT8_NOISE_FACTOR * e for c, e, _ in ends)
    checks["int8_card_vs_cpu_layers"] = all(
        f <= INT8_LAYER_FLIPS and d <= 1.01 for f, d in flips.values())
    log(f"int8 serve: card vs the CPU over the {INT8_CPU_REQUESTS} shortest "
        f"requests (lengths {[len(reqs[i]) for i in picks]}), MLM then NSP "
        f"each, |a - b| / |b| of (card int8, CPU int8), (CPU int8, CPU "
        f"float32), (card int8, CPU float32): {ends} (card vs CPU within "
        f"{INT8_NOISE_FACTOR} x int8's error); MLM argmax agreement card vs "
        f"CPU int8 {agree}; layer by layer on {INT8_LAYER_ROWS} rows, "
        f"(share of elements a level apart, largest difference in output "
        f"quanta; for the tanh pooler the largest absolute difference): "
        f"{flips} (limits {INT8_LAYER_FLIPS}, 1 quantum); {cpu_s:.1f} s")

    # the int8 products beside float32 ones, and the replayed forwards
    mm = int_mm_times()
    checks["int8_products_exact"] = all(v["exact"] for v in mm.values())
    log(f"int8 serve: torch._int_mm through int8_matmul vs float32 "
        f"torch.matmul (TF32 off), ms by CUDA events on {card}: "
        + "; ".join(f"{k} {v['mkn']} (padded to {v['padded_to']}): int8 "
                    f"{v['int8_ms']:.4f}, fp32 {v['fp32_ms']:.4f}, exact "
                    f"{v['exact']}" for k, v in mm.items()))
    times = {}
    for b, n in ((1, 128), (8, 512)):
        x = mx.nd.array(pad([r[:n] for r in reqs[:b]], b, n), ctx=gpu)
        times[spec.key(b, n)] = cuda_ms(lambda: net(x), iters=5)
    eager_int8 = BertLogits(bert)   # not hybridized
    eager_ms = cuda_ms(lambda: eager_int8(x8), iters=3)
    del eager_int8
    log(f"int8 serve: replayed forward (input in, replay, outputs copied) "
        f"ms by bucket {times}; b8xl512 eager int8 {eager_ms:.3f} ms, the "
        f"float32 model eager {fp32_ms:.3f} ms, replayed "
        f"{fp32_replay_ms:.3f} ms (both heads, MLM logits at every "
        f"position) on {card}")

    # a float32 checkpoint of other weights reloaded under the server:
    # re-quantized against the stored scales, no new capture
    c1 = _imperative.graph_capture_count()
    t0 = time.perf_counter()
    info = server.reload_weights()
    reload_s = time.perf_counter() - t0
    first = len(batches)
    later = reqs[:4]
    fresh = [server.predict(r, timeout=300) for r in later]
    server.shutdown(drain=True, timeout=120)
    st2 = server.stats()
    eager_net = BertLogits(bert)   # not hybridized: the eager forward
    same = len(batches) - first == len(later)
    for examples, padded in batches[first:]:
        mlm, nsp = (o.data.cpu().numpy() for o in eager_net(
            mx.nd.array(padded, ctx=gpu)))
        for row, ex in enumerate(examples):
            got = fresh[[id(r) for r in later].index(id(ex))]
            same &= (np.array_equal(got[0], mlm[row, :len(ex)])
                     and np.array_equal(got[1], nsp[row]))
    changed = all(not np.array_equal(f[0], r[0])
                  for f, r in zip(fresh, results[:4]))
    checks["int8_reload_no_new_capture"] = (
        info["step"] == 1 and st2["reloads"] == 1 and same and changed
        and _imperative.graph_capture_count() == c1
        and st2["graph"]["post_warmup_compiles"] == 0)
    log(f"int8 serve: reload_weights() of a float32 checkpoint of other "
        f"weights (saved in {save_s:.2f} s) re-quantized in {reload_s:.2f} "
        f"s under the running server; the next {len(later)} responses "
        f"bit-identical to the eager int8 forward of their padded batches: "
        f"{same}; differ from before: {changed}; new captures "
        f"{_imperative.graph_capture_count() - c1}; phase 29 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del server, net, eager_net, bert
    torch.cuda.empty_cache()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"int8 serve checks failed: {failed}")
    return {"launches": launches,
            "traffic": {"request_lengths": st["request_lengths"],
                        "group_sizes": st["group_sizes"]},
            "lengths": spec.lengths}


# -- phase 30: decode ---------------------------------------------------------


def decode_traffic():
    """bench.py serve_decode's prompts and heavy-tailed budgets (seed 0)."""
    import numpy as np

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, DEC_VOCAB, size=int(rng.randint(2, 17)))
               .astype(np.int32) for _ in range(DEC_REQUESTS)]
    budgets = [int(rng.randint(48, 73)) if rng.rand() < 0.25
               else int(rng.randint(4, 13)) for _ in range(DEC_REQUESTS)]
    return prompts, budgets


def decode_model(mx, ctx, proj_block=False):
    mx.random.seed(0)
    model = mx.serve.TinyDecoder(vocab=DEC_VOCAB, embed=DEC_EMBED,
                                 proj_block=proj_block)
    model.initialize(mx.init.Xavier(), ctx=ctx)
    return model


def decode_run(mx, model, ctx, prompts, budgets, passes=1, **kw):
    """The requests through a DecodeServer of ``model`` on ``ctx``,
    ``passes`` times over: submitted a few at a time, as bench.py does.
    Returns the last pass's sequences and the run's record (tokens/s of
    wall time, replays and captures after the warm-up, the sampled peak of
    live slots)."""
    from mxnet_tpu_torch import _imperative

    spec = mx.serve.BucketSpec(batch_sizes=DEC_BATCHES,
                               example_shape=(None,), lengths=DEC_LENGTHS,
                               dtype="int32")
    srv = mx.serve.DecodeServer(model, spec, max_slots=DEC_SLOTS,
                                max_len=DEC_MAX_LEN,
                                max_queue=len(prompts) + 8, ctx=ctx, **kw)
    t0 = time.perf_counter()
    srv.start()
    warm_s = time.perf_counter() - t0
    c0 = _imperative.graph_capture_count()
    r0 = _imperative.graph_replay_count()
    peak, stop = [0], threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], srv.live_slots())
            time.sleep(0.001)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t1 = time.perf_counter()
    for _ in range(passes):
        handles = []
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            handles.append(srv.submit(p, max_new_tokens=m))
            if i % 4 == 0:
                time.sleep(0.0005)
        seqs = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t1
    stop.set()
    sampler.join(timeout=5)
    srv.drain()
    s = srv.stats()
    rec = {"tokens_per_s": s["tokens"] / wall, "wall_s": wall,
           "warmup_s": warm_s, "tokens": s["tokens"],
           "served": s["served"] // passes,
           "decode_steps": s["decode_steps"],
           "spec_draft_steps": s["spec_draft_steps"],
           "batches": s["batches"],
           "replays": _imperative.graph_replay_count() - r0,
           "captures": _imperative.graph_capture_count() - c0,
           "post_warmup_compiles": s["graph"]["post_warmup_compiles"],
           "signatures": s["graph"]["compiles"],
           "peak_live_slots": peak[0],
           "slot_occupancy": s["slots"]["occupancy"],
           "token_p50_ms": s["token_latency"]["p50_ms"],
           "ttft_p50_ms": s["ttft"]["p50_ms"],
           "accept_rate": (s.get("spec") or {}).get("accept_rate"),
           "pages": s.get("pages")}
    return seqs, rec


def decision_gap(model, prompt, seq, j):
    """The gap between the top two logits of ``model`` (on the CPU) at
    the decision that emitted ``seq[j]``."""
    import torch

    with torch.no_grad():
        toks = torch.as_tensor(list(prompt) + list(seq[:j]),
                               dtype=torch.int32)
        h = model._embed(toks).mean(dim=0, keepdim=True)
        top = torch.topk(model._logits(h)[0].double(), 2).values
    return float(top[0] - top[1])


def token_diffs(model, prompts, got, want):
    """Card-vs-CPU divergences: ``(request, token, gap)`` at each
    sequence's first differing token, ``gap`` that decision's top-two
    logit gap on the CPU model."""
    import numpy as np

    out = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        if np.array_equal(a, b):
            continue
        if len(a) != len(b):
            out.append((i, min(len(a), len(b)), float("inf")))
            continue
        j = int(np.flatnonzero(a != b)[0])
        out.append((i, j, decision_gap(model, p, b, j)))
    return out


def decode_arms(mx, card):
    """Phase 30 (see the module docstring).  Returns the float32 model and
    the traffic (phase 31 tunes over them)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.contrib import quantization as qz

    t_phase = time.perf_counter()
    gpu, cpu = mx.gpu(0), mx.cpu()
    prompts, budgets = decode_traffic()
    model = decode_model(mx, gpu)
    qmodel = decode_model(mx, gpu, proj_block=True)
    calib = np.random.RandomState(30).randint(
        0, DEC_VOCAB, size=(32, 16)).astype(np.int32)

    def calib_forward(m, x):
        b, n = x.shape
        m.prefill(x.data, torch.full((b,), n, dtype=torch.int32,
                                     device=x.data.device))

    with gpu:
        qz.quantize_net(qmodel, calib_data=[calib[:16], calib[16:]],
                        calib_forward=calib_forward)
    runs = {}
    seqs = {}
    seqs["whole_batch"], runs["whole_batch"] = decode_run(
        mx, model, gpu, prompts, budgets, admission="batch")
    seqs["continuous"], runs["continuous"] = decode_run(
        mx, model, gpu, prompts, budgets)
    # the paged arena at half the contiguous arena's cache memory, with
    # speculation (bench.py's paged arm)
    num_pages = DEC_SLOTS * DEC_MAX_LEN // 2 // DEC_PAGE_TOKENS
    seqs["paged_spec"], runs["paged_spec"] = decode_run(
        mx, model, gpu, prompts, budgets, page_tokens=DEC_PAGE_TOKENS,
        num_pages=num_pages, draft=mx.serve.TinyDraft(model),
        spec_k=DEC_SPEC_K)
    qz.reset_quantize_stats()
    seqs["int8"], runs["int8"] = decode_run(mx, qmodel, gpu, prompts,
                                            budgets)
    int8_booked = qz.quantize_stats()["int8_serve_batches"]

    # the same weights on the CPU
    t0 = time.perf_counter()
    cmodel = decode_model(mx, cpu)
    mx.load_numpy_params(cmodel, host_params(model))
    cq = decode_model(mx, cpu, proj_block=True)
    with cpu:
        qz.quantize_net(cq)    # ranges come with the card's arrays
    mx.load_numpy_params(cq, host_params(qmodel))
    cpu_seqs, cpu_run = decode_run(mx, cmodel, cpu, prompts, budgets)
    cpu_int8, cpu_int8_run = decode_run(mx, cq, cpu, prompts, budgets)
    cpu_s = time.perf_counter() - t0
    diffs = {arm: token_diffs(cq if arm == "int8" else cmodel, prompts,
                              seqs[arm],
                              cpu_int8 if arm == "int8" else cpu_seqs)
             for arm in seqs}
    level = max(abs(float(cq.proj.out_min.data())),
                abs(float(cq.proj.out_max.data()))) / 127.0
    ties = {arm: [d for d in v if d[2] < (1.001 * level if arm == "int8"
                                          else DEC_TIE_GAP)]
            for arm, v in diffs.items()}

    checks = {}
    for arm, r in runs.items():
        checks[f"decode_{arm}_served"] = r["served"] == DEC_REQUESTS
        checks[f"decode_{arm}_post_warmup_compiles"] = \
            r["post_warmup_compiles"] == 0 and r["captures"] == 0
        checks[f"decode_{arm}_one_replay_a_step"] = r["replays"] == (
            r["decode_steps"] + r["spec_draft_steps"] + r["batches"])
        checks[f"decode_{arm}_vs_cpu"] = len(diffs[arm]) == len(ties[arm])
    checks["decode_continuous_equals_whole_batch"] = all(
        np.array_equal(a, b) for a, b in zip(seqs["continuous"],
                                             seqs["whole_batch"]))
    checks["decode_speculative_equals_greedy"] = all(
        np.array_equal(a, b) for a, b in zip(seqs["paged_spec"],
                                             seqs["continuous"]))
    checks["decode_int8_booked"] = int8_booked == (
        runs["int8"]["decode_steps"] + runs["int8"]["batches"])
    checks["decode_budgets"] = all(
        len(s) == m for s, m in zip(seqs["continuous"], budgets))
    contig_seqs = DEC_SLOTS * DEC_MAX_LEN // 2 // DEC_MAX_LEN
    for arm, r in runs.items():
        log(f"decode {arm}: {r['tokens']} tokens in {r['wall_s']:.3f} s = "
            f"{r['tokens_per_s']:.1f} tokens/s (wall); warm-up "
            f"{r['warmup_s']:.2f} s ({r['signatures']} signatures); "
            f"{r['decode_steps']} steps, {r['spec_draft_steps']} draft "
            f"steps, {r['batches']} admission groups, {r['replays']} "
            f"replays, {r['captures']} captures after warm-up; occupancy "
            f"{r['slot_occupancy']}, peak live slots {r['peak_live_slots']}"
            f"; token p50 {r['token_p50_ms']} ms, TTFT p50 "
            f"{r['ttft_p50_ms']} ms; accept rate {r['accept_rate']}; "
            f"pages {r['pages']}; on {card}")
    log(f"decode: bench.py serve_decode's configuration (TinyDecoder("
        f"{DEC_VOCAB}, {DEC_EMBED}), {DEC_REQUESTS} requests, {DEC_SLOTS} "
        f"slots, max_len {DEC_MAX_LEN}); the paged arm holds {num_pages} "
        f"pages of {DEC_PAGE_TOKENS} tokens (half the contiguous arena's "
        f"cache, where a contiguous arena fits {contig_seqs} sequences) and "
        f"peaked at {runs['paged_spec']['peak_live_slots']} live slots; "
        f"continuous == whole-batch: "
        f"{checks['decode_continuous_equals_whole_batch']}; speculative == "
        f"greedy: {checks['decode_speculative_equals_greedy']}; card vs the "
        f"CPU run (float32 {cpu_run['tokens']} tokens, int8 "
        f"{cpu_int8_run['tokens']}; {cpu_s:.1f} s): divergences {diffs}, "
        f"of which ties (top-two gap < {DEC_TIE_GAP}, int8: one level, "
        f"{level:.6g}) {ties}; int8 steps "
        f"and groups booked {int8_booked}; phase 30 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del qmodel, cq, cmodel
    torch.cuda.empty_cache()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"decode checks failed: {failed}")
    return model, prompts, budgets, runs


# -- phase 31: the tuner ------------------------------------------------------


def tuner_run(mx, card, traffic, served_lengths, model, prompts, budgets):
    """Phase 31 (see the module docstring)."""
    import numpy as np

    from mxnet_tpu_torch import tune
    from mxnet_tpu_torch.base import getenv, setenv

    t_phase = time.perf_counter()
    gpu = mx.gpu(0)
    derived = tune.derive_bucket_spec(traffic, (None,), max_buckets=3,
                                      align=8, max_batch=8)
    hist = traffic["request_lengths"]
    over_served = tune.padding_overhead(served_lengths, hist)
    over_derived = tune.padding_overhead(derived.lengths, hist)
    log(f"tune: phase 29's traffic ({sum(hist.values())} requests, group "
        f"sizes {traffic['group_sizes']}) -> derive_bucket_spec "
        f"{tune.format_grid(derived.batch_sizes, derived.lengths)}; padding "
        f"overhead {over_derived:.4f} against the served grid's "
        f"{over_served:.4f} ({served_lengths})")

    shipped = tune.default_registry()
    reg = tune.KnobRegistry()
    # the draft needs the paged arena: the page sizes of the knob's domain
    # that page a slot (0, contiguous, leaves speculation off)
    for name, domain, default in (
            ("decode_page_tokens", (8, 16, 32), DEC_PAGE_TOKENS),
            ("decode_spec_k", (1, 2, 4), DEC_SPEC_K)):
        k = shipped.get(name)
        reg.register(tune.Knob(name, env=k.env, kind=k.kind, domain=domain,
                               default=default, restart=k.restart,
                               doc=k.doc))
    saved = {k.env: getenv(k.env) for k in reg}

    def measure(config):
        # the server reads the knobs from the environment, as a fresh
        # deployment would
        spec_k = getenv("DECODE_SPEC_K", 1, int)
        _, r = decode_run(mx, model, gpu, prompts, budgets,
                          passes=TUNE_PASSES,
                          draft=mx.serve.TinyDraft(model)
                          if spec_k > 1 else None)
        if r["served"] != DEC_REQUESTS or r["captures"]:
            raise SystemExit(f"tune: a trial served {r['served']} of "
                             f"{DEC_REQUESTS}, captured {r['captures']}")
        return {"tokens_per_s": r["tokens_per_s"],
                "decode_steps": r["decode_steps"],
                "replays": r["replays"]}

    d = tempfile.mkdtemp(prefix="tune-smoke-", dir=ROOT)
    try:
        reg.apply({"decode_page_tokens": DEC_PAGE_TOKENS,
                   "decode_spec_k": DEC_SPEC_K})
        runner = tune.TrialRunner(reg, measure, seed=0,
                                  history=os.path.join(d, "trials.jsonl"))
        rec = tune.Tuner(reg, runner=runner, seed=0, top_k=2,
                         reference_configs={}).recommend()
        with open(os.path.join(d, "trials.jsonl")) as f:
            lines = f.read().splitlines()
    finally:
        shutil.rmtree(d, ignore_errors=True)
        for env, v in saved.items():
            setenv(env, v)
    for line in lines:
        log(f"tune trial: {line}")
    log(rec.summary())
    log(f"tune: {len(rec.trials)} trials scored by tokens/s of wall time "
        f"over {TUNE_PASSES} passes of {DEC_REQUESTS} requests each "
        f"(recompiles are the new "
        f"signatures each trial's server warmed); recommended "
        f"{rec.config}, best/baseline {rec.ratio:.4f}; tune section "
        f"{tune.tune_stats()}; phase 31 took "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    checks = {"tune_trials": 1 < len(rec.trials) <= TUNE_MAX_TRIALS
              and len(lines) == len(rec.trials),
              "tune_scores": all(np.isfinite(t["score"]) and t["score"] > 0
                                 for t in rec.trials),
              "tune_recompiles_debited": all(t["recompiles"] > 0
                                             for t in rec.trials),
              "tune_bucket_grid": derived.lengths[-1] >= max(hist)}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"tuner checks failed: {failed}")
    return rec

# -- phases 32-33: the router and the control plane ---------------------------


def bert_server(mx, BertServing, ctx, grid, checkpoint=None):
    """Phase 4's replica: BERT-base from seed 0 (Normal(0.02)) behind a
    ``ModelServer`` over the ``(batch sizes, lengths)`` grid.  Every
    replica built so holds the same weights: the FFN and pooler weights
    take their shapes at the first forward, which runs here, under the
    seed (one eager forward a replica, counted by :func:`bert_forwards`),
    not at a warm-up that other replicas' draws may precede."""
    import numpy as np

    mx.random.seed(0)
    bert = mx.models.bert_base(use_decoder=False, use_classifier=False)
    bert.initialize(init=mx.init.Normal(0.02), ctx=ctx)
    net = BertServing(bert)
    net(mx.nd.array(np.ones((1, 16), np.int32), ctx=ctx))
    spec = mx.serve.BucketSpec(batch_sizes=grid[0], example_shape=(None,),
                               lengths=grid[1], dtype="int32")
    return mx.serve.ModelServer(net, spec, ctx=ctx, checkpoint=checkpoint)


def bert_requests(seed, n, max_len):
    """``n`` token-id requests of lengths U[16, max_len] (numpy seed)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(1, 30522, size=int(k)).astype(np.int32)
            for k in rng.randint(16, max_len + 1, size=n)]


def bert_forwards(stats):
    """Forwards run by the :func:`bert_server` replicas of these
    ``stats()``: the one at build, each batch, and each bucket's eager
    warm-up forward and its capture's first replay."""
    return sum(1 + s["batches"] + 2 * s["warmup_batches"] for s in stats)


def max_gap(got, want):
    import numpy as np

    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(got, want))


def settle(futs):
    """``(results, failures, unclassified)`` of ``futs``: a failure is
    ``(class, message)``, and it must be classified and name the dispatch
    attempts or replicas, else it is also in ``unclassified``."""
    from mxnet_tpu_torch.resilience.supervisor import classify

    results, failures = [], []
    for f in futs:
        try:
            results.append(f.result(timeout=300))
        except Exception as e:  # noqa: BLE001 - judged below
            results.append(None)
            failures.append((classify(e), str(e)))
    bad = [f for f in failures if f[0] == "fatal" or "replica" not in f[1]]
    return results, failures, bad


def scrape_metrics(port):
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=30).read().decode()


def gauge(text, name):
    """The first sample of ``name`` in a /metrics text (None if absent)."""
    for line in text.splitlines():
        if line.startswith((name + "{", name + " ")):
            return float(line.rsplit(" ", 1)[1])
    return None


def client_threads(router, reqs, idx, futs, results, threads,
                   deadline_ms=120_000):
    """Submit ``reqs[i]`` for ``i`` in ``idx`` from ``threads`` client
    threads, each waiting for its own; True when every thread ended."""
    def client(part):
        for i in part:
            futs[i] = router.submit(reqs[i], deadline_ms=deadline_ms)
        for i in part:
            try:
                results[i] = futs[i].result(timeout=300)
            except Exception:  # noqa: BLE001 - settle() judges it
                pass
    ts = [threading.Thread(target=client, args=(idx[c::threads],))
          for c in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    return not any(t.is_alive() for t in ts)


def router_bert(mx, card, tmpdir):
    """Phase 32 (a): a ``Router`` over 3 BERT-base replicas (see the
    module docstring).  Returns the flash forward's launches and the
    record printed."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import _imperative, resilience, telemetry
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.serve import router as rt

    gpu = mx.gpu(0)
    BertServing = serving_block(mx)
    mgr = mx.checkpoint.CheckpointManager(os.path.join(tmpdir, "router"))
    servers, warm_s, inners, hedging = [], [], [], [False]

    def factory(rid):
        srv = bert_server(mx, BertServing, gpu, SERVE_GRID, checkpoint=mgr)
        start, submit = srv.start, srv.submit

        def timed_start(*a, **kw):
            t0 = time.perf_counter()
            out = start(*a, **kw)
            warm_s.append(round(time.perf_counter() - t0, 3))
            return out

        def submit_seen(example, **kw):
            fut = submit(example, **kw)
            # the hedged requests' dispatches (not the health probes')
            if hedging[0] and (kw.get("deadline_ms") or 0) > 5_000:
                inners.append(fut)
            return fut

        srv.start, srv.submit = timed_start, submit_seen
        servers.append(srv)
        return srv

    reqs = bert_requests(1, ROUTER_REQUESTS, 512)
    results, futs = [None] * ROUTER_REQUESTS, [None] * ROUTER_REQUESTS
    checks = {}
    kernels.reset_counts()
    rt.reset_router_stats()
    c0 = _imperative.graph_capture_count()
    router = mx.serve.Router(
        factory, ROUTER_REPLICAS, evict_after=2, health_sec=ROUTER_HEALTH_SEC,
        hedge_ms=ROUTER_HEDGE_MS, tenant_quota=2,
        retry=resilience.RetryPolicy(max_retries=3, base_delay=0.01,
                                     max_delay=0.05, seed=7))
    router.start()
    metrics = telemetry.MetricsServer(port=0, host="127.0.0.1").start()
    try:
        t0 = time.perf_counter()
        checks["clients_ended"] = client_threads(
            router, reqs, list(range(ROUTER_HEALTHY_FIRST)), futs, results,
            ROUTER_THREADS)
        plan = resilience.parse_plan(json.dumps(ROUTER_PLAN))
        resilience.install_plan(plan)
        try:
            t1 = time.perf_counter()
            checks["clients_ended"] &= client_threads(
                router, reqs, list(range(ROUTER_HEALTHY_FIRST,
                                         ROUTER_REQUESTS)),
                futs, results, ROUTER_THREADS)
            t2 = time.perf_counter()
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                s = router.stats()
                if s["healthy"] == ROUTER_REPLICAS and s["replacements"]:
                    break
                time.sleep(0.01)
        finally:
            resilience.clear_plan()
        fired = plan.fired()
        _, failures, bad = settle(futs)
        s = router.stats()
        live = {r.id for r in router.replicas}
        rec = {"warmup_s": warm_s[:ROUTER_REPLICAS],
               "spare_warmup_s": warm_s[ROUTER_REPLICAS:],
               "req_per_s": round(ROUTER_REQUESTS / (t2 - t0), 3),
               "faulted_req_per_s": round(
                   (ROUTER_REQUESTS - ROUTER_HEALTHY_FIRST) / (t2 - t1), 3),
               "recovery_ms": s["last_recovery_ms"],
               "evictions": s["evictions"],
               "replacements": s["replacements"], "retries": s["retries"],
               "probes": s["probes"], "probe_failures": s["probe_failures"],
               "fired": len(fired),
               "latency_ms": {k: s["latency"][k]
                              for k in ("p50_ms", "p99_ms")}}
        log(f"router (a): 3 BERT-base replicas behind a Router on {card}: "
            f"{json.dumps(rec)}; plan fired at "
            f"{sorted({(f['site'], f['ctx'].get('replica')) for f in fired})}"
            f"; failures {failures}")
        checks.update({
            "served": s["served"] == ROUTER_REQUESTS and not failures,
            "failures_classified": not bad,
            "plan_fired": any(f["site"] == "serve.replica.submit"
                              for f in fired)
            and any(f["action"] == "stall" for f in fired),
            "evicted_replica_1": s["evictions"] == 1 and 1 not in live,
            "spare_admitted": s["replacements"] == 1
            and s["healthy"] == s["pool_size"] == ROUTER_REPLICAS
            and len(servers) == ROUTER_REPLICAS + 1,
            # one capture a bucket a server (the spare's while its peers
            # served): none on a survivor in traffic
            "captures": _imperative.graph_capture_count() - c0
            == 9 * len(servers)
            and all(len(srv._net._cached_op._graphs) == 9
                    for srv in servers),
        })

        # hedging: every request with less budget than hedge_ms runs on
        # two replicas; the first answer wins and the other is cancelled
        before = router.stats()
        hedging[0] = True
        hreqs = bert_requests(32, ROUTER_HEDGE_REQUESTS, 512)
        hfuts = [router.submit(r, deadline_ms=ROUTER_HEDGE_MS / 2)
                 for r in hreqs]
        _, hfail, _ = settle(hfuts)
        hedging[0] = False
        deadline = time.monotonic() + 60
        while (time.monotonic() < deadline
               and not all(f.done() for f in inners)):
            time.sleep(0.005)
        after = router.stats()
        rec["hedges"] = after["hedges"] - before["hedges"]
        rec["hedge_wins"] = after["hedge_wins"] - before["hedge_wins"]
        rec["hedge_losers_cancelled"] = sum(f.cancelled() for f in inners)
        checks["hedged"] = (not hfail
                            and rec["hedges"] == ROUTER_HEDGE_REQUESTS
                            and len(inners) == 2 * ROUTER_HEDGE_REQUESTS
                            and rec["hedge_losers_cancelled"] >= 1)

        # a tenant over its quota of 2 outstanding requests
        qfuts = [router.submit(reqs[i], tenant="t") for i in range(2)]
        try:
            router.submit(reqs[2], tenant="t")
            refused = False
        except mx.serve.TenantQuotaExceededError:
            refused = True
        _, qfail, _ = settle(qfuts)
        checks["quota"] = (refused and not qfail
                           and router.stats()["rejected_quota"] == 1)

        # every replica holds replica 0's parameters, bit for bit
        params = [srv._net._collect_params_with_prefix() for srv in servers]
        old = {k: p.data().detach().clone() for k, p in params[0].items()}
        checks["replicas_identical"] = all(
            all(torch.equal(p.data().detach(), old[k]) for k, p in ps.items())
            for ps in params)

        # a rolling reload under load, to the same weights with the
        # pooler's bias raised: old and new answers lie far apart
        new = {k: v.clone() for k, v in old.items()}
        new["bert.pooler.bias"] += ROUTER_RELOAD_BIAS
        mgr.save(1, params=new, sync=True)
        del new
        rreqs = bert_requests(33, ROUTER_RELOAD_REQUESTS, 512)
        rfuts = [None] * ROUTER_RELOAD_REQUESTS
        c1 = _imperative.graph_capture_count()

        def submitter():   # spread over the reload's ~1.5 s
            for i, r in enumerate(rreqs):
                rfuts[i] = router.submit(r, deadline_ms=120_000)
                time.sleep(ROUTER_RELOAD_GAP_S)

        th = threading.Thread(target=submitter)
        t3 = time.perf_counter()
        th.start()
        time.sleep(0.02)
        metas = router.rolling_reload(timeout=120)
        th.join(timeout=120)
        rec["reload_s"] = round(time.perf_counter() - t3, 3)
        extra = bert_requests(34, 3, 512)
        rreqs += extra
        rfuts += [router.submit(r, deadline_ms=120_000) for r in extra]
        reloaded, rfail, _ = settle(rfuts)
        router.drain(timeout=120)
        launches = fa.counts.launches
        plain = fa.counts.plain_calls_on_cuda
        stats = [srv.stats() for srv in servers]
        s = router.stats()
        page = scrape_metrics(metrics.port)
    finally:
        metrics.stop()
        router.shutdown(drain=False)
    forwards = bert_forwards(stats)
    rec.update(launches=launches, forwards=forwards,
               plain_calls_on_cuda=plain,
               post_warmup_compiles=[st["graph"]["post_warmup_compiles"]
                                     for st in stats])
    checks.update({
        "requests_lost": s["requests_lost"] == 0,
        "post_warmup_compiles": all(
            st["graph"]["post_warmup_compiles"] == 0 for st in stats),
        "launches": launches == 12 * forwards and plain == 0,
        "reload_steps": [m["step"] for m in metas] == [1] * ROUTER_REPLICAS
        and s["reloads"] == ROUTER_REPLICAS,
        "reload_no_capture": _imperative.graph_capture_count() == c1,
        "reload_served": not rfail,
        "metrics": gauge(page, "mxtpu_router_served") == s["served"]
        and gauge(page, "mxtpu_router_requests_lost") == 0
        and gauge(page, "mxtpu_ctrl_replicas") is not None,
    })

    # each reload-period response against two eager card forwards of its
    # example, under the old and under the new weights: exactly one within
    # phase 4's limit
    eager = BertServing(servers[0]._net.bert)   # not hybridized
    bias = servers[0]._net.bert.pooler.bias.data().data

    def card_forward(ex):
        return [o.data.cpu().numpy()[0]
                for o in eager(mx.nd.array(ex[None], ctx=gpu))]

    with torch.no_grad():
        new_ans = [card_forward(r) for r in rreqs]
        bias.copy_(old["bert.pooler.bias"])
        old_ans = [card_forward(r) for r in rreqs]
    is_old = [max_gap(g, w) <= CPU_ATOL for g, w in zip(reloaded, old_ans)]
    is_new = [max_gap(g, w) <= CPU_ATOL for g, w in zip(reloaded, new_ans)]
    rec["reload_old_new"] = (sum(is_old), sum(is_new))
    rec["reload_old_vs_new_gap"] = round(min(
        max_gap(a, b) for a, b in zip(old_ans, new_ans)), 4)
    checks["reload_old_xor_new"] = (all(a != b for a, b in zip(is_old,
                                                               is_new))
                                    and is_new[-3:] == [True] * 3)

    # 3 responses of the traffic and 3 of the reload against the CPU
    cpu_bert = mx.models.bert_base(use_decoder=False, use_classifier=False)
    cpu_bert.initialize(ctx=mx.cpu())
    mx.load_numpy_params(cpu_bert, {k.split(".", 1)[1]: v.cpu().numpy()
                                    for k, v in old.items()})
    cpu_net = BertServing(cpu_bert)

    def cpu_forward(ex):
        return [o.asnumpy()[0]
                for o in cpu_net(mx.nd.array(ex[None], ctx=mx.cpu()))]

    short = [int(i) for i in np.argsort([len(r) for r in reqs])[:3]]
    cpu_err = [max_gap(results[i], cpu_forward(reqs[i])) for i in short]
    new_idx = [i for i, n in enumerate(is_new) if n][-3:]
    cpu_bert.pooler.bias.data().data.add_(ROUTER_RELOAD_BIAS)
    cpu_err += [max_gap(reloaded[i], cpu_forward(rreqs[i])) for i in new_idx]
    rec["cpu_max_abs_err"] = round(max(cpu_err), 6)
    checks["cpu_parity"] = max(cpu_err) <= CPU_ATOL and len(cpu_err) == 6
    log(f"router (a): hedging, quota, rolling reload and answers: "
        f"{json.dumps(rec)}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"router checks failed: {failed}")
    return {"launches": launches, "record": rec}


def router_decode(mx, card):
    """Phase 32 (b): a ``Router`` over 2 ``DecodeServer`` replicas at
    phase 30's configuration; every stream equal to a single server's."""
    import numpy as np

    gpu = mx.gpu(0)
    prompts, budgets = decode_traffic()
    prompts, budgets = prompts[:ROUTER_DECODE_REQUESTS], \
        budgets[:ROUTER_DECODE_REQUESTS]
    want, _ = decode_run(mx, decode_model(mx, gpu), gpu, prompts, budgets)
    spec = mx.serve.BucketSpec(batch_sizes=DEC_BATCHES, example_shape=(None,),
                               lengths=DEC_LENGTHS, dtype="int32")
    servers = []

    def factory(rid):
        srv = mx.serve.DecodeServer(decode_model(mx, gpu), spec,
                                    max_slots=DEC_SLOTS, max_len=DEC_MAX_LEN,
                                    max_queue=len(prompts) + 8, ctx=gpu)
        servers.append(srv)
        return srv

    router = mx.serve.Router(factory, 2, health_sec=ROUTER_HEALTH_SEC)
    t0 = time.perf_counter()
    router.start()
    try:
        t1 = time.perf_counter()
        handles = [router.submit_stream(p, max_new_tokens=m)
                   for p, m in zip(prompts, budgets)]
        got = [np.asarray(list(h), np.int32) for h in handles]
        wall = time.perf_counter() - t1
        router.drain(timeout=120)
        s = router.stats()
    finally:
        router.shutdown(drain=False)
    tokens = sum(len(g) for g in got)
    same = sum(np.array_equal(g, np.asarray(w)) for g, w in zip(got, want))
    log(f"router (b): 2 DecodeServer replicas (TinyDecoder({DEC_VOCAB}, "
        f"{DEC_EMBED}), {DEC_SLOTS} slots, max_len {DEC_MAX_LEN}) warmed in "
        f"{t1 - t0:.2f} s; {len(prompts)} streams, {tokens} tokens in "
        f"{wall:.3f} s ({len(prompts) / wall:.2f} req/s, "
        f"{tokens / wall:.1f} tokens/s) on {card}; {same}/{len(prompts)} "
        f"token for token equal to one server's; dispatched "
        f"{[srv.stats()['served'] for srv in servers]} a replica, probes "
        f"{s['probes']}")
    checks = {"served": s["served"] == len(prompts)
              and s["requests_lost"] == 0,
              "streams_equal": same == len(prompts),
              "both_served": all(srv.stats()["served"] > 0
                                 for srv in servers),
              "post_warmup_compiles": all(
                  srv.stats()["graph"]["post_warmup_compiles"] == 0
                  for srv in servers)}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"decode router checks failed: {failed}")
    return {"req_per_s": round(len(prompts) / wall, 3),
            "tokens_per_s": round(tokens / wall, 1)}


def serve_replica_worker(registry, rid):
    """A replica process of phase 33 (``chip_smoke.py --serve-replica-worker
    REGISTRY ID``, spawned by the control plane): phase 32's BERT-base
    replica over ``CTRL_GRID``, warmed up, then registered; on SIGTERM it
    prints its flash launches and its server's counts as one JSON line."""
    import signal

    import torch

    sys.path.insert(0, str(ROOT))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _imperative
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.serve.control_plane import serve_replica

    if not torch.cuda.is_available():
        print("serve replica worker: no CUDA device is visible",
              file=sys.stderr, flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    srv = bert_server(mx, serving_block(mx), mx.gpu(0), CTRL_GRID)
    srv.start()
    warm_s = time.perf_counter() - t0
    captures = _imperative.graph_capture_count()
    endpoint = serve_replica(srv, registry_dir=registry, replica_id=rid)
    print(json.dumps({"event": "registered", "replica": rid,
                      "pid": os.getpid(), "warmup_s": round(warm_s, 3),
                      "captures": captures}), flush=True)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    endpoint.stop()
    srv.shutdown(drain=False, timeout=10.0)
    st = srv.stats()
    print(json.dumps({"event": "stopped", "replica": rid,
                      "flash_launches": fa.counts.launches,
                      "plain_calls_on_cuda": fa.counts.plain_calls_on_cuda,
                      "captures": _imperative.graph_capture_count(),
                      "batches": st["batches"],
                      "warmup_batches": st["warmup_batches"],
                      "served": st["served"],
                      "post_warmup_compiles":
                          st["graph"]["post_warmup_compiles"]}), flush=True)
    return 0


def worker_events(registry):
    """``{replica: {event: record}}`` from the workers' logs."""
    out = {}
    for log_path in sorted(Path(registry).glob("replica-*.log")):
        for line in log_path.read_text(errors="replace").splitlines():
            if line.startswith('{"event"'):
                ev = json.loads(line)
                out.setdefault(str(ev["replica"]), {})[ev["event"]] = ev
    return out


def control_plane_first_worker(mx, tmpdir):
    """Phase 33's ``ControlPlane``, built on a thread of its own: the
    router's factory spawns the first worker as it is built, and a spawn
    (~10 s: the worker's interpreter, torch and CUDA start-up, then its
    warm-up) overlaps phase 32.  Returns a record that receives the plane,
    or the error, and the seconds to the first warm worker."""
    from mxnet_tpu_torch import base, resilience
    from mxnet_tpu_torch.serve import control_plane as cp

    registry = os.path.join(tmpdir, "registry")
    env = dict(os.environ, MXTPU_CTRL_LEASE_SEC=str(CTRL_LEASE_SEC))
    knobs = {"CTRL_COOLDOWN_SEC": CTRL_COOLDOWN_SEC,
             "CTRL_LEASE_SEC": CTRL_LEASE_SEC}
    first = {"registry": registry, "plane": None,
             "saved": {k: base.getenv(k) for k in knobs}}
    for k, v in knobs.items():
        base.setenv(k, v)
    cp.reset_ctrl_stats()

    def argv(rid):
        return [sys.executable, str(ROOT / "chip_smoke.py"),
                "--serve-replica-worker", registry, str(rid)]

    def build():
        t0 = time.perf_counter()
        try:
            first["plane"] = cp.ControlPlane(
                argv, registry, 1, capacity_hint=CTRL_CAPACITY,
                spawn_env=env, spawn_timeout=300,
                health_sec=CTRL_HEALTH_SEC, evict_after=2,
                retry=resilience.RetryPolicy(max_retries=4, base_delay=0.01,
                                             max_delay=0.1, seed=7))
        except BaseException as e:  # noqa: BLE001 - raised by phase 33
            first["error"] = e
        first["first_worker_s"] = round(time.perf_counter() - t0, 3)

    first["thread"] = threading.Thread(target=build, daemon=True)
    first["thread"].start()
    return first


def control_plane_stop(first):
    """Stop phase 33's plane and its workers, and restore its knobs; safe
    to call again, and after a failure anywhere."""
    from mxnet_tpu_torch import base

    first["thread"].join(timeout=600)
    if first["plane"] is not None:
        first["plane"].shutdown(drain=False, timeout=10)
    for k, v in first["saved"].items():
        base.setenv(k, v)


def control_plane_bert(mx, card, first):
    """Phase 33: a ``ControlPlane`` of BERT-base worker processes driven by
    an ``Autoscaler`` (see the module docstring), from the plane that
    :func:`control_plane_first_worker` started.  Returns the flash
    forward's launches in the workers that stopped cleanly."""
    import numpy as np

    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import control_plane as cp

    gpu = mx.gpu(0)
    registry = first["registry"]
    checks, rec = {}, {}
    plane = scaler = None
    metrics = telemetry.MetricsServer(port=0, host="127.0.0.1").start()
    stop, futs, lock = threading.Event(), [], threading.Lock()
    gens = []

    def generator(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            ex = rng.randint(1, 30522, size=int(rng.randint(16, 257))) \
                .astype(np.int32)
            fut = plane.submit(ex, deadline_ms=120_000)
            with lock:
                futs.append(fut)
            try:
                fut.result(timeout=300)
            except Exception:  # noqa: BLE001 - settle() judges it
                pass

    def load(n):
        for _ in range(n):
            t = threading.Thread(target=generator, args=(100 + len(gens),),
                                 daemon=True)
            t.start()
            gens.append(t)

    def wait_for(pred, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.05)
        return pred()

    t_phase = time.perf_counter()
    try:
        first["thread"].join(timeout=600)
        if "error" in first:
            raise first["error"]
        plane = first["plane"]
        rec["first_worker_s"] = first["first_worker_s"]

        # 4 single requests through a RemoteReplica against an in-process
        # replica of the same weights and grid, bit for bit; before the
        # router starts its health probes, since a probe landing in a
        # request's batching window rides its batch (bucket 4, not 1), and
        # a batch of another size sums in another order
        local = bert_server(mx, serving_block(mx), gpu, CTRL_GRID).start()
        remote = plane.router.replicas[0].server
        same = []
        for ex in bert_requests(35, 4, 256):
            got = remote.submit(ex).result(timeout=300)
            want = local.predict(ex, timeout=300)
            same.append(all(np.array_equal(g, w) for g, w in zip(got, want)))
        local.shutdown()
        del local
        checks["remote_bit_identical"] = all(same) and len(same) == 4
        plane.start()
        scaler = cp.Autoscaler(plane, min_replicas=1, max_replicas=2,
                               up_ticks=2, down_ticks=3,
                               tick_sec=CTRL_TICK_SEC)

        # offered load raised until the autoscaler grows the pool to 2
        scaler.start()
        load(1)
        time.sleep(4 * CTRL_TICK_SEC)
        low_replicas = plane.replica_count()
        t1 = time.perf_counter()
        load(CTRL_LOAD_THREADS - 1)
        checks["scaled_up"] = low_replicas == 1 and wait_for(
            lambda: plane.healthy_count() == 2, 300)
        rec["scale_up_s"] = round(time.perf_counter() - t1, 3)

        # SIGKILL the worker carrying the most dispatches, mid-burst
        victim = None
        deadline = time.monotonic() + 30
        while victim is None and time.monotonic() < deadline:
            carrying = [r.server for r in plane.router.replicas
                        if r.server._pending]
            if carrying:
                victim = max(carrying, key=lambda rr: len(rr._pending))
            time.sleep(0.001)
        checks["victim_carrying"] = victim is not None
        victim = victim or plane.router.replicas[-1].server
        rec["killed"] = {"replica": victim.rid, "pid": victim.process.pid,
                         "in_flight": len(victim._pending)}
        t_kill = time.perf_counter()
        victim.process.kill()
        # polled without stats(), whose replica gauges are round trips
        checks["healed"] = wait_for(
            lambda: plane.router.last_recovery_ms is not None
            and plane.healthy_count() == 2, 300)
        rec["kill_to_rejoin_s"] = round(time.perf_counter() - t_kill, 3)
        s = plane.stats()
        rec["recovery_ms"] = s["last_recovery_ms"]
        rec["evictions"] = s["evictions"]

        # load drops until the pool drains back to one worker
        stop.set()
        for t in gens:
            t.join(timeout=300)
        t2 = time.perf_counter()
        checks["drained"] = wait_for(lambda: plane.healthy_count() == 1,
                                     120)
        rec["drain_s"] = round(time.perf_counter() - t2, 3)
        scaler.stop()
        served_s = time.perf_counter() - t1
        _, failures, bad = settle(futs)
        s = plane.stats()
        live = [r.server.stats() for r in plane.router.replicas]
        ctrl = cp.ctrl_stats()
        page = scrape_metrics(metrics.port)
        rec.update(requests=len(futs), served=s["served"],
                   req_per_s=round(s["served"] / served_s, 3),
                   retries=s["retries"], failures=failures,
                   latency_ms={k: s["latency"][k]
                               for k in ("p50_ms", "p99_ms")},
                   ctrl={k: ctrl[k] for k in (
                       "spawns", "spawn_failures", "scale_ups",
                       "scale_downs", "retired")})
    finally:
        stop.set()
        if scaler is not None:
            scaler.stop()
        metrics.stop()
        if plane is not None:
            plane.shutdown(drain=True, timeout=60)
    events = worker_events(registry)
    stopped = [ev["stopped"] for ev in events.values() if "stopped" in ev]
    registered = [ev["registered"] for ev in events.values()]
    launches = sum(ev["flash_launches"] for ev in stopped)
    rec.update(worker_warmup_s=[ev["warmup_s"] for ev in registered],
               worker_launches={ev["replica"]: ev["flash_launches"]
                                for ev in stopped},
               phase_s=round(time.perf_counter() - t_phase, 3))
    log(f"control plane: BERT-base workers over {CTRL_GRID} on {card}: "
        f"{json.dumps(rec)}")
    checks.update({
        "served": s["served"] == len(futs) and not failures,
        "failures_classified": not bad,
        "requests_lost": s["requests_lost"] == 0,
        "network_redispatch": s["retries"] >= 1,
        "corpse_evicted": s["evictions"] >= 1 and s["replacements"] >= 1
        and victim.rid not in {r.id for r in plane.router.replicas},
        "spawns": ctrl["spawns"] == 3 and ctrl["spawn_failures"] == 0,
        "scaled": ctrl["scale_ups"] == 1 and ctrl["scale_downs"] >= 1
        and ctrl["retired"] >= 1,
        "ctrl_gauges": gauge(page, "mxtpu_ctrl_spawns") == ctrl["spawns"]
        and gauge(page, "mxtpu_ctrl_scale_ups") == ctrl["scale_ups"]
        and gauge(page, "mxtpu_ctrl_retired") == ctrl["retired"],
        "no_traffic_capture": all(st["graph"]["post_warmup_compiles"] == 0
                                  for st in live)
        and all(ev["captures"] == events[str(ev["replica"])]["registered"][
            "captures"] and ev["post_warmup_compiles"] == 0
            for ev in stopped),
        # every worker but the killed one stopped cleanly and counted its
        # launches: 12 a forward
        "worker_launches": len(stopped) == len(registered) - 1 >= 2
        and all(ev["flash_launches"] == 12 * bert_forwards([ev])
                and ev["plain_calls_on_cuda"] == 0 for ev in stopped),
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"control plane checks failed: {failed}")
    return {"launches": launches, "record": rec}


# -- phases 34-36: the symbolic API ----------------------------------------------


def sym_rel(got, ref):
    """``|got - ref| / |ref|`` of two tensors (norms)."""
    return float((got.float() - ref.float()).norm()
                 / max(float(ref.float().norm()), 1e-12))


def module_resnet(mx, card, tmpdir):
    """Phase 34: ResNet-50 v1 through the symbolic API.  The model zoo's
    gluon net (random weights from a seed) is exported, reloaded with
    ``mx.model.load_checkpoint``, given a ``SoftmaxOutput`` and bound in
    ``mx.mod.Module`` on gpu(0) at b=32.  Gates: the Module's predict
    forward within ``SYM_FWD_ATOL`` of the gluon net's softmax, its first
    step's parameter gradients within ``SYM_GRAD_RTOL`` (norm) of autograd
    through the gluon net with the summed cross-entropy, ``fit`` steps
    with finite outputs, ``predict`` finite.  Returns what phase 36 needs:
    the exported symbol, the parameters after ``fit``, the calibration
    images and the evaluation batch."""
    import numpy as np
    import torch

    dev = mx.gpu(0)
    B = SYM_BATCH
    rng = np.random.RandomState(34)
    mx.random.seed(34)
    xs = rng.uniform(-1, 1, (B * SYM_FIT_STEPS, 3, SYM_IMAGE, SYM_IMAGE)) \
        .astype(np.float32)
    ys = rng.randint(0, 1000, B * SYM_FIT_STEPS).astype(np.float32)
    net = mx.gluon.model_zoo.vision.resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=dev)
    x0 = mx.nd.array(xs[:B], ctx=dev)
    y0 = mx.nd.array(ys[:B], ctx=dev)
    logits = net(x0).data                 # predict mode; completes init
    prefix = os.path.join(tmpdir, "resnet50_v1")
    t = time.perf_counter()
    net.export(prefix)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    sym, ap, xp = mx.model.load_checkpoint(prefix, 0)
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(sym, name="softmax"),
                        context=dev)
    mod.bind(data_shapes=[("data", (B, 3, SYM_IMAGE, SYM_IMAGE))],
             label_shapes=[("softmax_label", (B,))])
    mod.init_params(arg_params=ap, aux_params=xp)
    bind_s = time.perf_counter() - t
    batch = mx.io.DataBatch([x0], [y0])
    mod.forward(batch, is_train=False)
    fwd_gap = float((mod.get_outputs()[0].data
                     - torch.softmax(logits, dim=1)).abs().max())
    # the first step's gradients: the Module's executor against autograd
    # through the gluon net (SoftmaxOutput's gradient is the summed
    # cross-entropy's); both BatchNorms in training mode
    mod.forward(batch, is_train=True)
    mod.backward()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(x0), y0)
    loss.backward()
    params = net.collect_params()
    grad_gaps = {n: sym_rel(mod._exec.grad_dict[n].data, params[n].grad())
                 for n in ap}
    worst = max(grad_gaps, key=grad_gaps.get)
    with mx.gpu(0):
        it = mx.io.NDArrayIter(xs, ys, batch_size=B)
    stamps = [time.perf_counter()]
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
            eval_metric="acc",
            batch_end_callback=lambda p: stamps.append(time.perf_counter()))
    fit_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    issue, wall = [], []
    for _ in range(SYM_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(wall)
    # the host's share of the step: its issue time over the wall time,
    # valid where the step makes no host synchronisation (counted here)
    host_share = statistics.median(issue) / step_ms
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mod.forward_backward(batch)
            mod.update()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0][:80] for w in caught})
    with dev:
        pred = mod.predict(mx.io.NDArrayIter(xs[:B], ys[:B], batch_size=B))
    pred = pred.data
    ap_fit, xp_fit = mod.get_params()
    log(f"module resnet (phase 34): resnet50_v1 exported in {export_s:.2f} "
        f"s ({len(ap)} args, {len(xp)} aux), loaded and bound at b={B} in "
        f"{bind_s:.2f} s; Module predict forward vs the gluon net's softmax "
        f"max |d| {fwd_gap:.3e} (gate {SYM_FWD_ATOL}); first-step gradients "
        f"vs autograd through the net: worst {worst} {grad_gaps[worst]:.3e}"
        f" (gate {SYM_GRAD_RTOL}); fit {SYM_FIT_STEPS} SGD steps (momentum "
        f"0.9), step wall ms {[round(v, 3) for v in fit_ms]}; timed steps "
        f"median {step_ms:.3f} ms, host issue {statistics.median(issue):.3f}"
        f" ms = host share {host_share:.3f} ({len(caught)} synchronising "
        f"calls a step: {syncs}); predict {tuple(pred.shape)} on "
        f"{card}")
    checks = {"forward": fwd_gap <= SYM_FWD_ATOL,
              "gradients": grad_gaps[worst] <= SYM_GRAD_RTOL,
              "fit_steps": len(fit_ms) == SYM_FIT_STEPS,
              "predict": tuple(pred.shape) == (B, 1000)
              and bool(torch.isfinite(pred).all())}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"module resnet checks failed: {failed}")
    return {"sym": sym, "args": ap_fit, "aux": xp_fit, "calib": xs[:2 * B],
            "x": x0, "step_ms": step_ms, "host_share": host_share}


def int8_resnet(mx, card, res):
    """Phase 36: ``contrib.quantization.quantize_model`` of phase 34's
    ResNet-50 (its parameters after ``fit``), naive calibration on 2
    batches of 32, the int8 graph bound with ``Symbol.bind`` on gpu(0)
    (ROADMAP caveat (n)) beside the float32 graph.  Gates: top-1 agreement
    with float32 over the b=32 batch at least ``SYM_INT8_AGREE``, 53
    quantized convolutions and 1 FC in the graph, 54 ``int_mm`` calls a
    forward, a 3-D int8 convolution on the card equal to its CPU result.
    Prints both executors' forward medians."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.contrib import quantization as qz
    from mxnet_tpu_torch.ops import quantization as tq

    dev = mx.gpu(0)
    B = SYM_BATCH
    t = time.perf_counter()
    with dev:
        calib = mx.io.NDArrayIter(res["calib"], None, batch_size=B)
        qsym, qa, qx = qz.quantize_model(
            res["sym"], res["args"], res["aux"], calib_mode="naive",
            calib_data=calib, num_calib_examples=2 * B, ctx=dev)
    quant_s = time.perf_counter() - t
    nodes = [n["op"] for n in json.loads(qsym.tojson())["nodes"]]
    n_conv = nodes.count("_contrib_quantized_conv")
    n_fc = nodes.count("_contrib_quantized_fully_connected")
    fex = res["sym"].bind(dev, dict(res["args"], data=res["x"]),
                          grad_req="null", aux_states=res["aux"])
    qex = qsym.bind(dev, dict(qa, data=res["x"]), grad_req="null",
                    aux_states=qx)
    fout = fex.forward()[0].data
    tq.reset_int_mm_counts()
    qout = qex.forward()[0].data
    int_mm = dict(tq.int_mm_counts)
    agree = float((qout.argmax(1) == fout.argmax(1)).float().mean())
    fp32_ms = cuda_ms(lambda: fex.forward(), SYM_INT8_ITERS)
    int8_ms = cuda_ms(lambda: qex.forward(), SYM_INT8_ITERS)
    rng = np.random.RandomState(36)
    x3 = torch.from_numpy(rng.randint(-127, 128, (2, 16, 8, 16, 16))
                          .astype(np.int8))
    w3 = torch.from_numpy(rng.randint(-127, 128, (32, 16, 3, 3, 3))
                          .astype(np.int8))
    conv3 = ((3, 3, 3), (1, 1, 1), (), (1, 1, 1), 1)
    card3 = tq._conv_i32(x3.cuda(), w3.cuda(), *conv3)
    cpu3 = tq._conv_i32(x3, w3, *conv3)
    same3 = bool(torch.equal(card3.cpu(), cpu3))
    conv3_ms = cuda_ms(lambda: tq._conv_i32(x3.cuda(), w3.cuda(), *conv3),
                       5)
    log(f"int8 resnet (phase 36): quantize_model (naive, 2 batches of {B}) "
        f"in {quant_s:.2f} s: {n_conv} quantized conv + {n_fc} FC; top-1 "
        f"agreement with float32 over b={B}: {agree:.4f} (gate "
        f"{SYM_INT8_AGREE}); executor forward median fp32 {fp32_ms:.3f} ms,"
        f" int8 {int8_ms:.3f} ms; int_mm a forward {int_mm}; 3-D int8 "
        f"convolution (2,16,8,16,16) x (32,16,3,3,3) pad 1: card == CPU "
        f"{same3}, {conv3_ms:.3f} ms on {card}")
    checks = {"agreement": agree >= SYM_INT8_AGREE,
              "quantized_nodes": (n_conv, n_fc) == (53, 1),
              "int_mm_calls": int_mm["calls"] == 54,
              "finite": bool(torch.isfinite(qout).all()),
              "conv3d": same3}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"int8 resnet checks failed: {failed}")
    return {"fp32_ms": fp32_ms, "int8_ms": int8_ms}


def lm_sym_gen(mx):
    """The LSTM language model of MXNet 1.x's
    example/rnn/bucketing/cudnn_lstm_bucketing.py, one graph per bucket:
    Embedding -> swapaxes -> RNN(lstm) -> swapaxes -> FullyConnected ->
    SoftmaxOutput, the begin states variables."""
    def sym_gen(seq_len):
        S = mx.sym
        data, label = S.var("data"), S.var("softmax_label")
        emb = S.Embedding(data, input_dim=LM_VOCAB, output_dim=LM_EMBED,
                          name="embed")
        rnn = S.RNN(S.swapaxes(emb, dim1=0, dim2=1), state_size=LM_HIDDEN,
                    num_layers=LM_LAYERS, mode="lstm", name="lstm")
        pred = S.FullyConnected(S.swapaxes(rnn, dim1=0, dim2=1),
                                num_hidden=LM_VOCAB, flatten=False,
                                name="pred")
        out = S.SoftmaxOutput(S.reshape(pred, shape=(-1, LM_VOCAB)),
                              S.reshape(label, shape=(-1,)), name="softmax",
                              use_ignore=True, ignore_label=0)
        return out, ("data",), ("softmax_label",)

    return sym_gen


def lm_sentences(rng, buckets):
    """``LM_BATCHES`` batches of sentences a bucket, lengths uniform over
    the bucket, tokens Zipf(1.2) over the vocabulary (0 is padding)."""
    import numpy as np

    out, lo = [], 0
    for b in buckets:
        for n in rng.randint(lo + 1, b + 1, LM_BATCH * LM_BATCHES):
            out.append(list(np.clip(rng.zipf(1.2, n), 1, LM_VOCAB - 1)))
        lo = b
    return out


def bucketing_lm(mx, card, tmpdir):
    """Phase 35: the LSTM LM through ``mx.mod.BucketingModule`` on gpu(0):
    one epoch of ``mx.rnn.BucketSentenceIter`` batches over all six
    buckets with ``metric.Perplexity``, ``callback.Speedometer`` and
    ``callback.do_checkpoint``; then ``Module.load`` of the checkpoint,
    scored against the trained module.  Gates: every bucket run; the
    per-batch perplexity finite and falling; rows 11-12 launched 2 layers
    x (1 forward + 1 backward) a step with 0 plain calls; the reloaded
    checkpoint's score equal to the trained module's; one bucket's
    forward and gradients on the card against the CPU within the RNN
    tests' tolerances."""
    import random as pyrandom

    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels

    dev = mx.gpu(0)
    rng = np.random.RandomState(35)
    pyrandom.seed(35)
    sents = lm_sentences(rng, LM_BUCKETS)
    with dev:
        it = mx.rnn.BucketSentenceIter(sents, LM_BATCH,
                                       buckets=list(LM_BUCKETS),
                                       invalid_label=0)
    mod = mx.mod.BucketingModule(
        lm_sym_gen(mx), default_bucket_key=it.default_bucket_key,
        context=dev, fixed_param_names=["lstm_state", "lstm_state_cell"])
    state = (LM_LAYERS, LM_BATCH, LM_HIDDEN)
    zeros = {n: mx.nd.zeros(state, ctx=dev)
             for n in ("lstm_state", "lstm_state_cell")}
    metric = mx.metric.Perplexity(0)
    seen, ppl, stamps = [], [], [time.perf_counter()]
    last = [0.0, 0]

    def record(p):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        seen.append(mod._curr_bucket_key)
        s, n = metric.sum_metric, metric.num_inst
        ppl.append(float(np.exp((s - last[0]) / max(n - last[1], 1))))
        last[:] = [s, n]

    prefix = os.path.join(tmpdir, "lstm_lm")
    kernels.reset_counts()
    with dev:       # the iterator makes its batches on the current context
        mod.fit(it, eval_metric=metric, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": LM_LR, "wd": 1e-5},
                initializer=mx.init.Uniform(0.1), arg_params=zeros,
                allow_missing=True,
                batch_end_callback=[mx.callback.Speedometer(
                    LM_BATCH, len(LM_BUCKETS), auto_reset=False), record],
                epoch_end_callback=mx.callback.do_checkpoint(prefix))
    steps = len(seen)
    counts = {k: (kernels.KERNEL_COUNTS[k].launches,
                  kernels.KERNEL_COUNTS[k].plain_calls_on_cuda)
              for k in ("lstm_fwd", "lstm_bwd")}
    routes = {k: launches_by_route(kernels.KERNEL_COUNTS[k])
              for k in ("lstm_fwd", "lstm_bwd")}
    by_bucket = {}
    for key, a, b in zip(seen, stamps, stamps[1:]):
        by_bucket.setdefault(key, []).append((b - a) * 1e3)
    # each bucket's first step binds its executor: the median of the rest
    step_ms = {k: statistics.median(v[1:] or v)
               for k, v in sorted(by_bucket.items())}
    # the checkpoint: Module.load (the graph is the same for every bucket
    # length) bound at the largest bucket, scored against the trained
    # module on that bucket's batches
    big = [s for s in sents if len(s) > LM_BUCKETS[-2]]
    with dev:
        it_big = mx.rnn.BucketSentenceIter(big, LM_BATCH,
                                           buckets=[LM_BUCKETS[-1]],
                                           invalid_label=0)
        want = mod.score(it_big, mx.metric.Perplexity(0))[0][1]
        loaded = mx.mod.Module.load(prefix, 1, context=dev)
        loaded.bind(data_shapes=it_big.provide_data,
                    label_shapes=it_big.provide_label, for_training=False)
        got = loaded.score(it_big, mx.metric.Perplexity(0))[0][1]
    # one bucket (the smallest) on the card against the CPU, from the
    # trained parameters: forward and every gradient
    args, _ = mod.get_params()
    small = [s for s in sents if len(s) <= LM_BUCKETS[0]][:LM_BATCH]
    data = np.zeros((LM_BATCH, LM_BUCKETS[0]), np.float32)
    for i, s in enumerate(small):
        data[i, :len(s)] = s
    label = np.zeros_like(data)
    label[:, :-1] = data[:, 1:]
    sym = lm_sym_gen(mx)(LM_BUCKETS[0])[0]
    res = []
    for ctx in (dev, mx.cpu()):
        feed = {k: mx.nd.array(v.asnumpy(), ctx=ctx)
                for k, v in args.items()}
        feed.update(data=mx.nd.array(data, ctx=ctx),
                    softmax_label=mx.nd.array(label, ctx=ctx))
        ex = sym.bind(ctx, feed, args_grad={
            k: mx.nd.zeros(v.shape, ctx=ctx) for k, v in feed.items()},
            grad_req={k: ("null" if k in ("data", "softmax_label")
                          else "write") for k in feed})
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res.append((out, {k: ex.grad_dict[k].asnumpy() for k in args}))
    fwd_gap = float(np.abs(res[0][0] - res[1][0]).max())
    grad_ok = all(np.allclose(res[0][1][k], res[1][1][k], **LM_GRAD_TOL)
                  for k in res[1][1])
    grad_gap = max(float(np.abs(res[0][1][k] - res[1][1][k]).max())
                   for k in res[1][1])
    half = max(1, steps // 4)
    log(f"bucketing lm (phase 35): LSTM LM vocab {LM_VOCAB}, embed "
        f"{LM_EMBED}, {LM_LAYERS}x{LM_HIDDEN}, batch {LM_BATCH}, buckets "
        f"{LM_BUCKETS}, SGD lr {LM_LR}, {steps} steps over buckets "
        f"{sorted(set(seen))}; perplexity by batch "
        f"{[round(v, 1) for v in ppl]}; epoch {metric.get()[1]:.2f}; step "
        f"median ms by bucket {({k: round(v, 3) for k, v in step_ms.items()})}"
        f"; (launches, plain calls on cuda) {counts} (2 x {steps} = "
        f"{2 * steps} each), by route {routes}; checkpoint reloaded by "
        f"Module.load and scored {got:.6f} vs the trained module "
        f"{want:.6f}; bucket {LM_BUCKETS[0]} card vs CPU: output max |d| "
        f"{fwd_gap:.3e}, gradients max |d| {grad_gap:.3e} (tolerances "
        f"{LM_FWD_ATOL}, {LM_GRAD_TOL}) on {card}")
    checks = {"every_bucket": sorted(set(seen)) == sorted(LM_BUCKETS),
              "finite": all(np.isfinite(ppl)),
              "falling": np.mean(ppl[-half:]) < np.mean(ppl[:half]),
              "launches": all(c[0] == LM_LAYERS * steps
                              for c in counts.values()),
              "plain_calls_on_cuda": all(c[1] == 0 for c in counts.values()),
              "reloaded_score": abs(got - want) <= LM_SCORE_RTOL * abs(want),
              "card_vs_cpu_forward": fwd_gap <= LM_FWD_ATOL,
              "card_vs_cpu_gradients": grad_ok}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"bucketing lm checks failed: {failed}")
    return {k: c[0] for k, c in counts.items()}, step_ms, routes


# -- phases 37-38: the MoE language model (slice 7, part 3) -------------------


def moe_lm_classes(mx):
    """``examples/moe/train_moe_lm.py``'s ``MoEDecoderLayer`` and
    ``MoETransformerLM`` over the port's gluon (pre-norm causal
    self-attention through the fused ``multihead_attention`` op, then
    ``gluon.contrib.nn.MoEFFN``; no positional encoding, an untied head)."""
    gluon = mx.gluon

    class MoEDecoderLayer(gluon.HybridBlock):
        def __init__(self, d_model, n_heads, n_experts, d_hidden, top_k=1,
                     **kw):
            super().__init__(**kw)
            self._h = n_heads
            self.norm1 = gluon.nn.LayerNorm()
            self.norm2 = gluon.nn.LayerNorm()
            self.in_weight = self.params.get("in_weight",
                                             shape=(3 * d_model, d_model))
            self.in_bias = self.params.get("in_bias", shape=(3 * d_model,),
                                           init="zeros")
            self.out_weight = self.params.get("out_weight",
                                              shape=(d_model, d_model))
            self.out_bias = self.params.get("out_bias", shape=(d_model,),
                                            init="zeros")
            self.moe = gluon.contrib.nn.MoEFFN(
                n_experts, d_model, d_hidden, capacity_factor=MOE_CF,
                top_k=top_k)

        def hybrid_forward(self, F, x, in_weight, in_bias, out_weight,
                           out_bias):
            h = self.norm1(x)
            att = F.multihead_attention(h, h, h, in_weight, in_bias,
                                        out_weight, out_bias,
                                        num_heads=self._h, causal=True)
            x = x + att
            y, aux = self.moe(self.norm2(x))
            return x + y, aux

    class MoETransformerLM(gluon.HybridBlock):
        def __init__(self, vocab, d_model, n_layers, n_heads, n_experts,
                     d_hidden, top_k=1, **kw):
            super().__init__(**kw)
            self.embed = gluon.nn.Embedding(vocab, d_model)
            self.layers = []
            for i in range(n_layers):
                layer = MoEDecoderLayer(d_model, n_heads, n_experts,
                                        d_hidden, top_k=top_k)
                setattr(self, f"layer{i}", layer)
                self.layers.append(layer)
            self.head = gluon.nn.Dense(vocab, flatten=False)

        def hybrid_forward(self, F, tokens):
            x = self.embed(tokens)
            aux_total = None
            for layer in self.layers:
                x, aux = layer(x)
                aux_total = aux if aux_total is None else aux_total + aux
            return self.head(x), aux_total

    return MoETransformerLM


def moe_lm(mx, ctx, layers, top_k=1, seed=37):
    """Switch-Base-8's widths at ``layers`` layers on ``ctx``, Xavier
    weights from ``seed``, the deferred shapes finished by a forward."""
    import numpy as np

    mx.random.seed(seed)
    net = moe_lm_classes(mx)(MOE_VOCAB, MOE_D, layers, MOE_HEADS,
                             MOE_EXPERTS, MOE_FF, top_k=top_k)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.array(np.zeros((1, 8), np.float32), ctx=ctx))
    return net


def moe_lm_batch(rng, bs, seq_len):
    """The example's ``synthetic_batch``: arithmetic sequences mod the
    vocabulary."""
    import numpy as np

    start = rng.randint(0, MOE_VOCAB, (bs, 1))
    step = rng.randint(1, 5, (bs, 1))
    toks = (start + step * np.arange(seq_len + 1)[None, :]) % MOE_VOCAB
    return toks[:, :-1].astype(np.float32), toks[:, 1:].astype(np.float32)


class MoELoss:
    """The example's objective on tensors: the mean cross-entropy plus
    ``MOE_AUX`` times the summed aux loss."""

    def __init__(self, mx):
        self.sce = mx.gluon.loss.SoftmaxCrossEntropyLoss(axis=-1)

    def __call__(self, out, label):
        logits, aux = out
        return self.sce(logits, label).mean() + MOE_AUX * aux.sum()


def moe_step(mx, net, trainer, x, y):
    """One example step through ``gluon.Trainer``; returns the loss."""
    loss_fn = MoELoss(mx)
    with mx.autograd.record():
        out = net(x)
        loss = mx.nd.NDArray(loss_fn((out[0].data, out[1].data), y.data))
    loss.backward()
    trainer.step(1)
    return float(loss.asnumpy())


def moe_inputs(net):
    """Pre-hooks that keep each MoE layer's input, in layer order: returns
    ``(inputs, detach)``."""
    inputs, handles = [], []
    for layer in net.layers:
        handles.append(layer.moe.register_forward_pre_hook(
            lambda blk, args: inputs.append(args[0].detach())))
    return inputs, lambda: [h.detach() for h in handles]


class EinsumTimer:
    """``torch`` as ``parallel.moe`` sees it, with each ``einsum`` timed
    by CUDA events by its spec (the dispatch, the two expert products and
    the combine)."""

    def __init__(self, torch):
        self._torch = torch
        self.events = []

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def einsum(self, spec, *ops):
        t = self._torch
        a, b = t.cuda.Event(enable_timing=True), \
            t.cuda.Event(enable_timing=True)
        a.record()
        out = t.einsum(spec, *ops)
        b.record()
        self.events.append((spec, a, b))
        return out

    def totals(self):
        self._torch.cuda.synchronize()
        out = {}
        for spec, a, b in self.events:
            out[spec] = out.get(spec, 0.0) + a.elapsed_time(b)
        return out


def moe_card_vs_cpu(mx, card):
    """Phase 37's cross-device checks at 2 layers, full width, batch
    ``MOE_CHECK_BATCH`` x ``MOE_CHECK_SEQ``: the first step's loss and the
    gradients of layer 0's router, w1 and w2 (top-1), one top-2 forward,
    and both routings; returns ``(checks, facts)``."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.parallel import moe as tmoe

    x, y = moe_lm_batch(np.random.RandomState(371), MOE_CHECK_BATCH,
                        MOE_CHECK_SEQ)
    cpu_net = moe_lm(mx, mx.cpu(), 2)
    weights = {k: p.data().detach().numpy().copy() for k, p in
               cpu_net._collect_params_with_prefix().items()}
    got, checks, facts = {}, {}, {}
    keys = ("layer0.moe.router_weight", "layer0.moe.w1", "layer0.moe.w2")
    for top_k in (1, 2):
        for name, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
            net = cpu_net if (name, top_k) == ("cpu", 1) else \
                moe_lm(mx, ctx, 2, top_k=top_k)
            mx.load_numpy_params(net, weights)
            params = net._collect_params_with_prefix()
            inputs, detach = moe_inputs(net)
            xa, ya = (mx.nd.array(a, ctx=ctx) for a in (x, y))
            if top_k == 1:
                with mx.autograd.record():
                    out = net(xa)
                    loss = MoELoss(mx)((out[0].data, out[1].data), ya.data)
                loss.backward()
                res = [loss.detach().reshape(1)] + [params[k].grad().clone()
                                                    for k in keys]
            else:
                with mx.autograd.pause():
                    out = net(xa)
                res = [out[0].data, out[1].data]
            detach()
            r = tmoe.route(inputs[0].reshape(-1, MOE_D),
                           params["layer0.moe.router_weight"].data().detach(),
                           MOE_CF, top_k)
            got[(name, top_k)] = ([t.detach().float().cpu() for t in res],
                                  r["expert_k"].cpu(), r["keep_k"].cpu(),
                                  r["probs"].detach().cpu())
            if name == "card":
                del net
                torch.cuda.empty_cache()
    for top_k in (1, 2):
        (cv, ce, ck, cp), (gv, ge, gk, _) = got[("cpu", top_k)], \
            got[("card", top_k)]
        errs = [float((g - c).abs().max() / max(float(c.abs().max()),
                                                1e-12))
                for g, c in zip(gv, cv)]
        top2 = cp.topk(2, dim=-1).values
        ties = (top2[:, 0] - top2[:, 1]) < MOE_TIE_GAP
        routed = (ge != ce).any(-1) | (gk != ck).any(-1)
        checks[f"card_vs_cpu_top{top_k}"] = max(errs) <= MOE_TOL
        checks[f"routing_top{top_k}"] = bool((~routed | ties).all())
        facts[f"top{top_k}"] = {
            "rel_errs": errs, "tokens": int(ce.shape[0]),
            "routing_differs": int(routed.sum()),
            "near_ties": int(ties.sum())}
    return checks, facts


def train_moe_lm(mx, card):
    """Phase 37: the MoE LM at Switch-Base-8's widths (``MOE_LAYERS``
    layers) on gpu(0), ``MOE_STEPS`` Adam steps through ``gluon.Trainer``
    on the example's batches, then the cross-device checks.  Returns the
    flash launches of the timed steps."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.parallel import moe as tmoe

    gpu = mx.gpu(0)
    rng = np.random.RandomState(37)
    data = [tuple(mx.nd.array(a, ctx=gpu) for a in
                  moe_lm_batch(rng, MOE_BATCH, MOE_SEQ))
            for _ in range(MOE_STEPS)]
    t0 = time.perf_counter()
    net = moe_lm(mx, gpu, MOE_LAYERS)
    build_s = time.perf_counter() - t0
    params = net._collect_params_with_prefix()
    start = {k: p.data().detach().clone() for k, p in params.items()}
    n_params = sum(p.numel() for p in start.values())
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": MOE_LR})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    plain0 = fa.counts.plain_calls_on_cuda
    losses, step_ms = [], []
    for x, y in data:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(moe_step(mx, net, trainer, x, y))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: c.launches for name, c in kernels.KERNEL_COUNTS.items()
                if name.startswith("flash_attention")}
    plain = fa.counts.plain_calls_on_cuda - plain0
    peak = torch.cuda.max_memory_allocated()
    not_finite = [k for k, p in params.items()
                  if not bool(torch.isfinite(p.data()).all())]
    unchanged = [k for k, p in params.items()
                 if torch.equal(p.data().detach(), start[k])]
    del start
    # one instrumented forward: each layer's kept share and the einsums
    timer = EinsumTimer(torch)
    inputs, detach = moe_inputs(net)
    tmoe.torch = timer
    try:
        with mx.autograd.pause():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net(data[0][0])
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tmoe.torch = torch
        detach()
    ein = timer.totals()
    dropped = []
    for layer, xin in zip(net.layers, inputs):
        r = tmoe.route(xin.reshape(-1, MOE_D),
                       layer.moe.router_weight.data().detach(), MOE_CF, 1)
        dropped.append(round(1.0 - float(r["keep_k"].float().mean()), 4))
    del net, trainer, data, inputs
    torch.cuda.empty_cache()
    checks = {
        "losses_finite": all(np.isfinite(losses)),
        "params_finite": not not_finite,
        "params_changed": not unchanged,
        "launches": all(n == MOE_LAYERS * MOE_STEPS
                        for n in launches.values()) and len(launches) == 3,
        "plain_calls_on_cuda": plain == 0,
    }
    more, facts = moe_card_vs_cpu(mx, card)
    checks.update(more)
    med = statistics.median(step_ms[1:])
    tokens = MOE_BATCH * MOE_SEQ
    dispatch = ein.get("sec,sm->ecm", 0.0) + ein.get("sec,ecm->sm", 0.0)
    experts = ein.get("ecm,emh->ech", 0.0) + ein.get("ech,ehm->ecm", 0.0)
    log(f"moe 37: MoE LM at Switch-Base-8's widths (d_model {MOE_D}, "
        f"{MOE_HEADS} heads, FFN {MOE_FF}, {MOE_EXPERTS} experts top-1, "
        f"capacity {MOE_CF}, vocabulary {MOE_VOCAB}) x {MOE_LAYERS} layers "
        f"({n_params} parameters, built in {build_s:.1f} s), batch "
        f"{MOE_BATCH} x {MOE_SEQ}, fp32 TF32 off, Adam lr {MOE_LR} through "
        f"gluon.Trainer, {MOE_STEPS} steps: losses {losses}; step ms "
        f"{[round(v, 3) for v in step_ms]}, median {med:.3f} ms, "
        f"{tokens / med * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; flash launches {launches} "
        f"({MOE_LAYERS * MOE_STEPS} each), plain calls {plain}; on {card}")
    log(f"moe 37: one instrumented forward ({fwd_ms:.3f} ms host): "
        f"dispatch + combine einsums {dispatch:.3f} ms, the experts' two "
        f"products {experts:.3f} ms (CUDA events, by spec: "
        f"{ {k: round(v, 3) for k, v in ein.items()} }); tokens dropped a "
        f"layer (top-1, over capacity): {dropped}")
    log(f"moe 37: card vs CPU at 2 layers, batch {MOE_CHECK_BATCH} x "
        f"{MOE_CHECK_SEQ} (the first step's loss and layer 0's router, w1 "
        f"and w2 gradients; one top-2 forward's logits and aux): "
        f"{facts}; tolerance {MOE_TOL} of each largest value, routing "
        f"equal but for near ties (top two within {MOE_TIE_GAP})")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"moe 37 checks failed: {failed} (unchanged "
                         f"{unchanged[:5]}, not finite {not_finite[:5]})")
    return {"moe_lm_train": launches}


def mesh_moe_reference(mx, d):
    """Phase 38's inputs and its one-process reference: the 4-layer LM's
    weights and a batch into ``d``, then ``MOE_EP_STEPS`` steps of
    ``DataParallelTrainer`` on gpu(0) alone."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.parallel import DataParallelTrainer

    gpu = mx.gpu(0)
    net = moe_lm(mx, gpu, MOE_EP_LAYERS, seed=38)
    net.save_parameters(str(d / "moe-start.params"))
    x, y = moe_lm_batch(np.random.RandomState(38), MOE_BATCH, MOE_SEQ)
    np.savez(d / "moe-batch.npz", x, y)
    tr = DataParallelTrainer(net, MoELoss(mx), "adam",
                             {"learning_rate": MOE_LR}, capture=False)
    losses = [float(tr.step(x, y).asnumpy()) for _ in range(MOE_EP_STEPS)]
    del tr, net
    torch.cuda.empty_cache()
    return losses


def mesh_worker_moe(mx, ctx, workdir, out):
    """Phase 38 on one rank: the 4-layer LM from DIR/moe-start.params over
    ``make_mesh({"ep": 2})``, ``gluon_moe_param_spec_fn`` splitting the
    experts, ``MOE_EP_STEPS`` Adam steps on DIR/moe-batch.npz."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    from mxnet_tpu_torch.parallel import mesh as mesh_mod
    from mxnet_tpu_torch.parallel.moe import gluon_moe_param_spec_fn

    npz = np.load(workdir / "moe-batch.npz")
    x, y = npz["arr_0"], npz["arr_1"]
    net = moe_lm(mx, ctx, MOE_EP_LAYERS, seed=38)
    net.load_parameters(str(workdir / "moe-start.params"), ctx=ctx)
    mesh = mesh_mod.make_mesh({"ep": 2})
    tr = DataParallelTrainer(net, MoELoss(mx), "adam",
                             {"learning_rate": MOE_LR}, mesh=mesh,
                             param_spec_fn=gluon_moe_param_spec_fn(mesh))
    tr.build(x)
    experts = [i for i, (n, _) in enumerate(tr._named)
               if "moeffn" in n and "router" not in n]
    rec = {
        "mesh": mesh.shape, "experts": len(experts),
        "experts_halved": all(
            2 * tr._params[i].numel() == int(np.prod(tr._full_shapes[i]))
            and tr._local[i] for i in experts),
        "expert_states_halved": all(
            all(2 * t.numel() == int(np.prod(tr._full_shapes[i]))
                for t in tr._states[i]) for i in experts),
        "others_whole": all(
            tuple(tr._params[i].shape) == tr._full_shapes[i]
            for i in range(len(tr._params)) if i not in experts),
        "steps": []}
    replicated = [p for i, p in enumerate(tr._params) if i not in experts]
    kernels.reset_counts()
    for _ in range(MOE_EP_STEPS):
        st = mesh_step_record(lambda: tr.step(x, y), mesh_mod)
        st["digest"] = digest(replicated)
        st["finite"] = all(bool(torch.isfinite(p).all()) for p in tr._params)
        rec["steps"].append(st)
    out["moe"] = rec
    del tr, net
    torch.cuda.empty_cache()


def train_mesh_moe(mx, card, ranks, ref_losses):
    """Phase 38's gates on the ranks' records; returns the launches by
    path."""
    from mxnet_tpu_torch.parallel import dist

    want = dist.choose_backend(2)
    r0 = ranks[0]["moe"]
    per = [{k: v.get("launches", 0) for k, v in s["launches"].items()
            if k.startswith("flash_attention")} for s in r0["steps"]]
    losses = [s["loss"] for s in r0["steps"]]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    checks = {
        "ep_backend": all(r["backend"] == want for r in ranks),
        "ep_mesh": all(r["moe"]["mesh"] == {"ep": 2} for r in ranks),
        "ep_losses_and_replicated_bit_identical": all(
            [(s["loss"], s["digest"]) for s in r["moe"]["steps"]]
            == [(s["loss"], s["digest"]) for s in r0["steps"]]
            for r in ranks),
        "ep_experts_and_states_halved": all(
            r["moe"]["experts_halved"] and r["moe"]["expert_states_halved"]
            and r["moe"]["others_whole"]
            and r["moe"]["experts"] == 4 * MOE_EP_LAYERS for r in ranks),
        "ep_no_expert_gathered": all(
            s["comm"]["param"]["calls"] == 0 for r in ranks
            for s in r["moe"]["steps"]),
        "ep_finite": all(s["finite"] for r in ranks
                         for s in r["moe"]["steps"]),
        "ep_vs_one_process": err <= MOE_EP_RTOL,
        "ep_launches": all(len(p) == 3 and all(
            n == MOE_EP_LAYERS for n in p.values()) for p in per),
    }
    comm = [{k: s["comm"]["ep"][k] for k in ("calls", "bytes", "ms")}
            for s in r0["steps"]]
    log(f"moe 38: the LM at Switch-Base-8's widths x {MOE_EP_LAYERS} "
        f"layers (depth cut from 12) over {{ep:2}} (2 {want} ranks on "
        f"{', '.join(r['device'] for r in ranks)}), DataParallelTrainer "
        f"with gluon_moe_param_spec_fn, batch {MOE_BATCH} x {MOE_SEQ} on "
        f"each, {MOE_EP_STEPS} Adam steps: losses {losses} vs one process "
        f"{ref_losses} (max rel err {err:.3g}, rtol {MOE_EP_RTOL}); step ms "
        f"{[round(s['ms'], 1) for s in r0['steps']]}; the ep collectives a "
        f"step (rank 0): {comm}; flash launches a step {per[-1]}; on "
        f"{card}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"moe 38 checks failed: {failed}")
    return {"moe_ep_train": {k: sum(sum(
        s["launches"].get(k, {}).get("launches", 0)
        for s in r["moe"]["steps"]) for r in ranks)
        for k in per[-1]}}


# -- phases 39-40: dist_async over a parameter server, the elastic resize ----


def proc_cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode()
    except OSError:
        return ""


def card_files(pid):
    """The NVIDIA device files process ``pid`` holds open."""
    out = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                out.append(target)
    except OSError:
        pass
    return sorted(set(out))


def async_worker(mx, ctx, rank, workdir, out):
    """Phase 39 on one rank: BERT-base from DIR/start.params, its half of
    DIR/batch.npz, ``ASYNC_STEPS`` Adam steps through
    ``Trainer(kvstore='dist_async')`` and the launcher's server; after a
    final barrier every key pulled from the server."""
    import hashlib

    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import dist, ps

    npz = np.load(workdir / "batch.npz")
    data = [npz[f"arr_{i}"] for i in range(len(npz.files))]
    batch = dist_halves(mx, data, ctx, DIST_RANKS)[rank]
    net = pretrain_net(mx, ctx, dropout=0.0)
    net.load_parameters(str(workdir / "start.params"), ctx=ctx)
    params = net._collect_params_with_prefix()
    start = {k: p.data().detach().clone() for k, p in params.items()}
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(DIST_ADAM),
                               kvstore="dist_async")
    moved = {"push": [0.0, 0], "pull": [0.0, 0]}
    wrapped = {}
    for op in ("push", "pull"):
        orig = getattr(ps.PSClient, op)

        def timed(self, key, *arr, _op=op, _orig=orig):
            t0 = time.perf_counter()
            got = _orig(self, key, *arr)
            moved[_op][0] += time.perf_counter() - t0
            nbytes = arr[0].nbytes if arr else got.nbytes
            moved[_op][1] += int(nbytes)
            return got

        wrapped[op] = orig
        setattr(ps.PSClient, op, timed)
    allreduces = []
    allreduce = dist.allreduce
    dist.allreduce = lambda v: allreduces.append(1) or allreduce(v)
    rec = {"steps": []}
    kernels.reset_counts()
    try:
        for _ in range(ASYNC_STEPS):
            for v in moved.values():
                v[:] = [0.0, 0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mx.autograd.record():
                loss = net(*batch)
            loss.backward()
            trainer.step(DIST_RANKS)
            torch.cuda.synchronize()
            rec["steps"].append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "loss": float(loss.asnumpy()),
                **{f"{op}_{k}": moved[op][j] for op in moved
                   for j, k in enumerate(("s", "bytes"))}})
        kv = trainer._kvstore
        rec["is_async"] = kv._is_async()
        kv.barrier()
        for i, p in enumerate(trainer._params):
            kv.pull(i, out=p.list_data())
        torch.cuda.synchronize()
    finally:
        for op, orig in wrapped.items():
            setattr(ps.PSClient, op, orig)
        dist.allreduce = allreduce
    h = hashlib.sha256()
    for p in params.values():
        h.update(p.data().detach().cpu().numpy().tobytes())
    rec.update({
        "digest": h.hexdigest(), "allreduces": len(allreduces),
        "launches": {name: c.launches for name, c in
                     kernels.KERNEL_COUNTS.items()
                     if name.startswith("flash_attention")},
        "not_finite": [k for k, p in params.items()
                       if not bool(torch.isfinite(p.data()).all())],
        "unchanged": [k for k, p in params.items() if p.grad_req != "null"
                      and torch.equal(p.data().detach(), start[k])]})
    if rank == 0:
        # a process that made a CUDA context holds the card's device files
        # open (importing torch maps the driver library, opens none): the
        # server's, and this worker's as the control
        rec["server_card_files"] = [
            card_files(pid) for pid in os.listdir("/proc")
            if pid.isdigit() and "mxnet_tpu_torch.kvstore_server"
            in proc_cmdline(pid) and "launch" not in proc_cmdline(pid)]
        rec["worker_card_files"] = card_files(os.getpid())
    kv.barrier()
    if rank == 0:
        kv._ps_client().stop_server()
    out["async"] = rec
    del trainer, net
    torch.cuda.empty_cache()


def elastic_worker(mx, ctx, rank, workdir, out):
    """Phase 40 on one rank: BERT-base from DIR/start.params through
    ``Trainer(kvstore='dist_sync')`` inside ``Supervisor(elastic=True,
    manager=CheckpointManager(DIR/elastic-ck))``, steps 1 to
    ``ELASTIC_STEPS`` on the rank's rows of DIR/batch.npz, saving after
    ``ELASTIC_SAVE_AT``; rank 1 leaves at ``ELASTIC_DIE_AT`` with
    ``os._exit(ELASTIC_LEAVE_CODE)`` after writing its record."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import resilience
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.resilience import supervisor as sup_mod

    npz = np.load(workdir / "batch.npz")
    data = [npz[f"arr_{i}"] for i in range(len(npz.files))]
    marks = {"classified": [], "shrink": [], "reinit": [], "restore": [],
             "steps": []}
    classify, shrink, reinit = sup_mod.classify, dist.shrink, dist.reinit

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.time()
            got = fn(*a, **kw)
            marks[key].append((t0, time.time()))
            return got
        return run

    def classify_marked(exc):
        kind = classify(exc)
        marks["classified"].append((time.time(), kind, str(exc)[:300]))
        return kind

    sup_mod.classify = classify_marked
    kernels.reset_counts()
    dist.shrink = timed(shrink, "shrink")
    dist.reinit = timed(reinit, "reinit")
    mgr = mx.checkpoint.CheckpointManager(str(workdir / "elastic-ck"),
                                          keep_n=2)
    sup = resilience.Supervisor(mgr, on_preemption="resume", elastic=True,
                                rendezvous_timeout=ELASTIC_RDV_S)

    def train(run):
        world, me = run.world, dist.rank()
        net = pretrain_net(mx, ctx, dropout=0.0)
        net.load_parameters(str(workdir / "start.params"), ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   dict(DIST_ADAM), kvstore="dist_sync")
        first = 1
        if run.manager.latest() is not None:
            t0 = time.time()
            first = run.manager.restore(params=net,
                                        trainer=trainer)["step"] + 1
            torch.cuda.synchronize()
            marks["restore"].append((t0, time.time()))
        rows = dist_halves(mx, data, ctx, world)[me]
        for step in range(first, ELASTIC_STEPS + 1):
            if rank == 1 and step == ELASTIC_DIE_AT:
                out["elastic"] = {"left_at": step,
                                  "code": ELASTIC_LEAVE_CODE,
                                  "t": time.time(), "marks": marks}
                with open(workdir / "elastic-rank1.json", "w") as f:
                    json.dump(out, f)
                os._exit(ELASTIC_LEAVE_CODE)
            t0 = time.time()
            with mx.autograd.record():
                loss = net(*rows)
            loss.backward()
            trainer.step(world)
            torch.cuda.synchronize()
            marks["steps"].append((step, world, float(loss.asnumpy()), t0,
                                   time.time()))
            run.step_done(step, save=dict(params=net, trainer=trainer,
                                          sync=True)
                          if step == ELASTIC_SAVE_AT else None)
        return {k: p.data().detach().cpu().numpy() for k, p in
                net._collect_params_with_prefix().items()}

    try:
        final = sup.run(train)
    finally:
        sup_mod.classify, dist.shrink, dist.reinit = classify, shrink, reinit
    np.savez(workdir / "elastic-params.npz", **final)
    out["elastic"] = {"marks": marks, "world": sup._world,
                      "launches": {name: c.launches for name, c in
                                   kernels.KERNEL_COUNTS.items()
                                   if name.startswith("flash_attention")},
                      "resizes": sup._resizes,
                      "dead_ranks": sup._dead_ranks,
                      "num_workers": dist.num_workers(),
                      "stats": resilience.resilience_stats()}


def elastic_reference(mx, d, data):
    """One process on gpu(0) restored from phase 40's checkpoint, the
    steps after it on the whole batch; returns ``(losses, params)``."""
    import torch

    gpu = mx.gpu(0)
    net = pretrain_net(mx, gpu, dropout=0.0)
    net.load_parameters(str(d / "start.params"), ctx=gpu)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", dict(DIST_ADAM),
                               kvstore="dist_sync")
    meta = mx.checkpoint.CheckpointManager(str(d / "elastic-ck"),
                                           keep_n=2).restore(
        params=net, trainer=trainer)
    batch = dist_halves(mx, data, gpu, 1)[0]
    losses = []
    for step in range(meta["step"] + 1, ELASTIC_STEPS + 1):
        with mx.autograd.record():
            loss = net(*batch)
        loss.backward()
        trainer.step(1)
        losses.append((step, float(loss.asnumpy())))
    params = {k: p.data().detach().cpu().numpy() for k, p in
              net._collect_params_with_prefix().items()}
    del net, trainer
    torch.cuda.empty_cache()
    return meta["step"], losses, params


def async_elastic(mx, card, d, data, text, returncode):
    """Phases 39 and 40's gates on the records phase 20's launch left in
    ``d`` (its output ``text``, its exit code) and the one-process
    reference restored from phase 40's checkpoint.  Returns the launches
    by path."""
    import numpy as np

    from mxnet_tpu_torch.parallel import dist

    want = dist.choose_backend(DIST_RANKS)
    tail = text.strip().splitlines()
    log("async+elastic 39-40: the launch's lines about the server and the "
        "resize:\n  " + "\n  ".join(
            [ln for ln in tail if "kvstore_server" in ln
             or "launch: server" in ln or "resize" in ln
             or "peer death" in ln][:6]))
    ranks = [json.loads((d / f"elastic-rank{r}.json").read_text())
             for r in range(DIST_RANKS)]
    saved, ref_losses, ref_params = elastic_reference(mx, d, data)
    got_params = np.load(d / "elastic-params.npz")
    params_diff = {k: float(np.abs(got_params[k] - v).max())
                   for k, v in ref_params.items()
                   if not np.array_equal(got_params[k], v)}
    a0, a1 = ranks[0]["async"], ranks[1]["async"]
    e0, e1 = ranks[0]["elastic"], ranks[1]["elastic"]
    per_rank = 12 * ASYNC_STEPS
    server_code = [int(ln.rsplit(" ", 1)[1]) for ln in tail
                   if ln.startswith("launch: server 0 exited with")]
    checks = {
        "backend": all(r["backend"] == want for r in ranks),
        "async_transport": a0["is_async"] and a1["is_async"],
        "async_server_off_the_card": (
            "CUDA initialized in this process: False" in text
            and a0["server_card_files"] == [[]]
            and bool(a0["worker_card_files"])),
        "async_pulls_bit_identical": a0["digest"] == a1["digest"],
        "async_finite": not (a0["not_finite"] or a1["not_finite"]),
        "async_changed": not (a0["unchanged"] or a1["unchanged"]),
        "async_no_allreduce": a0["allreduces"] == a1["allreduces"] == 0,
        "async_server_exit": server_code in ([0], [-15]),
        "async_launches": all(n == per_rank for a in (a0, a1)
                              for n in a["launches"].values()),
        "elastic_resized": (e0["resizes"], e0["world"], e0["dead_ranks"],
                            e0["num_workers"]) == (1, 1, [1], 1),
        "elastic_rank1_left": (e1["left_at"], e1["code"])
        == (ELASTIC_DIE_AT, ELASTIC_LEAVE_CODE) and returncode == 0,
        "elastic_peer_death": [c[1] for c in e0["marks"]["classified"]]
        == ["peer_death"],
        "elastic_saved_at": saved == ELASTIC_SAVE_AT,
    }
    resumed = [(s, loss) for s, w, loss, _, _ in e0["marks"]["steps"]
               if w == 1]
    checks["elastic_resumed_steps"] = [s for s, _ in resumed] == list(
        range(ELASTIC_SAVE_AT + 1, ELASTIC_STEPS + 1))
    err = max(abs(a - b) / abs(b) for (_, a), (_, b) in
              zip(resumed, ref_losses))
    checks["elastic_vs_one_process"] = err <= DIST_LOSS_RTOL
    bit_same = resumed == ref_losses and not params_diff
    # the failure to the first resumed step, by part
    t_left = e1["t"]
    t_seen = e0["marks"]["classified"][0][0]
    (s0, s1), = e0["marks"]["shrink"]
    (r0, r1), = e0["marks"]["reinit"]
    (f0, f1), = e0["marks"]["restore"]
    first = next(s for s in e0["marks"]["steps"] if s[1] == 1)
    split = {"detection": t_seen - t_left, "rendezvous": r0 - s0,
             "reinit": r1 - r0, "restore": f1 - f0,
             "to_first_resumed_step_end": first[4] - t_left}
    push = [(s["push_s"], s["push_bytes"]) for s in a0["steps"]]
    pull = [(s["pull_s"], s["pull_bytes"]) for s in a0["steps"]]
    log(f"async 39: BERT-base MLM+NSP fp32 dropout 0 Adam, {DIST_RANKS} "
        f"ranks ({want}) and 1 server process, kvstore='dist_async', "
        f"{ASYNC_STEPS} steps of {DIST_BATCH // DIST_RANKS} x {DIST_SEQ} a "
        f"rank: losses rank 0 {[round(s['loss'], 5) for s in a0['steps']]}, "
        f"rank 1 {[round(s['loss'], 5) for s in a1['steps']]}; step ms "
        f"{[round(s['ms'], 1) for s in a0['steps']]}; a step's push "
        f"{[(round(t, 3), b, round(b / t / 1e9, 3)) for t, b in push]} and "
        f"pull {[(round(t, 3), b, round(b / t / 1e9, 3)) for t, b in pull]}"
        f" (s, bytes, GB/s; rank 0); pulls after the final barrier "
        f"bit-identical across ranks: {a0['digest'] == a1['digest']}; "
        f"server exit {server_code}, its open NVIDIA device files "
        f"{a0['server_card_files']} (rank 0's: "
        f"{a0['worker_card_files']}); synchronous all-reduces "
        f"{a0['allreduces'] + a1['allreduces']}; on {card}")
    log(f"elastic 40: BERT-base under Supervisor(elastic=True), "
        f"kvstore='dist_sync', 2 ranks, saved after step "
        f"{ELASTIC_SAVE_AT}, rank 1 left at step {e1['left_at']} "
        f"(os._exit({e1['code']})); rank 0 classified "
        f"{[c[1] for c in e0['marks']['classified']]} "
        f"({e0['marks']['classified'][0][2][:120]!r}), resized to world "
        f"{e0['world']} (dead ranks {e0['dead_ranks']}), resumed steps "
        f"{resumed} vs one process restored from step {saved} "
        f"{ref_losses}: max rel err {err:.3g} (rtol {DIST_LOSS_RTOL}), "
        f"bit-identical (losses and parameters): {bit_same} (parameters "
        f"that differ, max abs: {dict(list(params_diff.items())[:4])}, "
        f"{len(params_diff)} in all); seconds from "
        f"the failure: { {k: round(v, 3) for k, v in split.items()} }; on "
        f"{card}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"async+elastic checks failed: {failed}")
    return {"async_bert_train": {k: a0["launches"][k] + a1["launches"][k]
                                 for k in a0["launches"]},
            "elastic_bert_train": e0["launches"]}


def nd_encoder_layer(mx, x, w, num_heads):
    """A BERT encoder layer written in ``mx.nd`` calls on NDArrays: the
    fused attention, residual ``+``, LayerNorm, the FFN's products and
    GELU (``w``: the layer's parameters by name)."""
    nd = mx.nd
    att = nd.multihead_attention(x, x, x, w["attn_in_weight"],
                                 w["attn_in_bias"], w["attn_out_weight"],
                                 w["attn_out_bias"], num_heads=num_heads)
    h = nd.LayerNorm(x + att, w["attn_ln.gamma"], w["attn_ln.beta"],
                     axis=-1, eps=1e-5)
    f = nd.FullyConnected(h, w["ffn1.weight"], w["ffn1.bias"],
                          num_hidden=w["ffn1.weight"].shape[0], flatten=False)
    f = nd.FullyConnected(nd.LeakyReLU(f, act_type="gelu"), w["ffn2.weight"],
                          w["ffn2.bias"], num_hidden=w["ffn2.weight"].shape[0],
                          flatten=False)
    return nd.LayerNorm(h + f, w["ffn_ln.gamma"], w["ffn_ln.beta"], axis=-1,
                        eps=1e-5)


def nd_mlp(mx, ctx, x, y, w1, w2, steps, lr):
    """The MLP trained in NDArray arithmetic: ``steps`` steps of
    ``w[:] = w - lr * w.grad`` from the weights ``w1``, ``w2`` (NDArrays,
    or numpy values for ``ctx``).  Returns the losses, the step times (ms),
    the final accuracy, and whether each weight kept its tensor, its
    address and its variable status after every update."""
    import torch

    from mxnet_tpu_torch import autograd as ag

    nd = mx.nd
    W = [w if isinstance(w, nd.NDArray) else nd.array(w, ctx=ctx)
         for w in (w1, w2)]
    for w in W:
        w.attach_grad()
    kept = [(w.data, w.data.data_ptr()) for w in W]
    X, Y = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)
    losses, ms, same = [], [], True
    for _ in range(steps):
        t0 = time.perf_counter()
        with mx.autograd.record():
            out = nd.dot(nd.relu(nd.dot(X, W[0])), W[1])
            loss = -nd.pick(nd.log_softmax(out), Y).mean()
        loss.backward()
        for w in W:
            w[:] = w - lr * w.grad
        losses.append(loss.asscalar())
        ms.append((time.perf_counter() - t0) * 1e3)
        live = {id(t) for t in ag._live_variables()}
        same = same and all(
            w.data is t and w.data.data_ptr() == p and id(t) in live
            and t.requires_grad and t.is_leaf for w, (t, p) in zip(W, kept))
    acc = (nd.argmax(out, axis=1) == Y).mean().asscalar()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return losses, ms, acc, same


#: phase 41 (c): each sampler's call, its distribution's mean and variance
#: and the JAX package's dtype (tests/test_torch_random.py holds the port's
#: shapes and dtypes to the JAX package's on the CPU)
SAMPLER_CASES = [
    ("uniform", (-1.0, 3.0), {}, 1.0, 16 / 12, "float32"),
    ("normal", (0.5, 2.0), {}, 0.5, 4.0, "float32"),
    ("randn", (), {"loc": -1.0, "scale": 0.5}, -1.0, 0.25, "float32"),
    ("randint", (-3, 7), {}, 1.5, 99 / 12, "int32"),
    ("poisson", (3.5,), {}, 3.5, 3.5, "float32"),
    ("exponential", (2.0,), {}, 2.0, 4.0, "float32"),
    ("gamma", (2.5, 1.5), {}, 3.75, 5.625, "float32"),
    ("bernoulli", (0.3,), {}, 0.3, 0.21, "float32"),
]


def sampler_checks(mx, ctx, n):
    """Phase 41 (c): every ``mx.random`` sampler on ``ctx``: reseeding
    gives the same bits, the shape, dtype and context, and the mean and
    variance of ``n`` draws within 6 standard errors.  Returns
    ``{sampler: (mean, var, ok)}``."""
    import math

    import numpy as np

    def draw(name, args, kw, shape):
        fn = getattr(mx.random, name)
        if name == "randn":
            return fn(*shape, ctx=ctx, **kw)
        return fn(*args, shape=shape, ctx=ctx, **kw)

    out = {}
    for name, args, kw, mean, var, dtype in SAMPLER_CASES:
        small = draw(name, args, kw, (2, 3))
        mx.random.seed(41)
        a = draw(name, args, kw, (n,))
        mx.random.seed(41)
        b = draw(name, args, kw, (n,))
        v = a.asnumpy().astype(np.float64)
        m4 = ((v - v.mean()) ** 4).mean()
        ok = (bool((a.data == b.data).all()) and small.shape == (2, 3)
              and small.dtype == np.dtype(dtype) and small.context == ctx
              and abs(v.mean() - mean) < 6 * math.sqrt(var / n)
              and abs(v.var() - var) < 6 * math.sqrt((m4 - var ** 2) / n))
        out[name] = (round(float(v.mean()), 5), round(float(v.var()), 5),
                      bool(ok))
    p = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    probs = mx.nd.array(np.tile(p, (n // 64, 1)), ctx=ctx)
    mx.random.seed(41)
    s, lp = mx.random.multinomial(probs, shape=(64,), get_prob=True)
    mx.random.seed(41)
    s2 = mx.random.multinomial(probs, shape=(64,))
    freq = np.bincount(s.asnumpy().reshape(-1), minlength=4) / s.size
    want = np.log(p / p.sum())[s.asnumpy()]
    se = np.sqrt(p * (1 - p) / s.size)
    out["multinomial"] = (
        [round(float(f), 5) for f in freq], None, bool(
            (s.data == s2.data).all() and s.dtype == np.int32
            and s.shape == (n // 64, 64) and s.context == ctx
            and np.all(np.abs(freq - p) < 6 * se)
            and np.allclose(lp.asnumpy(), want, atol=1e-6)))
    rows = mx.nd.array(np.arange(n, dtype=np.float32), ctx=ctx)
    mx.random.seed(41)
    sh = mx.random.shuffle(rows)
    mx.random.seed(41)
    sh2 = mx.random.shuffle(rows)
    got = sh.asnumpy()
    out["shuffle"] = (None, None, bool(
        (sh.data == sh2.data).all() and sh.context == ctx
        and sh.dtype == np.float32
        and np.array_equal(np.sort(got), np.arange(n))
        and not np.array_equal(got, np.arange(n))))
    return out


def imperative_ndarray(mx, card):
    """Phase 41: the imperative NDArray on gpu(0), fp32 with TF32 off:
    (a) a BERT-base encoder layer in ``mx.nd`` calls against the block,
    with the flash kernels' launches; (b) the MLP trained in NDArray
    arithmetic, against the same loop on the CPU; (c) the samplers.
    Returns the flash launches of (a)."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.models.bert import BERTEncoderLayer
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    gpu = mx.gpu(0)
    nd = mx.nd
    mx.random.seed(41)
    layer = BERTEncoderLayer(IMP_UNITS, IMP_FFN, IMP_HEADS, dropout=0.0)
    layer.initialize(init=mx.init.Normal(0.02), ctx=gpu)
    params = layer._collect_params_with_prefix()
    rng = np.random.RandomState(41)
    xs = rng.randn(IMP_B, IMP_S, IMP_UNITS).astype(np.float32)
    cs = rng.uniform(0.5, 1.5, xs.shape).astype(np.float32)
    x, c = nd.array(xs, ctx=gpu), nd.array(cs, ctx=gpu)
    # the block's eager forward and backward: the reference
    with mx.autograd.record():
        ref = layer(x)
        (ref * c).sum().backward()
    ref_grads = {k: p.grad().detach().clone() for k, p in params.items()}
    w = {k: nd.array(p.data(), ctx=gpu) for k, p in params.items()}
    for v in w.values():
        v.attach_grad()
    torch.cuda.synchronize()
    kernels.reset_counts()
    plain0 = fa.counts.plain_calls_on_cuda
    t0 = time.perf_counter()
    with mx.autograd.record():
        out = nd_encoder_layer(mx, x, w, IMP_HEADS)
        loss = (out * c).sum()
    loss.backward()
    torch.cuda.synchronize()
    layer_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: cnt.launches
                for name, cnt in kernels.KERNEL_COUNTS.items()
                if name.startswith("flash_attention")}
    plain = fa.counts.plain_calls_on_cuda - plain0

    def gap(got, want):
        got, want = got.detach(), want.detach()
        return float((got - want).abs().max() / want.abs().max())
    gaps = {"out": gap(out.data, ref.data)}
    gaps.update({k: gap(v.grad.data, ref_grads[k]) for k, v in w.items()})
    results = [out, loss] + [v.grad for v in w.values()]
    checks = {
        "layer_within_tol": max(gaps.values()) <= IMP_TOL,
        "layer_launches": launches == {"flash_attention_fwd": 1,
                                       "flash_attention_bwd_dq": 1,
                                       "flash_attention_bwd_dkv": 1},
        "layer_no_plain_call": plain == 0,
        "layer_ndarrays_on_gpu0": all(isinstance(r, nd.NDArray)
                                      and r.context == gpu for r in results),
    }
    log(f"imperative 41a: BERT-base encoder layer in mx.nd calls (units "
        f"{IMP_UNITS}, {IMP_HEADS} heads, FFN {IMP_FFN}, b={IMP_B} x "
        f"s={IMP_S}, fp32, TF32 off), forward and backward in "
        f"{layer_ms:.3f} ms host (first call); gap to the block's eager "
        f"run, of each largest value: out {gaps['out']:.3e}, gradients max "
        f"{max(v for k, v in gaps.items() if k != 'out'):.3e} (limit "
        f"{IMP_TOL}); flash launches {launches}, plain calls {plain}")
    del layer, params, ref, ref_grads, w, out, loss, results
    torch.cuda.empty_cache()

    # (b) the MLP from its teacher's labels
    rng = np.random.RandomState(42)
    X = rng.randn(IMP_ROWS, IMP_UNITS).astype(np.float32)
    y = np.argmax(X @ rng.randn(IMP_UNITS, IMP_CLASSES), axis=1).astype(
        np.float32)
    mx.random.seed(42)
    W1 = nd.random.normal(scale=0.02, shape=(IMP_UNITS, IMP_FFN), ctx=gpu)
    W2 = nd.random.normal(scale=0.02, shape=(IMP_FFN, IMP_CLASSES), ctx=gpu)
    w0 = (W1.asnumpy(), W2.asnumpy())
    losses, ms, acc, kept = nd_mlp(mx, gpu, X, y, W1, W2, IMP_STEPS, IMP_LR)
    cpu_losses, _, _, _ = nd_mlp(mx, mx.cpu(), X, y, *w0, IMP_CPU_STEPS,
                                 IMP_LR)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    med = statistics.median(ms[1:])
    checks.update({
        "mlp_losses_finite": all(np.isfinite(losses)),
        "mlp_loss_falls": losses[-1] < losses[0],
        "mlp_matches_cpu": max(rel) <= IMP_CPU_RTOL,
        "mlp_weights_kept": kept,
        "mlp_accuracy_float": type(acc) is float,
    })
    log(f"imperative 41b: MLP {IMP_UNITS}-{IMP_FFN}-{IMP_CLASSES} on "
        f"{IMP_ROWS} rows (weights from nd.random.normal(scale=0.02) on "
        f"gpu(0)), {IMP_STEPS} steps of w[:] = w - {IMP_LR} * w.grad: losses "
        f"{[round(v, 6) for v in losses]}; accuracy {acc}; step median "
        f"{med:.3f} ms (host, synchronised by asscalar); the first "
        f"{IMP_CPU_STEPS} against cpu(): relative gaps "
        f"{[f'{v:.2e}' for v in rel]} (limit {IMP_CPU_RTOL}); each weight "
        f"kept its tensor, address and variable status: {kept}; on {card}")

    # (c) the samplers
    samplers = sampler_checks(mx, gpu, IMP_DRAWS)
    checks["samplers"] = all(ok for _, _, ok in samplers.values())
    log(f"imperative 41c: the 10 samplers on gpu(0), {IMP_DRAWS} draws each "
        f"(mean, variance, ok): {samplers}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"imperative 41 checks failed: {failed} (gaps "
                         f"{gaps}, launches {launches}, samplers {samplers})")
    return {"imperative_nd": launches}


# -- phase 42: the Gluon basics ---------------------------------------------

# 5x3 dot-matrix glyphs of the digits, examples/ocr/train_crnn_ctc.py's
GLYPHS = {
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


def render_batch(rng, bs, seq_len, jitter=0.15):
    """The example's digit strips: ``(bs, 1, 8, 4*seq_len+4)`` images and
    ``(bs, seq_len)`` labels 1..10 (0 is kept for the blank), drawn from
    the numpy ``rng`` in the example's order (copied from
    examples/ocr/train_crnn_ctc.py)."""
    import numpy as np

    W = 4 * seq_len + 4
    imgs = np.zeros((bs, 1, 8, W), np.float32)
    labels = np.zeros((bs, seq_len), np.float32)
    for i in range(bs):
        digits = rng.randint(0, 10, seq_len)
        labels[i] = digits + 1
        x = 2 + rng.randint(0, 2)
        for d in digits:
            y = 1 + rng.randint(0, 2)
            for r, row in enumerate(GLYPHS[int(d)]):
                for c, bit in enumerate(row):
                    if bit == "1":
                        imgs[i, 0, y + r, x + c] = 1.0
            x += 4
    imgs += rng.randn(*imgs.shape).astype(np.float32) * jitter
    return imgs, labels


def greedy_decode(logits, blank):
    """``(T, N, C)`` logits -> each row's labels: the argmax a step, repeats
    collapsed, the blank dropped (the example's)."""
    ids = logits.argmax(-1)
    out = []
    for n in range(ids.shape[1]):
        prev, s = -1, []
        for t in ids[:, n]:
            if t != prev and t != blank:
                s.append(int(t))
            prev = t
        out.append(s)
    return out


def crnn_net(mx):
    """The example's ``CRNN`` over the port's gluon: conv feature
    extractor, the columns as time steps, a bidirectional LSTM, a Dense
    head a step; ``(N, 1, 8, W)`` -> ``(T=W, N, classes)``."""
    gluon = mx.gluon

    class CRNN(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.conv = gluon.nn.HybridSequential()
            self.conv.add(
                gluon.nn.Conv2D(16, 3, padding=1, activation="relu"),
                gluon.nn.MaxPool2D(pool_size=(2, 1)),
                gluon.nn.Conv2D(32, 3, padding=1, activation="relu"),
                gluon.nn.MaxPool2D(pool_size=(2, 1)))
            self.rnn = gluon.rnn.LSTM(CRNN_HIDDEN, num_layers=1,
                                      bidirectional=True)
            self.head = gluon.nn.Dense(CRNN_CLASSES, flatten=False)

        def hybrid_forward(self, F, x):
            f = self.conv(x)                       # (N, C, H', W)
            f = F.transpose(f, axes=(3, 0, 1, 2))  # (W, N, C, H')
            f = F.reshape(f, shape=(0, 0, -1))     # (T=W, N, C*H')
            return self.head(self.rnn(f))

    return CRNN()


def crnn_from(mx, ctx, weights=None, seed=0):
    """A hybridized CRNN on ``ctx``: ``Xavier`` after ``mx.random.seed``,
    its deferred shapes completed by one forward, then ``weights``
    ({structural name: numpy}) copied in where given."""
    import numpy as np

    mx.random.seed(seed)
    net = crnn_net(mx)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    net(mx.nd.array(np.zeros((1, 1, 8, 4 * CRNN_SEQ + 4), np.float32),
                    ctx=ctx))
    if weights is not None:
        mx.convert.load_numpy_params(net, weights)
    return net


def host_weights(net):
    """A copy of a net's parameters as numpy, by structural name (on the
    CPU ``.numpy()`` alone would share the parameters' memory)."""
    return {k: p.data().detach().to("cpu", copy=True).numpy()
            for k, p in net._collect_params_with_prefix().items()}


def crnn_kernel_times(kr, dev):
    """Rows 11 and 12 at the CRNN's shape (T=20, N=32, H=64, input 64,
    fp32): each kernel against its plain version, timed beside it, the
    bound and cuDNN's layer (``rnn_layer_times``)."""
    import torch

    T, N, H, I = 4 * CRNN_SEQ + 4, CRNN_BATCH, CRNN_HIDDEN, 64
    gen = torch.Generator(device=dev).manual_seed(42)
    t = rnn_inputs("lstm", T, N, H, I, "float32", dev, gen)
    f_args = (t["xp"], t["wh"], t["h0"], t["c0"])
    ref = kr.lstm_fwd_plain(*f_args)
    b_args = (t["wh"], t["h0"], t["c0"], ref[0], ref[3], ref[4], t["dys"],
              t["dhn"], t["dcn"])
    got, bgot = kr.lstm_fwd(*f_args), kr.lstm_bwd(*b_args)
    bref = kr.lstm_bwd_plain(*b_args)
    torch.cuda.synchronize()
    layer = rnn_layer_times("lstm", t, T, N, H, I)
    out = {}
    for d, fn, plain, g, r in (
            ("fwd", lambda: kr.lstm_fwd(*f_args),
             lambda: kr.lstm_fwd_plain(*f_args), got, ref),
            ("bwd", lambda: kr.lstm_bwd(*b_args),
             lambda: kr.lstm_bwd_plain(*b_args), bgot, bref)):
        bound = rnn_bound("lstm", d, T, N, H, "float32")
        out[f"lstm_{d}"] = {
            "shape": f"T={T} N={N} H={H} I={I} fp32",
            "kernel_route": kr.plan(4, d == "bwd", N, H, dev)[0],
            "max_abs_err": max(rel_err(a, b) for a, b in zip(g, r)),
            "ms": cuda_ms(fn, 20), "plain_ms": cuda_ms(plain, 2, warmup=1),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": layer[f"cudnn_{d}"],
            "port_layer_ms": layer[f"port_{d}"]}
    return out


def crnn_train(mx, card):
    """Phase 42a: the example's training run and held-out decode.  Returns
    the run's record, its starting weights and its first batches (for
    (c))."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.ops.kernels import rnn as kr

    gpu = mx.gpu(0)
    net = crnn_from(mx, gpu)
    start = host_weights(net)
    loss_fn = mx.gluon.loss.CTCLoss(layout="TNC")
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": CRNN_LR})
    rng = np.random.RandomState(0)
    params = list(net.collect_params().values())
    losses, sums, step_ms, batches = [], [], [], []
    torch.cuda.synchronize()
    kernels.reset_counts()
    t_run = time.perf_counter()
    for step in range(CRNN_STEPS):
        imgs, labels = render_batch(rng, CRNN_BATCH, CRNN_SEQ)
        t0 = time.perf_counter()
        x = mx.nd.array(imgs, ctx=gpu)
        y = mx.nd.array(labels, ctx=gpu) - 1
        if step < CRNN_CAPTURE_STEPS:
            batches.append((x, y))
        with mx.autograd.record():
            logits = net(x)
            loss = loss_fn(logits, y)
        loss.backward()
        trainer.step(CRNN_BATCH)
        sums.append(loss.sum().asscalar())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(sums[-1] / CRNN_BATCH)
        if step == 3:
            after4 = [p.data().detach().clone() for p in params]
    run_s = time.perf_counter() - t_run
    train_counts = counts_now()
    fwd_routes = launches_by_route(kr.lstm_fwd_counts)
    bwd_routes = launches_by_route(kr.lstm_bwd_counts)
    plain = sum(c.plain_calls_on_cuda for c in kernels.KERNEL_COUNTS.values())
    others = {k: c.launches for k, c in kernels.KERNEL_COUNTS.items()
              if k not in ("lstm_fwd", "lstm_bwd") and c.launches}
    median_ms = statistics.median(step_ms[2:])
    eager_record("crnn", sums, after4, train_counts, CRNN_STEPS, median_ms)
    kernels.reset_counts()
    imgs, labels = render_batch(np.random.RandomState(99), CRNN_EVAL,
                                CRNN_SEQ)
    logits = net(mx.nd.array(imgs, ctx=gpu)).asnumpy()
    eval_launches = kr.lstm_fwd_counts.reg_launches
    decoded = greedy_decode(logits, blank=logits.shape[-1] - 1)
    truth = [[int(v) - 1 for v in row] for row in labels]
    acc = float(np.mean([d == t for d, t in zip(decoded, truth)]))
    n = CRNN_STEPS
    tail = float(np.mean(losses[-20:]))
    log(f"crnn 42a: examples/ocr/train_crnn_ctc.py's CRNN, batch "
        f"{CRNN_BATCH} of 8 x {4 * CRNN_SEQ + 4} strips, T={4 * CRNN_SEQ + 4}"
        f", hidden {CRNN_HIDDEN}, {CRNN_CLASSES} classes, Xavier, Adam "
        f"{CRNN_LR}, hybridized, fp32, {n} steps in {run_s:.1f} s; step "
        f"median {median_ms:.3f} ms over steps 3-{n} (host, synchronised by "
        f"the loss's read) on {card}; CTC loss (mean a sequence) step 1 "
        f"{losses[0]:.4f}, step 100 {losses[min(99, n - 1)]:.4f}, step {n} "
        f"{losses[-1]:.4f}, mean of the last 20 {tail:.5f}; held-out "
        f"exact-sequence accuracy {acc:.3f} on {CRNN_EVAL} (gate "
        f"{CRNN_ACC}); launches by route lstm_fwd {fwd_routes}, lstm_bwd "
        f"{bwd_routes} (2 x {n} = {2 * n} each on the register route), "
        f"other kernels {others}, plain calls on cuda {plain}; the held-out "
        f"forward {eval_launches} lstm_fwd on the register route")
    checks = {"crnn_losses_finite": bool(np.isfinite(losses).all()),
              "crnn_loss_falls_tenfold": tail < losses[0] / 10,
              "crnn_accuracy": acc >= CRNN_ACC,
              "crnn_lstm_fwd_register_route": fwd_routes == {
                  "split": 0, "reg": 2 * n, "mma": 0},
              "crnn_lstm_bwd_register_route": bwd_routes == {
                  "split": 0, "reg": 2 * n},
              "crnn_no_other_kernel": not others,
              "crnn_no_plain_call": plain == 0,
              "crnn_eval_launches": eval_launches == 2}
    record = {"train": 2 * n, "eval": eval_launches, "steps": n,
              "step_ms": median_ms, "accuracy": acc,
              "losses": (losses[0], losses[min(99, n - 1)], losses[-1])}
    return checks, record, start, batches, loss_fn


def crnn_card_vs_cpu(mx, start):
    """Phase 42b: the same weights on gpu(0) and cpu(), 2 Adam steps on
    one batch of 32."""
    import numpy as np

    x_np, y_np = render_batch(np.random.RandomState(7), CRNN_BATCH,
                              CRNN_SEQ)
    runs = {}
    for side, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        with ctx:
            net = crnn_from(mx, ctx, start)
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": CRNN_LR})
            loss_fn = mx.gluon.loss.CTCLoss(layout="TNC")
            x = mx.nd.array(x_np, ctx=ctx)
            y = mx.nd.array(y_np, ctx=ctx) - 1
            params = net._collect_params_with_prefix()
            out = {"losses": []}
            for step in range(2):
                with mx.autograd.record():
                    logits = net(x)
                    loss = loss_fn(logits, y)
                loss.backward()
                if step == 0:
                    out["logits"] = logits.asnumpy()
                    out["grads"] = {
                        k: params[k].grad().detach().to(
                            "cpu", copy=True).numpy()
                        for k in ("rnn.l0_h2h_weight", "rnn.r0_h2h_weight",
                                  "conv.0.weight")}
                trainer.step(CRNN_BATCH)
                out["losses"].append(loss.asnumpy())
            runs[side] = out
    g, c = runs["card"], runs["cpu"]

    def of_max(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    gaps = {"logits": of_max(g["logits"], c["logits"]),
            "loss_1": float(np.max(np.abs(g["losses"][0] - c["losses"][0])
                                   / np.abs(c["losses"][0]))),
            "loss_2": float(np.max(np.abs(g["losses"][1] - c["losses"][1])
                                   / np.abs(c["losses"][1])))}
    gaps.update({k: of_max(g["grads"][k], c["grads"][k]) for k in g["grads"]})
    checks = {"crnn_cpu_logits": gaps["logits"] <= CRNN_LOGIT_TOL,
              "crnn_cpu_first_loss": gaps["loss_1"] <= CRNN_LOSS_RTOL,
              "crnn_cpu_grads": all(gaps[k] <= CRNN_GRAD_TOL
                                    for k in g["grads"]),
              "crnn_cpu_losses": max(gaps["loss_1"], gaps["loss_2"])
              <= CRNN_STEP_RTOL}
    log(f"crnn 42b: card vs CPU from the same weights, batch {CRNN_BATCH}, "
        f"2 Adam steps: gaps {({k: f'{v:.3e}' for k, v in gaps.items()})} "
        f"(limits: logits {CRNN_LOGIT_TOL} of the largest, first loss "
        f"{CRNN_LOSS_RTOL} relative, gradients {CRNN_GRAD_TOL} of each "
        f"largest, both losses {CRNN_STEP_RTOL} relative)")
    return checks


def crnn_captured(mx, card, start, batches, loss_fn):
    """Phase 42c: (a)'s first batches from its starting weights through
    ``Trainer(whole_step=True).whole_step``, held to (a)'s eager steps."""
    net = crnn_from(mx, mx.gpu(0), start)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": CRNN_LR}, whole_step=True)
    params = list(net.collect_params().values())
    checks, median_ms = captured_phase(
        "crnn", card,
        lambda i: trainer.whole_step(net, loss_fn, batches[i][0],
                                     batches[i][1], batch_size=CRNN_BATCH),
        lambda: [p.data() for p in params], CRNN_CAPTURE_STEPS, trainer)
    EAGER_RUNS.pop("crnn")
    return {f"crnn_captured_{k}": ok for k, ok in checks.items()}, median_ms


def ctc_case(rng, blank_label):
    """(d)'s inputs: activations (T, N, C), labels (N, L) padded by the
    convention, data and label lengths; row 1 has no label, row 2 four
    repeats in 5 steps (infeasible)."""
    import numpy as np

    data = rng.randn(CTC_T, CTC_N, CTC_C).astype(np.float32) * 2
    lens = rng.randint(1, CTC_L + 1, CTC_N)
    lens[1] = 0
    lab = rng.randint(0, CTC_C - 1, (CTC_N, CTC_L))
    lab[2] = 3
    lens[2] = CTC_L
    shift, pad = (1, 0) if blank_label == "first" else (0, -1)
    label = np.where(np.arange(CTC_L)[None] < lens[:, None], lab + shift,
                     pad).astype(np.float32)
    dl = rng.randint(2 * CTC_L + 1, CTC_T + 1, CTC_N).astype(np.float32)
    dl[2] = 5
    return data, label, dl, lens.astype(np.float32)


def ctc_card_vs_cpu(mx):
    """Phase 42d: the CTC op on the card against the CPU."""
    import numpy as np

    rng = np.random.RandomState(42)
    gaps, checks = {}, {}
    for blank_label in ("first", "last"):
        data, label, dl, ll = ctc_case(rng, blank_label)
        runs = {}
        for side, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            d = mx.nd.array(data, ctx=ctx)
            d.attach_grad()
            with mx.autograd.record():
                loss = mx.nd.CTCLoss(d, mx.nd.array(label, ctx=ctx),
                                     mx.nd.array(dl, ctx=ctx),
                                     mx.nd.array(ll, ctx=ctx),
                                     use_data_lengths=True,
                                     use_label_lengths=True,
                                     blank_label=blank_label)
            loss.backward()
            runs[side] = (loss.asnumpy(), d.grad.asnumpy())
        (gl, gg), (cl, cg) = runs["card"], runs["cpu"]
        loss_gap = float(np.max(np.abs(gl - cl) / np.abs(cl)))
        grad_gap = float(np.abs(gg - cg).max() / np.abs(cg).max())
        gaps[blank_label] = (loss_gap, grad_gap, float(cl[1]), float(cl[2]))
        checks[f"ctc_{blank_label}"] = (
            loss_gap <= CTC_RTOL and grad_gap <= CTC_RTOL
            and bool(np.isfinite(gg).all()) and 9e29 < cl[2] < 1.1e30
            and cl[1] < 1e3)
    log(f"crnn 42d: CTCLoss (T, N, C) = ({CTC_T}, {CTC_N}, {CTC_C}), L = "
        f"{CTC_L}, both lengths, card vs CPU (loss gap relative, gradient "
        f"gap of its largest value, the zero-length row's loss, the "
        f"infeasible row's loss) by blank convention: {gaps} (limit "
        f"{CTC_RTOL})")
    return checks


def basics_net(mx):
    """Phase 42e's net: the new layers and ops on a (N, C, H, W) input in
    three branches (2-D, 1-D over the flattened image, 3-D over one
    depth slice), their outputs flattened and joined."""
    gluon = mx.gluon
    nn = gluon.nn
    C = BASICS_C

    class BasicsNet(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.two = nn.HybridSequential()
            self.two.add(nn.ReflectionPad2D(1),
                         # no bias: InstanceNorm takes out a per-channel
                         # constant, so its gradient would be rounding alone
                         nn.Conv2DTranspose(C, 3, strides=2, padding=2,
                                            output_padding=1, groups=2,
                                            use_bias=False, in_channels=C),
                         nn.InstanceNorm(in_channels=C),
                         nn.PReLU(mx.init.Constant(0.2), in_channels=C),
                         nn.GroupNorm(num_groups=2),
                         nn.ELU(0.5),
                         gluon.contrib.nn.PixelShuffle2D(2))
            self.one = nn.HybridSequential()
            self.one.add(nn.Conv1D(C, 3, padding=1, in_channels=C),
                         nn.SELU(),
                         nn.Conv1DTranspose(C // 2, 4, strides=2, padding=1,
                                            in_channels=C),
                         nn.GELU())
            self.three = nn.HybridSequential()
            self.three.add(nn.Conv3D(C, (1, 3, 3), padding=(0, 1, 1),
                                     in_channels=C),
                           nn.Conv3DTranspose(C // 2, (1, 2, 2),
                                              strides=(1, 2, 2),
                                              in_channels=C),
                           nn.Swish(1.5))

        def hybrid_forward(self, F, x):
            a = self.two(x)
            a = F.UpSampling(a, scale=2, sample_type="bilinear")
            a = F.LRN(a, nsize=3)
            a = F.L2Normalization(a, mode="channel")
            b = self.one(F.reshape(x, shape=(0, 0, -1)))
            c = self.three(F.expand_dims(x, axis=2))
            return F.concat(F.flatten(a), F.flatten(b), F.flatten(c),
                            dim=1)

    return BasicsNet()


def basics_card_vs_cpu(mx):
    """Phase 42e: the net of new layers, forward and backward, on the card
    against the CPU from the same weights."""
    import numpy as np

    rng = np.random.RandomState(43)
    x_np = rng.randn(BASICS_B, BASICS_C, BASICS_HW, BASICS_HW).astype(
        np.float32)
    runs, weights = {}, None
    for side, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
        with ctx:
            mx.random.seed(43)
            net = basics_net(mx)
            net.initialize(ctx=ctx)
            net.hybridize()
            x = mx.nd.array(x_np, ctx=ctx)
            net(x)
            if weights is None:
                weights = host_weights(net)
            else:
                mx.convert.load_numpy_params(net, weights)
            x.attach_grad()
            with mx.autograd.record():
                out = net(x)
                c = mx.nd.array(np.random.RandomState(44).uniform(
                    0.5, 1.5, out.shape).astype(np.float32), ctx=ctx)
                (out * c).sum().backward()
            grads = {k: p.grad().detach().to("cpu", copy=True).numpy()
                     for k, p in
                     net._collect_params_with_prefix().items()
                     if p.grad_req != "null"}
            runs[side] = (out.asnumpy(), x.grad.asnumpy(), grads)
    (go, gx, gg), (co, cx, cg) = runs["card"], runs["cpu"]

    def of_max(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    gaps = {"out": of_max(go, co), "input_grad": of_max(gx, cx)}
    gaps.update({k: of_max(gg[k], cg[k]) for k in cg})
    worst = max(gaps, key=gaps.get)
    log(f"crnn 42e: a net of the new layers (b={BASICS_B}, {BASICS_C} "
        f"channels, {BASICS_HW}^2; output {go.shape}) on the card vs the "
        f"CPU, {len(cg)} parameter gradients: out {gaps['out']:.3e}, input "
        f"gradient {gaps['input_grad']:.3e}, the largest gap {worst} "
        f"{gaps[worst]:.3e} (limit {BASICS_TOL} of each largest value)")
    return {"basics_within_tol": gaps[worst] <= BASICS_TOL,
            "basics_finite": bool(np.isfinite(go).all())}


def gluon_basics(mx, card):
    """Phase 42: the Gluon basics on gpu(0), fp32 with TF32 off and cuDNN
    deterministic (the captured step must match the eager one bit for
    bit).  Returns the CRNN's launches and rows 11-12 at its shape."""
    import torch

    from mxnet_tpu_torch.ops.kernels import rnn as kr

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        times = crnn_kernel_times(kr, torch.device("cuda", 0))
        log(f"crnn 42a: rows 11-12 at the CRNN's shape on {card}: "
            + "; ".join(f"{k} {v['kernel_route']} route {v['ms']:.4f} ms "
                        f"(plain {v['plain_ms']:.3f}, bound "
                        f"{v['bound_ms']:.4f} {v['bound_by']}, cuDNN's layer "
                        f"{v['library_ms']:.4f}, the port's layer "
                        f"{v['port_layer_ms']:.4f}), max err "
                        f"{v['max_abs_err']:.3g}" for k, v in times.items()))
        checks, record, start, batches, loss_fn = crnn_train(mx, card)
        checks["crnn_kernels_match_plain"] = all(
            v["max_abs_err"] <= RNN_TOL["float32"] for v in times.values())
        checks.update(crnn_card_vs_cpu(mx, start))
        cap_checks, cap_ms = crnn_captured(mx, card, start, batches, loss_fn)
        checks.update(cap_checks)
        checks.update(ctc_card_vs_cpu(mx))
        checks.update(basics_card_vs_cpu(mx))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    record["captured_step_ms"] = cap_ms
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"gluon basics 42 checks failed: {failed} "
                         f"(record {record})")
    return record, times


def main():
    import torch

    wall0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-train", action="store_true",
                    help="also profile two BERT training steps")
    ap.add_argument("--profile-resnet", action="store_true",
                    help="also profile two ResNet-50 training steps")
    ap.add_argument("--bert-ranks-worker", metavar="DIR", default=None,
                    help="run one rank of phases 20-25 and 38-40 (the "
                    "launcher does)")
    ap.add_argument("--mesh-worker", metavar=("DIR", "PHASE"), nargs=2,
                    default=None,
                    help="run one rank of phases 21 (resnet), 22 (bert) "
                    "and 38 (moe), comma-separated; the launcher does")
    ap.add_argument("--serve-replica-worker", metavar=("REGISTRY", "ID"),
                    nargs=2, default=None,
                    help="run one replica worker of phase 33 (the control "
                    "plane spawns it)")
    args = ap.parse_args()
    if args.serve_replica_worker is not None:
        return serve_replica_worker(*args.serve_replica_worker)
    if args.bert_ranks_worker is not None:
        return bert_ranks_worker(args.bert_ranks_worker)
    if args.mesh_worker is not None:
        return mesh_worker(*args.mesh_worker)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "mxnet_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the mxnet_tpu_torch package is not beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import kernels

    # fp32 comparisons are in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"device: {name} x{count}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t = time.perf_counter()
    kernels.build_all_kernels()
    log(f"build: {time.perf_counter() - t:.1f}s")
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        """The wall time since the last lap, under ``name`` (printed at the
        end: where the script's time goes)."""
        now = time.perf_counter()
        laps[name] = round(now - last[0], 1)
        last[0] = now
    for lib in kernels.KERNEL_LIBRARIES:
        log(f"build log of {lib.source.name}:\n{lib.build_log}")
    from mxnet_tpu_torch.ops.kernels import rnn as krnn
    spills = spill_bytes(krnn.library.build_log,
                         ("lstm_fwd_reg_kernel", "lstm_fwd_mma_kernel",
                          "gru_bwd_cluster_kernel", "lstm_bwd_reg_kernel",
                          "gru_fwd_cluster_kernel"))
    log(f"spill bytes (stores, loads) of the register, tensor-core and "
        f"cluster routes' kernels: {sorted(set(spills.values()))} over "
        f"{len(spills)} instantiations (24 + 16 + 2 + 12 + 6)")
    if len(spills) != 60 or any(v != (0, 0) for v in spills.values()):
        raise SystemExit(f"a redesigned route's kernel spills: {spills}")
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.ops.kernels import conv_fused as kcf
    for lib, kname in ((fa.library, "mma_kernel"),
                       (fa.bwd_library, "mma_kernel"),
                       (kcf.library, "tf32_mm_kernel")):
        mixes = sass_mix(lib, kname)
        log(f"SASS of the tensor-core kernels in {lib.source.name} "
            f"(opcode counts): "
            + ("cuobjdump not found" if mixes is None else "; ".join(
                f"{short_name(fn)}: {mix}" for fn, mix in mixes.items())))

    # every torch.profiler session (phases 6 and 10, and the profiles of 5
    # and 7) runs before the first CUDA graph (phase 8's predict forwards,
    # phase 4's buckets): graphs captured earlier broke the profiler's
    # device readings (PERF.md §6)
    probe = start_sdpa_probe(TRAIN_BATCH, 12, TRAIN_SEQ, 64)
    flash, tfm_fwd = check_flash_attention(mx)
    lap("3 flash forward")
    bwd = check_flash_attention_bwd(mx, probe)
    tfm_bwd = bwd.pop("transformer_big_b64")
    gpt2_fwd, gpt2_bwd = tfm_fwd.pop("gpt2_pp")["causal"], bwd.pop("gpt2_pp")
    lap("3 flash backward")
    train = train_bert(mx, card, bwd, profile=args.profile_train)
    lap("5 BERT train")
    rkern = check_resnet_kernels(torch.device("cuda", 0))
    lap("6 ResNet kernels")
    rnn = check_rnn_kernels(mx, torch.device("cuda", 0))
    lap("10 RNN kernels")
    rtrain, rpredict = train_resnet(mx, card, profile=args.profile_resnet)
    lap("7-9 ResNet")
    with tempfile.TemporaryDirectory(prefix="serve-smoke-", dir=ROOT) as d:
        serve = serve_bert(mx, card, flash["ms"], d)
    torch.cuda.empty_cache()
    lap("4 serve")
    dtrain, dpredict, _, droutes, dbroutes = train_deepar(mx, card)
    lap("11-13 DeepAR")
    gtrain, _, groutes = train_gru(mx, card)
    lap("14 GRU")
    captured = captured_steps(mx, card)
    lap("15 captured")
    checkpoints(mx, card)
    lap("16 checkpoints")
    tfm_train, tfm_net, tfm_start = train_transformer(mx, card)
    s, v = (mx.nd.array(a, ctx=mx.gpu(0)) for a in decode_rows(mx))
    tfm_decode = decode_transformer(mx, card, tfm_net.model, s, v, "trained")
    del tfm_net
    torch.cuda.empty_cache()
    eos, rise, expected = eos_model(mx, tfm_start, s, v)
    log(f"decode eos: phase 17's starting weights, out_proj's EOS bias "
        f"raised by {rise:.4f}; rows expected to emit EOS by step 15: "
        f"{expected}")
    tfm_decode_eos = decode_transformer(mx, card, eos, s, v, "eos",
                                        varied=True)
    del eos, tfm_start
    torch.cuda.empty_cache()
    lap("17-18 Transformer-big")
    cells, cell_routes = check_cells(mx, card)
    lap("18b cells")
    kv_record = check_kvstore(mx, card)
    lap("19 kvstore")
    dist_launches = train_bert_dist(mx, card)
    mesh_resnet = dist_launches.pop("mesh_resnet_train")
    lap("20-25, 38-40 dist, the mesh, ZeRO, mesh_shape, pp, sp, ep, "
        "dist_async and the elastic resize (one launch)")
    data_launches = input_tier(mx, card, captured["resnet"][1])
    lap("26 input tier")
    tier_launches = image_text_tier(mx, card, captured)
    lap("27 image and text tiers")
    data_launches["jpeg_resnet_train"] = tier_launches["jpeg_resnet_train"]
    dist_launches["corpus_bert_train"] = tier_launches["corpus_bert_train"]
    res_launches = resilience_telemetry(mx, card, captured["bert"][1])
    lap("28 resilience and telemetry")
    with tempfile.TemporaryDirectory(prefix="int8-smoke-", dir=ROOT) as d:
        int8 = int8_bert_serving(mx, card, d)
    lap("29 int8 BERT-base serving")
    dmodel, dprompts, dbudgets, _ = decode_arms(mx, card)
    lap("30 decode")
    tuner_run(mx, card, int8["traffic"], int8["lengths"], dmodel, dprompts,
              dbudgets)
    del dmodel
    lap("31 tuner")
    with tempfile.TemporaryDirectory(prefix="router-smoke-", dir=ROOT) as d:
        first = control_plane_first_worker(mx, d)   # spawns beside 32
        try:
            routed = router_bert(mx, card, d)
            router_decode(mx, card)
            torch.cuda.empty_cache()
            lap("32 router (phase 33's first spawn beside it)")
            ctrl = control_plane_bert(mx, card, first)
        finally:
            control_plane_stop(first)
    torch.cuda.empty_cache()
    lap("33 control plane")
    # phase 36 holds the top-1 of phase 34's net, trained 7 steps on random
    # labels, against its int8 graph: decisions that hinge on the fit's
    # last bits, which cuDNN's nondeterministic backward algorithms vary
    # from run to run (agreement 1.0 alone, 0.78 and 0.375 in two whole
    # runs: PERF.md §6, PR 25); its deterministic ones fix them
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="symbolic-smoke-",
                                         dir=ROOT) as d:
            sym_res = module_resnet(mx, card, d)
            lap("34 Module ResNet-50")
            lm_launches, _, lm_routes = bucketing_lm(mx, card, d)
            lap("35 BucketingModule LSTM LM")
        int8_resnet(mx, card, sym_res)
    finally:
        torch.backends.cudnn.deterministic = False
    del sym_res
    torch.cuda.empty_cache()
    lap("36 int8 ResNet-50")
    dist_launches.update(train_moe_lm(mx, card))
    torch.cuda.empty_cache()
    lap("37 MoE LM")
    dist_launches.update(imperative_ndarray(mx, card))
    torch.cuda.empty_cache()
    lap("41 imperative NDArray")
    crnn, crnn_times = gluon_basics(mx, card)
    torch.cuda.empty_cache()
    lap("42 Gluon basics (CRNN + CTC)")

    dist_launches["resilience_bert_train"] = \
        res_launches["resilience_bert_train"]
    resnet_paths = {k: {"resnet_train": rtrain[k],
                        "mesh_resnet_train": mesh_resnet[k],
                        **{path: n[k] for path, n in data_launches.items()}}
                    for k in ("bn_stats", "matmul_bn_stats",
                              "bn_act_matmul_stats")}

    src = "mxnet_tpu/ops/pallas/flash_attention.py"
    cf_src = "mxnet_tpu/ops/pallas/conv_fused.py"
    rnn_src = "mxnet_tpu/ops/pallas/rnn.py"
    rnn_cu = "mxnet_tpu_torch/csrc/rnn.cu"
    fwd_by_path = {"serve": serve["launches"],
                   "resilience_serve": res_launches["resilience_bert_serve"][
                       "flash_attention_fwd"],
                   "int8_serve": int8["launches"],
                   "router_serve": routed["launches"],
                   "ctrl_workers": ctrl["launches"],
                   "train": train["flash_attention_fwd"],
                   "transformer_train": tfm_train["flash_attention_fwd"],
                   "transformer_decode": tfm_decode,
                   "transformer_decode_eos": tfm_decode_eos,
                   **{path: n["flash_attention_fwd"]
                      for path, n in dist_launches.items()}}
    bwd_by_path = {k: {"train": train[k], "transformer_train": tfm_train[k],
                       **{path: n[k] for path, n in dist_launches.items()}}
                   for k in ("flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv")}
    record = {"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source="mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces=f"{src}:30,104", launches=sum(fwd_by_path.values()),
             launches_by_path=fwd_by_path,
             transformer_big_b64=tfm_fwd.pop("transformer_big_b64"),
             gpt2_causal_s1024=gpt2_fwd,
             transformer_decode=tfm_fwd, **flash),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces=f"{src}:427,252",
             launches=sum(bwd_by_path["flash_attention_bwd_dq"].values()),
             launches_by_path=bwd_by_path["flash_attention_bwd_dq"],
             transformer_big_b64=tfm_bwd["dq"],
             gpt2_causal_s1024=gpt2_bwd["dq"]["causal"],
             **bwd["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces=f"{src}:471,299",
             launches=sum(bwd_by_path["flash_attention_bwd_dkv"].values()),
             launches_by_path=bwd_by_path["flash_attention_bwd_dkv"],
             transformer_big_b64=tfm_bwd["dkv"],
             gpt2_causal_s1024=gpt2_bwd["dkv"]["causal"],
             **bwd["dkv"]),
        dict(name="bn_stats", route="cuda",
             source="mxnet_tpu_torch/csrc/batch_norm.cu",
             replaces="mxnet_tpu/ops/pallas/batch_norm.py:33",
             launches=sum(resnet_paths["bn_stats"].values()),
             launches_by_path=resnet_paths["bn_stats"],
             **rkern["bn_stats"]),
        dict(name="matmul_bn_stats", route="cuda",
             source="mxnet_tpu_torch/csrc/conv_fused.cu",
             replaces=f"{cf_src}:123",
             launches=sum(resnet_paths["matmul_bn_stats"].values()),
             launches_by_path=resnet_paths["matmul_bn_stats"],
             **rkern["matmul_bn_stats"]),
        dict(name="bn_act_matmul", route="cuda",
             source="mxnet_tpu_torch/csrc/conv_fused.cu",
             replaces=f"{cf_src}:227", launches=rpredict,
             **rkern["bn_act_matmul"]),
        dict(name="bn_act_matmul_stats", route="cuda",
             source="mxnet_tpu_torch/csrc/conv_fused.cu",
             replaces=f"{cf_src}:323",
             launches=sum(resnet_paths["bn_act_matmul_stats"].values()),
             launches_by_path=resnet_paths["bn_act_matmul_stats"],
             **rkern["bn_act_matmul_stats"]),
        dict(name="lstm_fwd", route="cuda", source=rnn_cu,
             replaces=f"{rnn_src}:41",
             launches=(dtrain["lstm_fwd"] + sum(dpredict.values())
                       + cells["lstm_fwd"] + lm_launches["lstm_fwd"]
                       + crnn["train"] + crnn["eval"]),
             launches_by_path={"deepar_train": dtrain["lstm_fwd"],
                               **dpredict, "cells": cells["lstm_fwd"],
                               "lm_bucketing_train": lm_launches["lstm_fwd"],
                               "crnn_train": crnn["train"],
                               "crnn_eval": crnn["eval"]},
             launches_by_route=dict(
                 droutes, cells=cell_routes["lstm_fwd"],
                 lm_bucketing_train=lm_routes["lstm_fwd"],
                 crnn={"reg": crnn["train"] + crnn["eval"]}),
             crnn_t20_n32_h64=crnn_times["lstm_fwd"],
             **rnn["lstm_fwd"]),
        dict(name="lstm_bwd", route="cuda", source=rnn_cu,
             replaces=f"{rnn_src}:132",
             launches=(dtrain["lstm_bwd"] + lm_launches["lstm_bwd"]
                       + crnn["train"]),
             launches_by_path={"deepar_train": dtrain["lstm_bwd"],
                               "lm_bucketing_train": lm_launches["lstm_bwd"],
                               "crnn_train": crnn["train"]},
             launches_by_route={
                 "deepar_train": dbroutes,
                 "lm_bucketing_train": lm_routes["lstm_bwd"],
                 "crnn_train": {"reg": crnn["train"]}},
             crnn_t20_n32_h64=crnn_times["lstm_bwd"],
             **rnn["lstm_bwd"]),
        dict(name="gru_fwd", route="cuda", source=rnn_cu,
             replaces=f"{rnn_src}:300",
             launches=gtrain["gru_fwd"] + cells["gru_fwd"],
             launches_by_path={"gru_train": gtrain["gru_fwd"],
                               "cells": cells["gru_fwd"]},
             launches_by_route={
                 r: groutes["gru_fwd"].get(r, 0)
                 + cell_routes["gru_fwd"].get(r, 0)
                 for r in {**groutes["gru_fwd"], **cell_routes["gru_fwd"]}},
             **rnn["gru_fwd"]),
        dict(name="gru_bwd", route="cuda", source=rnn_cu,
             replaces=f"{rnn_src}:366", launches=gtrain["gru_bwd"],
             launches_by_route=groutes["gru_bwd"], **rnn["gru_bwd"]),
    ]}
    log(f"kvstore: fused pushpull of BERT-base's gradients {kv_record}")
    log(f"chip_smoke: wall time by phase (s) {laps}")
    log(f"chip_smoke: total wall time {time.perf_counter() - wall0:.1f} s")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
