"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it finishes:

1. card and toolchain (``nvidia-smi`` name and power limit, torch, CUDA, nvcc);
2. build the CUDA kernels from ``mpgan_tpu_torch/csrc`` (seconds taken);
3. each kernel against its plain PyTorch version at flagship widths
   (N=30 B=256 and N=150 B=16; sum and mean; random masks), TF32 off,
   failing above rtol = atol = 1e-4; K2 also on the 150-particle ``--fe 128 256``
   chain at B=16 N=150. K2 and K4 are launched twice on equal inputs and the two
   results compared bit for bit (every sum in their persistent grid has a fixed
   order);
4. the main path: a flagship 30-particle gluon card and a random generator in
   the reference ``.pt`` layout, 50,000 jets through ``mpgan_tpu_torch.cli.gen``;
5. 150-particle dense generation through ``generate_multi_batch`` at B=512;
   launch counters are reset before phase 4 and read after phase 5, and every
   kernel must have launched;
6. the generator's kernel path against its plain path at the sampler's batch
   (30p B=4096, 150p B=512: the shapes whose plans give a CTA several items),
   rtol = atol = 1e-4 and the mask column equal, then jets/s of both (CUDA
   events, best of 3 after warm-up) and the kernel launches a generated batch;
   K4 at B=4096 N=30 and K2 at B=512 N=150 against their plain versions and
   launched twice (bit for bit), then each one's time beside its plain
   version's;
7. the train kernels against their plain versions: K2 with dropout p = 0.5
   (K1 inside) and K3 with and without weight gradients, with and without
   dropout, at N=30 B=256 and N=150 B=16, sum and mean, random masks. du1, du2,
   dmask and the forward within rtol = atol = 1e-4; the weight gradients, which
   sum every pair row, within 1e-4 of max(1, max|ref|). One dropout element that
   differs breaks these bounds. K2 and K3 are launched twice on equal inputs, K3
   with and without weight gradients, and the two results compared bit for bit
   (their persistent grids walk a static schedule and every sum has a fixed
   order);
8. one flagship-width D+G step on the card against the same step on the CPU
   (the kernels' plain versions), B=16, from the same state, batch, noise and
   dropout keys: losses and every gradient agree (where they do not, the rows
   at LeakyReLU's kink left out, :class:`KinkRows`, as in phase 13); then the
   same step part by part (:func:`part_by_part`): the D step and then the G
   step each started on both devices from the card's state (both models, the
   optimizers' state and the key copied into the CPU's), each part's losses,
   gradients, updated state and key held at 1e-4 in the same kink rounds. Again
   on the card's plain path with dropout 0 (the plain path draws other masks
   than the kernels);
9. the main train path: ``mpgan_tpu_torch.cli.train`` with the flagship card
   and ``--efp --fpd --cov-mmd`` on synthetic jets, 2 epochs (checkpoints each
   epoch, evaluation at epoch 2: finite w1efp and coverage/MMD, a finite FPD
   where no evaluated jet has a pT sum that is not positive (an early
   generator's negative pT, which the evaluation keeps as the reference does,
   makes FPD inf) and, in any case, a finite FPD of the evaluated jets whose pT
   sum is positive; and the real-EFP cache), then a resume that restores the
   state exactly, then a 3rd epoch. Launch counters are reset before and read
   after; K2 with dropout, K3 with and without weight gradients and K4 must all
   have launched. Then
   ``mpgan_tpu_torch.cli.gen`` samples 2,000 jets from the run's
   ``state_2.npz`` (counters reset before, read after: K4 must launch);
10. the D+G step at B=256 N=30, kernel path and plain path in turns (CUDA
    events, best of 3), with TFLOP/s against the 679 GFLOP the flagship step
    needs; K3 (with and without weight gradients, at B=256 N=30 and B=32 N=150)
    and K2-train beside their plain versions; the host's time to issue a step;
    a ``torch.profiler`` breakdown of three kernel-path steps, its idle share
    taken against those steps' own wall time, its kernel launches a step beside
    the parent tree's count (for the record: PERF.md);
11. the knn kernels against their plain versions at B=160 N=150 k=20 (published
    widths) and at a small ragged shape (N=13 k=5): K5 eval and with dropout
    0.5, with and without self loops, sum and mean, with and without the
    distance feature; K6 with and without weight gradients from the plain
    forward's ``idx``/``dists``, two runs compared bit for bit. ``idx`` is
    compared exactly under the near-tie rule (a differing receiver row must
    have its swapped keys within one bucket step, and at most 1% of the rows may
    differ; the kernel builds the plain version's keys bit for bit, so 0 are
    expected) and the outputs on the agreeing rows, same tolerances as above.
    Then K5 at the main path's shapes, B=512 eval (generation: a CTA walks about
    97 items over 4 jets and searches each) and B=160 with dropout 0.5 writing
    ``idx`` (training), the same way, each launched twice bit for bit, and K8
    on K5's ``idx`` equal to K5 bit for bit at both;
12. the 150-particle knn-20 generation path: 2,048 jets through
    ``generate_multi_batch`` at B=512 and through the ``gen`` CLI (counters
    reset before, read after), shape, finiteness and mask counts; 8 jets on
    the card against the same path through the plain versions on the CPU
    (same keys, so rtol = atol = 1e-4); the sampler's batch, 512 jets, against
    the plain path, whose exact-distance search may pick another k-th
    neighbour at a bucket tie (mask column equal, share of values beyond
    tolerance logged and at most 1%); jets/s of both paths in turns;
13. one knn-20 D+G step at B=8 N=150 on the card against the CPU, kernel path
    with dropout 0.5 and plain path with dropout 0. The two round a layer's
    inputs otherwise, so a near-tie may pick another neighbour in a few rows,
    and an untrained G's particles lie close enough that one swap in G moves D's
    inputs and its neighbours in many more. The kernel path therefore holds
    every K5 call's neighbours in the step to the plain search run on the same
    inputs copied to the CPU (near-tie rule, at most 1% of rows differing; 0
    expected), then runs the CPU's knn layer calls on the card's neighbours
    (the rows where the CPU's own search on its own inputs picks others are
    logged), and losses and gradients agree within rtol = atol = 1e-4
    (gradients: of max(1, max|ref|)); where they do not, the receiver rows
    whose edges hold a LeakyReLU pre-activation at the kink (:class:`KinkRows`)
    are left out of both steps' gradients and every tensor is held at 1e-4
    again (the rows left out are logged); then part by part, as phase 8. The
    plain path: losses within 2e-3, gradients within 5e-2 of max(1, max|ref|);
14. the knn train path: ``mpgan_tpu_torch.cli.train`` with ``--num-hits 150
    --no-fully-connected --num-knn 20`` at its default batch (160), 2 epochs, a
    resume that restores the state exactly, and launch counts equal to the
    prediction: per D+G step 8 K5 launches that emit ``idx`` (D on real and
    fake in the D step, G and D in the G step, 2 layers each), 6 K6 with weight
    gradients (D twice in the D step, G in the G step), 2 K6 without (D in the G
    step) and 2 K5 without ``idx`` (the D step's fake batch), plus 2 per
    evaluation batch;
15. the knn D+G step at B=128 N=150, kernel and plain path in turns; K5 (eval
    B=512, train B=160, each output first held against its plain version as in
    phase 11) and K6 (B=160, with and without weight gradients) beside their
    plain versions.

16. the fused GAPT generator kernel (K9) against its plain version at the
    default width (N=30 E=64, 4 heads, 4 layers): masked B=1024, unmasked, masked
    B=37 and unmasked B=1023 (batches that end in a short item of fewer than the
    4 jets an item holds), and N=150 B=128; rtol = atol = 1e-4, the mask column
    bit-identical, and a second launch equal bit for bit;
17. the GAPT generation path: 50,000 default GAPT jets through the ``gen`` CLI
    from a ``.pt`` written here (random weights from a seed), the K9 launch
    count equal to the number of batches; 8,192 jets through
    ``generate_multi_batch`` at B=1024 on the kernel route and on the plain
    route, the two held against each other;
18. one GAPT D step and one G step at B=16 on the card against the same step on
    the CPU from the same state, batch, noise and dropout keys (D dropout 0.5 on
    the kernel route): 1e-4 on losses and gradients;
19. the GAPT train path: ``mpgan_tpu_torch.cli.train --model gapt`` at its
    default batch (512) on synthetic jets, 2 epochs, a resume that restores the
    state exactly, a 3rd epoch, and the K9 launch count equal to the prediction
    (one per D step, for its fake batch, and one per evaluation batch);
20. GAPT timings (CUDA events, best of 3): generation at B=1024 and B=4096 in
    jets/s, kernel route and plain route in turns; the D+G step at B=512; K9
    beside its bound; ``F.scaled_dot_product_attention`` on the same
    ``[B, H, N, hd]`` as a yardstick of the attention stage alone (the port never
    calls it); a ``torch.profiler`` breakdown of three GAPT steps;
21. the split knn route at B=160 N=150 k=20 (published widths): K7's ``idx``
    equal to K5's and to the plain version's in every row, its distances within
    1e-4; K8 against its plain version and against K5 on the same inputs (bit
    for bit, reported), eval and dropout 0.5; K8 -> K6 gradients through the
    autograd Function against the plain backward; then, with
    ``MPGAN_TPU_KNN_KERNEL=3``, 1,024 knn-20 jets through ``generate_multi_batch``
    at B=512 and D+G steps at B=128 (counters reset before, read after: K7, K8
    and K6 must have launched, K5 not), timed beside route 4, and a
    ``torch.profiler`` breakdown of the route-4 knn-20 step;
22. evaluation at the loop's size: ``Trainer.eval_save_plot`` with ``--efp --fpd
    --cov-mmd`` on 50,000 generated jets against 50,000 synthetic real jets,
    for the flagship 30p (K4) and the 150p dense generator (K2), twice each (the
    first computes the real-EFP cache), each part timed: generation, w1p and
    w1m (host), the FPD's EFPs (FP32 on the card), w1efp, FPD on the host,
    coverage/MMD (float64 on the card). Counters reset before, read after: K4,
    then K2, must launch. Checks, each raising: generated jets and metrics finite; the card's real
    EFPs within rtol 2e-3, atol 1e-9 of the float64 path on 2,000 (30p) and 256
    (150p) jets; the EFPs' peak memory under (plan squares + 2) x chunk x N^2 x
    4 bytes (``efp_plan_squares``), coverage/MMD's under four float64 tensors
    of the Sinkhorn cost's size; at 30p the first batch's EMD on the card
    within 1e-9 of the same function on the CPU;
23. the model zoo: each of the 13 other families of the reference's
    ``trained_models/`` (fc, fcmp, fcpnet, graphcnn, graphcnnmp, graphcnnpnet,
    mpfc, mplfc, mppnet, pcgan, treeganfc, treeganmp, treeganpnet) and the
    legacy pair ``old_mpgan``/``old_mpgan`` through the train CLI on synthetic
    gluon jets, with its presets and the reference's default widths at 30
    particles: one epoch of 7 batches with a checkpoint and the evaluation, then
    2,000 jets through the gen CLI from its ``state_1.npz`` (PCGAN's G_inv and
    G_pc are seeded random weights written here). Checks, each raising: finite
    losses, W1 and jets of the expected shape; the legacy generator's kernel
    path against its plain path at B=4096 (mpfc as trained, the mplfc card with
    its masks; rtol = atol = 1e-4, mask column equal); one mplfc D+G step on
    the card against the CPU as in phase 8; counters reset before, read after:
    K4, K2 with dropout and K3 with and without weight gradients launched.
    Each family's D+G step at its batch and generation rate at B=4096 (CUDA
    events, best of 3) are printed beside the card's name and power limit;
24. FPND at the loop's size: the flagship 30p generator (K4) makes 50,000 jets,
    scored against 50,000 synthetic real jets on the seeded random ParticleNet
    trunk, activations on the card and moments on the host timed apart, with
    the peak device memory. Checks, each raising: the card's activations of
    2,000 jets a side against the CPU path's at rtol = atol = 1e-4, at most 1%
    of the jets beyond it (a block 2-3 search in the learned features may swap
    two near-tied neighbours where the card rounds otherwise); the FPND of
    those jets on the card within 1e-3 relative of the CPU's;
25. the flagship train CLI with ``--aug-t --aug-f --aug-r90 --aug-s --fpnd
    --profile --debug`` on synthetic jets, one epoch of 10 batches and its
    evaluation: finite losses and FPND, the three ``--debug`` blocks logged, the
    profile's trace naming K2, K3 and K4 (counters reset before, read after:
    each launched); an augmented flagship D+G step (dropout 0.5) on the card
    against the CPU as in phase 8; one D+G step under ``--debug-nans``, clean,
    then raising ``FloatingPointError`` with a NaN weight in G;
26. ``cli.train_mnist`` on the card: one epoch of the synthetic clouds (62
    batches) at N = 100 and at N = 75 on the reference's dense MPGAN defaults
    (batch 32; G on K2, N > 64; D on K2 with dropout 0.5 and K3), FID by a
    MoNet written from a seed on 256 clouds (timed apart), the cloud raster
    where matplotlib is installed, each step's time; K2 (eval) at B = 32, N = 75
    and 100 against its plain version and rerun bit for bit, then phase 7's
    checks of K2 with dropout and K3 at those shapes, and each kernel's time
    beside its bound and its plain version's;
27. the CUDA graphs (``--epoch-scan``; phases 9, 14, 19, 25 and 26 above already
    train on them, their launch counts through the graphs' replay accounting):
    seven training paths (flagship B=256, knn-20 B=128 on routes 4 and 3, GAPT
    B=512, MNIST N=100 B=32, the fcmp pair with WGAN-GP and num_critic 5 on D
    and G graphs, the legacy pair on mplfc's masks crossing ``--mask-epoch
    1``), each an epoch of 5 batches (12 at num_critic 5, so that G captures)
    through ``Trainer.train_epoch`` on the eager loop and on the graphs from one
    seed: parameters, BN statistics, SN vectors,
    optimizer state, losses and the generator bit for bit (or within 1e-6
    relative, logged), the same kernel launches, the captures and replays
    counted; then each path's step time in turns (eager, graph, graph, eager),
    the host's time to issue a step with the device drained, a profile's
    device time and the peak device memory of both. The flagship through
    ``cli.train`` for two epochs with ``--epoch-scan`` and with
    ``--no-epoch-scan``: equal losses. The samplers (30p B=4096, 150p dense
    B=512 and B=32, knn-20 B=512, GAPT B=1024 and B=4096), three batches each:
    the graph's jets equal the eager loop's bit for bit with the same
    launches; jets/s of both in turns over 8 batches (the host's copy
    included) and peak memory;
28. bf16 training (``--compute-dtype bfloat16``): K2 (eval and dropout 0.5),
    K3 (with and without weight gradients) and K4 in their bf16 modes against
    their bf16 plain versions at B=256 N=30 and (K2, K3) B=32 N=150, each
    launched twice bit for bit, within rtol = atol = 1e-2 (K3's gradients
    within 1e-2 of max(1, max|ref|); K3's split-TF32 products held apart from
    one TF32 product by the share of its bf16 gradients that differ from the
    plain version's, at slope 1: at most 0.5%, where the plain version with one
    TF32 product or a lo term of the split left out reads more), then timed
    beside their FP32 modes (in turns), their plain versions and their bounds;
    K4's bf16 mode (on the tile pass, fn after a grid-wide barrier) equal bit for
    bit to what the FP32 pass's bf16 mode gave on the seeded cases of
    ``scripts/torch_k4_bf16_bits.py`` (``tests/data/k4_bf16_fp32_pass.npz``);
    a flagship bf16 D+G step at
    B=256 against the float32 step from the same weights and draws (losses
    within 5%, every master tensor float32, only the bf16 kernels launched, a
    ``torch.profiler`` trace naming them); the bf16 epoch on the CUDA graph
    against the eager loop bit for bit, and the bf16 and float32 graph steps in
    turns with a profile of each; 3 epochs of ``cli.train --compute-dtype
    bfloat16`` with a resume and the predicted bf16 launches (the evaluation
    stays float32); one ``batched_d`` D step of the GAPT pair against the CPU
    at 1e-4.
29. bf16 training on the knn-20 and GAPT paths: K5 (eval; dropout 0.5 with
    ``idx``; with and without distances), K7 (with and without distances), K8
    and K6 (with and without weight gradients) in their bf16 modes against
    their bf16 plain versions at knn-20's widths (B=160 N=150 k=20) and at a
    ragged N=13 k=5, and K9 on bf16 inputs at B=1024 and B=4096, each within
    rtol = atol = 1e-2 (K6's gradients held as a whole: relative L2 within
    3e-2, no element beyond 0.1 of max(1, max|ref|), as the card tests hold
    bf16 gradients; K6's split-TF32 products held as K3's in phase 28) and
    launched twice bit for bit (K7 equal to K5's search, K8 on its ``idx`` to
    K5's output, K9 to the FP32 launch on the widened inputs; a bf16 K9 call, as
    the bf16 GAPT step's D step makes it, is one K9 launch beside torch operators
    that only allocate (no cast), on the item path and on the per-jet path at
    N=300), then timed
    beside its FP32 mode in turns, its plain version and its bound; the bf16
    knn-20 D+G step at B=128 on routes 4 and 3 and the GAPT one at B=512
    against the float32 step from the same weights and draws (losses within
    5%, every master tensor float32, only the bf16 kernels launched, in the
    counts a step predicts, a ``torch.profiler`` trace naming them), each bf16
    epoch on the CUDA graph against the eager loop bit for bit, and the bf16
    and float32 graph steps in turns with a profile of each; ``cli.train
    --compute-dtype bfloat16`` on knn-20 (routes 4 and 3) and GAPT, 2 epochs
    and a resume, with the counts set to 0 before each run and the predicted
    bf16 launches read after (every bf16 kernel of the path launched).
30. multi-device (``parallel/mesh.py``). (a) An NCCL mesh of one rank on the
    card: the flagship D+G step at B=256 (dropout 0.5), the bf16 flagship step,
    the knn-20 step at B=128 and the GAPT step at B=512, each given the same
    draws, equal bit for bit to the step without a mesh (an all-reduce over one
    rank and a division by 1 are exact), with the reduce's bucket bytes; a
    5-batch flagship epoch on the captured CUDA graph, the all-reduce inside
    it, equal bit for bit to the eager mesh epoch; the graph step with and
    without the mesh in turns, and the reduce's device ms from a profile;
    ``cli.train --mesh-shape 1`` for 2 epochs and a resume for a third (counts
    set to 0 before, read after: K2 with dropout, K3 with and without weight
    gradients and K4 launched); ``cli.gen --mesh-shape 1``'s 50,000 jets equal
    to ``--mesh-shape 0``'s. (b) A gloo mesh of two ranks sharing the card
    (``make_mesh(devices=[cuda:0, cuda:0])``, two spawned processes): the
    flagship D+G step at a global B=128 (64 a rank) on the kernel path
    against the same 2-rank step on the CPU (the kernels' plain versions) from
    the same state, shards and per-rank draws, losses and gradients within
    phase 8's tolerances (where 1e-4 fails, with the kink's receiver rows left
    out, as phase 13 does) and the updated parameters where the gradient is
    clear of zero within 1e-4, the parameters bit-identical across the ranks,
    then part by part as phase 8 (each part's first kink round that holds on
    both ranks); the 2-rank sampler of 4,096 jets at B=2048 against one
    rank's within rtol = atol = 1e-4, the mask column equal; the step's wall time (gloo stages through the host:
    recorded, no target). Two NCCL ranks cannot share one card, so the
    many-rank reduce is held to the JAX package on the CPU (tests).
31. the steps' random stream on the card (``ops/prng.py``, ``csrc/threefry.cu``):
    ``threefry_draws`` against its plain version (PyTorch on the card) at the
    plans the captured D+G steps record (flagship B=256, knn-20 B=128, GAPT
    B=512: the batch's order row, every draw of the step, every dropout key
    slot) at two batch counters, and at the 50,000-jet sampler's plan (B=4096,
    batch counters 0 and 12): keys, key words, edge seeds, order rows, uniforms
    and normals bit for bit, the next key and the counter as the plain version
    writes them, then timed beside its plain version and its bound; three keyed
    flagship D+G steps (B=16, dropout 0.5) on the card against the CPU (the
    kernels' plain versions) from one key, losses and the first step's
    gradients within 1e-4 and the key bit for bit after each, then the three
    steps part by part as phase 8, each part started from the card's state; a captured
    5-batch flagship epoch equal bit for bit to the eager epoch, then profiled
    (host and device): at most one host-to-device copy (the epoch's order) and
    two copy calls (the order in, the losses out), no CPU random-number call
    and one ``threefry_draws`` a step; the host's issue ms,
    the idle share and wall ms of the flagship (B=256), knn-20 (B=128) and
    GAPT (B=512) graph steps;
32. the models' initial weights drawn from the key on the card against the
    CPU's (:func:`init_phase`);
33. the MP layer's configuration lattice (:func:`lattice_phase`): the JAX
    package's 48 points (``tests/test_kernel_fuzz.py``'s sampler and seeds, B=2,
    n 9-16, widths 4-16), 8 at the published widths (flags from
    ``Random(7000 + i)``; dense N=30 B=64, knn N=150 k=20 B=16 on routes 4 and
    3), one on the K4 route and two conditioned dense ones with dropout. At
    each valid point: FP32 with dropout off, the kernel path against the plain
    path, output and every gradient at rtol = atol = 1e-4 (weight gradients of
    max(1, max|ref|)), a rerun bit for bit; with dropout on, the kernels
    against their plain versions on the card (the same seeds), the dense plan
    for 7 SMs and the other knn route at 1e-4; where an FP32 comparison
    misses, again with the receiver rows at LeakyReLU's kink left out of the
    loss on both sides (their count logged); bf16 against the bf16 plain
    versions at 1e-2 (knn gradients as a whole, relative L2 3e-2; a dense
    point's ``x`` gradient elementwise, a miss excused only where each run's
    K3 calls, carried to ``x``, lie within one bf16 ulp of du and the spread
    of 8 jittered sum orders of a float64 model of the bf16 mode on their own
    inputs, and the kernels' K2 calls within 1e-2 of the plain versions' on
    the same inputs, both held at every element, :func:`lattice_x_envelope`);
    the launches, ``threefry_draws``'s among
    them, are those the point's gate and dropout name, the layer's init draws
    included. An invalid point raises the same ``ValueError`` on both paths.
    One line a point, every fault raised at the end.
34. the 150-particle dense paths that ``bench.py`` times (:func:`dense150_phase`),
    each driven with the counts set to 0 before and read after: the ``--fe
    128 256`` generator (50,000 jets through ``gen``, the sampler at B=512,
    8 jets against the CPU and the batch against the plain path at 1e-4, the
    captured sampler bit for bit, K2 alone, jets/s in turns); the
    flagship-width D+G step (D's last layer scaled, :func:`unsaturated`; the
    epochs at D's learning rate 1e-9, each moving both models), at B=4
    against the CPU (phase 8's rules, part by part) and at B=128 on the
    graphs against the eager loop bit for bit,
    timed in turns, the plain path's step at the largest batch that fits, K2
    and K3 at B=128 against their plain versions and timed; the bf16 step at
    B=128 against float32 (5%, the predicted bf16 launches, a trace), its
    graph epoch bit for bit and timed beside float32's; the bf16 generator
    through ``bf16_apply`` against its bf16 plain versions at 1e-2; ``cli.train
    --num-hits 150`` for 2 epochs, a resume and a 3rd epoch that moves the
    parameters, in the predicted launches; and K4's backward route at B=256 N=30 against its plain
    versions, timed beside its bound.

``threefry_draws``'s entry counts its bytes (the plan, key, counter and order row
read, every draw written once) over 3.35 TB/s and its 32-bit integer and float
operations (about 80 a threefry block, one block an element, three for an edge
seed, one for every child of a block's path walk, 40 more a normal) over 67 Tops.
Every kernel's entry in the JSON line carries its bound: the larger of its
FLOPs over 67 TFLOP/s (FP32 outside the tensor cores) and its bytes (inputs
read once, outputs written once) over 3.35 TB/s, at the shape its ``ms`` was
taken at. The bf16 modes (``bf16`` inside the K2, K3 and K4 entries) count
their tensor-core products at 989 TFLOP/s (dense bf16), K3's backward products
as split-TF32 at 495 (dense TF32: three TF32 products for dW, two for da,
whose bf16 W TF32 holds exactly), K4's fn first layer at 67, and their bytes
at bf16 sizes; so do the bf16 modes inside the K5-K8 entries (K6's backward
products as K3's, K5's and K7's distances at 67, the bytes of the tensors at
their real sizes), and K9's bf16 mode counts its
float32 body at 67 and its bf16 inputs and output. Every time in that line was measured in this run. ``library_ms`` is
null: no single PyTorch call computes any of these functions (a search is a
distance product and a top-k, the aggregates and the GAPT generator are chains
of products).

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before those lines, as does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import logging
import pathlib
import random
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

TOL = 1e-4  # rtol = atol: FP32 FMA chains against cuBLAS FP32 sums in another order
FLAGSHIP = {"model": "mpgan", "jets": "g", "num_hits": 30}
REPLACES = {
    "edge_aggregate": "mpgan_tpu/ops/mp_pallas.py:319",
    "edge_aggregate_fn": "mpgan_tpu/ops/mp_pallas.py:965",
    "edge_aggregate_bwd": "mpgan_tpu/ops/mp_pallas.py:709",
    "knn_fused_layer": "mpgan_tpu/ops/knn_pallas.py:2023",
    "knn_edge_aggregate_bwd": "mpgan_tpu/ops/knn_pallas.py:1549 (also :686 and :1079)",
    "knn_search": "mpgan_tpu/ops/knn_pallas.py:126 (knn_select) and :259 (_select_nm_impl)",
    "knn_edge_aggregate": "mpgan_tpu/ops/knn_pallas.py:623 (_fwd_impl), :1016 (_fwd_impl_v2) "
                          "and :1480 (_fwd_impl_v3)",
    "gapt_g_fused": "mpgan_tpu/ops/gapt_pallas.py:236",
}
K1 = "mpgan_tpu/ops/mp_pallas.py:80 (_dropmul, K1, a device function inside the kernel)"
STEP_GFLOP = 679.0  # one flagship D+G step at B=256, N=30 (PERF.md)
# kernels a profiled flagship D+G step launched before the forward kernels ran on the
# backward's products (PERF.md, section 5): printed beside this run's count, not checked
PARENT_STEP_LAUNCHES = 955
FE = [96, 160, 192]  # the published fe widths
FN = [224, 256, 256]  # fn's input [agg | x] and hidden widths; the output width varies
KNN150 = {**FLAGSHIP, "num_hits": 150, "fully_connected": False, "num_knn": 20}
GAPT = {"model": "gapt", "jets": "g", "num_hits": 30}
MAX_DIFFERING_SHARE = 0.01  # receiver rows whose neighbours may differ at near-ties
# a pre-activation within this many ulps of the sum of its terms' magnitudes is at
# LeakyReLU's kink (KinkRows): the kernels sum a hidden layer in another order
KINK_ULPS = 16
KINK_ROUNDS = 3  # card-against-CPU steps with the kink's rows left out, at most
# phase 12: share of the knn generator's values at B=512 that may lie beyond rtol = atol
# = 1e-4 of the plain path, whose exact-distance search breaks bucket ties otherwise
# (sound runs read 0.023%, PERF.md)
MAX_PLAIN_PATH_SHARE = 0.01
# a knn step on the card against the CPU on the plain path: the two round a layer's
# inputs otherwise, so a few of the step's ~20,000 receiver rows swap two near-tied
# neighbours and with them their dropout masks (an untrained G's particles lie close:
# one row in seven of its batch has two selected keys within a bucket step). The bounds
# catch a wrong path; on the kernel path K5's neighbours are held to the plain search
# on equal inputs and the rest of the step to 1e-4 (CardNeighbours), and the kernels
# bit for bit to their plain versions in phase 11
NEAR_TIE_LOSS_TOL = 2e-3
NEAR_TIE_GRAD_TOL = 5e-2
PEAK_FP32 = 67e12  # FLOP/s, H100 SXM outside the tensor cores (NVIDIA data sheet)
PEAK_BF16 = 989e12  # FLOP/s, H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
PEAK_TF32 = 495e12  # FLOP/s, H100 SXM dense TF32 tensor cores (NVIDIA data sheet)
PEAK_HBM = 3.35e12  # bytes/s


def dense_fwd_bound(b: int, n: int, fn_out: int | None = None, fe=FE) -> dict:
    """Bound of K2 (``fn_out`` None) or K4 at the published widths (K2: or
    the ``fe`` chain's)."""
    hidden = macs(fe) + sum(fe[1:])  # weights and biases
    floats = 2 * b * n * fe[0] + b * n + hidden + b * n * (fe[-1] if fn_out is None else fn_out)
    flops = 2 * b * n * n * macs(fe)
    if fn_out is not None:
        fn = FN + [fn_out]
        floats += b * n * 32 + macs(fn) + sum(fn[1:])
        flops += 2 * b * n * macs(fn)
    return bound(flops, 4 * floats)


def dense_bwd_bound(b: int, n: int, wgrads: bool = True) -> dict:
    """Bound of K3: the recompute, da and (with ``wgrads``) dW, each one chain."""
    hidden = macs(FE) + sum(FE[1:])
    floats = (2 * b * n * FE[0] + b * n) * 2 + b * n * FE[-1] + hidden * (2 if wgrads else 1)
    return bound((3 if wgrads else 2) * 2 * b * n * n * macs(FE), 4 * floats)


def split_tf32_flops(chain, wgrads) -> int:
    """TF32 tensor-core FLOPs of the bf16 backward's float32 products at FP32
    accuracy (split-TF32, the least this card can do them in; over PEAK_TF32):
    dW = a^T dz takes three TF32 products (hi hi, hi lo, lo hi), da = dz W^T two,
    its W being bf16 values that TF32 holds exactly (lo_W = 0). ``chain``: the
    FLOPs of one product over the fe chain."""
    return chain * (2 + (3 if wgrads else 0))


def macs(widths) -> int:
    return sum(a * c for a, c in zip(widths[:-1], widths[1:]))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, moved: int) -> dict:
    """The least time the card could take: operations over the FP32 peak or
    bytes over the memory rate, whichever is larger."""
    ops, mem = flops / PEAK_FP32 * 1e3, moved / PEAK_HBM * 1e3
    return {"bound_ms": max(ops, mem), "bound_by": "operations" if ops >= mem else "bytes",
            "library_ms": None}


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def kernel_inputs(dev, b, n, fn_out, seed, fe=FE):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    hidden = []
    for a, c in zip(fe[:-1], fe[1:]):
        hidden += [r(a, c, scale=a ** -0.5), r(c, scale=0.1)]
    h_out = fe[-1]
    fn = (r(h_out, 256, scale=(h_out + 32) ** -0.5), r(32, 256, scale=(h_out + 32) ** -0.5),
          r(256, scale=0.1), r(256, 256, scale=1 / 16), r(256, scale=0.1),
          r(256, fn_out, scale=1 / 16), r(fn_out, scale=0.1))
    mask = (torch.rand(b, n, 1, generator=g, device=dev) > 0.3).float()
    return (r(b, n, fe[0], scale=0.5), r(b, n, fe[0], scale=0.5), mask, tuple(hidden),
            r(b, n, 32), fn)


def errors(out, ref):
    err = (out - ref).abs()
    bad = (err > TOL + TOL * ref.abs()).sum().item()
    rel = (err / ref.abs().clamp_min(1e-6)).max().item()
    return err.max().item(), rel, bad


def wgrad_err(out, ref, tol=TOL, floor=1.0):
    """Max abs error of a weight gradient and whether it is within tol *
    max(floor, max|ref|) (``floor`` 0: of the tensor's own scale)."""
    if out.numel() == 0:
        return 0.0, True
    err = (out - ref).abs().max().item()
    return err, err <= tol * max(floor, ref.abs().max().item())


def best_ms(fn, reps=3, inner=3):
    """Best of ``reps`` CUDA-event timings, each the mean of ``inner`` calls."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        torch.cuda.synchronize()
        best = min(best, s.elapsed_time(e) / inner)
    return best


def main_shape(identical, max_err, name, b, n, kernel, plain, inner):
    """A kernel at a path's shape (sum aggregation) against its plain version and
    rerun bit for bit (and-ed into ``identical``, its error max-ed into
    ``max_err``), then both timed; returns (kernel ms, plain ms)."""
    out, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    abs_err, rel_err, bad = errors(out, ref)
    repeat = torch.equal(out, again)
    identical[name] &= repeat
    log("kernel_check", kernel=name, b=b, n=n, sum_agg=True, max_abs_err=abs_err,
        max_rel_err=rel_err, out_of_tol=bad, two_runs_bit_identical=repeat)
    if bad or not repeat:
        raise SystemExit(f"{name} disagrees with its plain version or itself at b={b} n={n}: "
                         f"{bad} elements beyond rtol=atol={TOL}, bit-identical rerun {repeat}")
    max_err[name] = max(max_err[name], abs_err)
    del out, again, ref
    return best_ms(kernel, inner=inner), best_ms(plain, inner=inner)


def train_kernel_checks(mk, dev, identical, shapes=((256, 30), (16, 150)), sums=(True, False)):
    """Phase 7 (and 26 at the MNIST shapes): K2 with dropout and K3 against their
    plain versions; each rerun's bit-identity is and-ed into ``identical``."""
    max_err = {"edge_aggregate": 0.0, "edge_aggregate_bwd": 0.0}
    for b, n in shapes:
        for sum_agg in sums:
            u1, u2, mask, hidden, _, _ = kernel_inputs(dev, b, n, 3, seed=11 + n)
            g = torch.randn(b, n, 192, generator=torch.Generator(device=dev).manual_seed(n),
                            device=dev)
            out = mk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg, 0.5, 123457)
            again = mk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg, 0.5, 123457)
            ref = mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, sum_agg, 0.5, 123457)
            torch.cuda.synchronize()
            abs_err, _, bad = errors(out, ref)
            repeat = torch.equal(out, again)
            identical["edge_aggregate"] &= repeat
            log("train_kernel_check", kernel="edge_aggregate", dropout=0.5, b=b, n=n,
                sum_agg=sum_agg, max_abs_err=abs_err, out_of_tol=bad,
                two_runs_bit_identical=repeat)
            if bad or not repeat:
                raise SystemExit(f"edge_aggregate (train) disagrees at b={b} n={n}")
            max_err["edge_aggregate"] = max(max_err["edge_aggregate"], abs_err)
            for p in (0.0, 0.5):
                for need in (True, False):
                    out = mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, sum_agg, p, 777,
                                                need)
                    again = mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, sum_agg, p, 777,
                                                  need)
                    ref = mk.edge_aggregate_bwd_reference(u1, u2, mask, hidden, g, 0.2, sum_agg,
                                                          p, 777, need)
                    torch.cuda.synchronize()
                    repeat = all(torch.equal(x, y) for x, y in zip((*out[:3], *out[3]),
                                                                   (*again[:3], *again[3])))
                    identical["edge_aggregate_bwd"] &= repeat
                    errs = [errors(o, r) for o, r in zip(out[:3], ref[:3])]
                    werrs = [wgrad_err(o, r) for o, r in zip(out[3], ref[3])]
                    bad = sum(e[2] for e in errs) + sum(not ok for _, ok in werrs)
                    if not need and any(o.any().item() for o in out[3]):
                        bad += 1
                    err = max([e[0] for e in errs] + [e for e, _ in werrs])
                    log("train_kernel_check", kernel="edge_aggregate_bwd", dropout=p,
                        wgrads=need, b=b, n=n, sum_agg=sum_agg,
                        max_abs_err_du1_du2_dmask=[e[0] for e in errs],
                        max_abs_err_wgrads=[e for e, _ in werrs], failures=bad,
                        two_runs_bit_identical=repeat)
                    if bad or not repeat:
                        raise SystemExit(f"edge_aggregate_bwd disagrees at b={b} n={n} "
                                         f"p={p} wgrads={need} sum={sum_agg}")
                    max_err["edge_aggregate_bwd"] = max(max_err["edge_aggregate_bwd"], err)
            del out, ref
    torch.cuda.empty_cache()
    return max_err


def prng_key(seed, device):
    """``PRNGKey(seed)`` of the port's threefry PRNG (JAX's), on ``device``."""
    from mpgan_tpu_torch.ops import prng

    return prng.PRNGKey(seed, device)


def make_state(args, device, seed=0):
    """A TrainState of the args' model: G and D drawn on ``device`` from the
    children 0 and 1 of ``PRNGKey(seed)`` (the same bits on the card and the
    CPU, phase 32); the steps' key ``PRNGKey(seed)`` on the device."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.ops import prng
    from mpgan_tpu_torch.training.optimizers import build_optimizer
    from mpgan_tpu_torch.training.train_step import TrainState

    suite = build_suite(args)
    kg, kd = prng.split(prng.PRNGKey(seed))
    g = suite.generator(kg, device=device)
    d = suite.discriminator(kd, device=device)
    state = TrainState(g, d, build_optimizer(args.optimizer, g.parameters(), args.lr_gen),
                       build_optimizer(args.optimizer, d.parameters(), args.lr_disc),
                       prng_key(seed, device))
    return state


# D's last layer's scale in the 150-particle steps (unsaturated)
UNSATURATE = 2.0**-6


@contextlib.contextmanager
def unsaturated():
    """Every MPGAN D drawn inside (``ModelSuite.discriminator``: the states of
    :func:`make_state`, of a Trainer, of the train CLI; a resumed run loads
    its checkpoint over it) with its last layer (fnd's linear) scaled by
    UNSATURATE, the same bits on every device. At 150 particles the
    untrained D's logits reach 50-60 (sums over 150 senders, twice), where
    float32's sigmoid is exactly 0 or 1 and every gradient of the step
    exactly 0, so that a comparison of two steps or epochs would hold
    vacuously; scaled, they lie near 1 and every tensor of both models takes
    a gradient."""
    from mpgan_tpu_torch.models.registry import ModelSuite

    draw = ModelSuite.discriminator

    def scaled(suite, key=None, device="cpu"):
        d = draw(suite, key, device)
        with torch.no_grad():
            last = d.fnd_layer.net[-1]
            last.weight.mul_(UNSATURATE)
            last.bias.mul_(UNSATURATE)
        return d

    ModelSuite.discriminator = scaled
    try:
        yield
    finally:
        ModelSuite.discriminator = draw


def model_params(state) -> dict:
    """A copy of each model's parameters (``"g"``, ``"d"``) and of its
    optimizer's state tensors (``"g_opt"``, ``"d_opt"``; none before the
    optimizer's first step)."""
    return {**{m: [p.detach().clone() for p in getattr(state, m).parameters()]
               for m in ("g", "d")},
            **{f"{m}_opt": opt_tensors(getattr(state, f"{m}_opt")) for m in ("g", "d")}}


def opt_tensors(opt) -> dict:
    return {(i, k): v.detach().clone() for i, st in enumerate(opt.state.values())
            for k, v in st.items() if k != "step" and isinstance(v, torch.Tensor)}


def params_moved(state, before, what) -> dict:
    """The L2 norm of each model's parameter change since ``before``
    (:func:`model_params`), and of its optimizer state's; fails where both
    are 0 for a model (its gradients were 0 at every step, so that a
    comparison of such states, two runs bit for bit or a resume, would hold
    vacuously for it)."""
    norms = {}
    for m in ("g", "d"):
        norms[m] = sum(((p.detach() - q) ** 2).sum().item()
                       for p, q in zip(getattr(state, m).parameters(), before[m])) ** 0.5
        now, then = opt_tensors(getattr(state, f"{m}_opt")), before[f"{m}_opt"]
        norms[f"{m}_opt"] = sum(((v - then[k]) ** 2).sum().item() if k in then else
                                (v ** 2).sum().item() for k, v in now.items()) ** 0.5
    if not all(norms[m] or norms[f"{m}_opt"] for m in ("g", "d")):
        raise SystemExit(f"{what}: the run left a model's parameters and optimizer state "
                         f"unchanged {norms}: its comparison would hold vacuously")
    return norms


def use_kernels(state, flag):
    state.g.cfg = dataclasses.replace(state.g.cfg, use_kernels=flag)
    state.d.cfg = dataclasses.replace(state.d.cfg, use_kernels=flag)


def step_fn(state, args, data, labels):
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.train_step import d_step, g_step, step_config

    spec = build_suite(args).noise
    cfg = step_config(args)  # the loop's: loss, GP, targets, --aug-*

    def step():
        parts = d_step(state, cfg, spec, data, labels)
        parts.update(g_step(state, cfg, spec, data, labels))
        return parts
    return step


def real_batch(b, n=30):
    from mpgan_tpu_torch.data.jetnet import JetNetDataset

    ds = JetNetDataset("g", num_particles=n, synthetic_num_jets=4 * b + 100)
    return torch.as_tensor(ds.particle_data[:b]), torch.as_tensor(ds.jet_data[:b])


class CardNeighbours:
    """Phase 13's kernel path: every knn layer call's neighbours on the card (K5's
    ``idx``), and the CPU's calls, in the same order, run on them, so that a tie
    the two devices break otherwise does not move the rest of the step.

    On the card, each call's ``idx`` is first held to the plain search run on
    the same inputs copied to the CPU (``card`` counts: the keys are built bit
    for bit on both, so no row is expected to differ; the phase fails where a
    row differs beyond a near-tie or more than ``MAX_DIFFERING_SHARE`` of them
    differ). On the CPU, counts the rows where the CPU's own search on its own
    inputs picks other neighbours, and those of them whose swapped keys lie
    more than a bucket step apart on the CPU's keys (``cpu`` counts, logged
    only: with inputs that differ by rounding, a distance that cancels to near
    zero differs by more than a bucket step)."""

    def __init__(self, kk):
        self.kk, self.card = kk, []
        self.counts = {side: {"rows": 0, "differing": 0, "far": 0} for side in ("card", "cpu")}

    def count(self, side, idx, xs, xf, k, self_loops, mask):
        kk = self.kk
        agree, differing, far = kk.compare_neighbours(
            idx, self.select(xs, xf, k, self_loops), kk.knn_keys(xs, xf), mask)
        c = self.counts[side]
        c["rows"] += agree.numel()
        c["differing"] += differing
        c["far"] += far

    def card_search_ok(self) -> bool:
        c = self.counts["card"]
        return c["far"] == 0 and c["differing"] <= MAX_DIFFERING_SHARE * c["rows"]

    def __enter__(self):
        kk = self.kk
        self.fused, self.select = kk.knn_fused_layer, kk.knn_select_reference

        def fused(xs, xf, u1, u2m, w_d, hidden_flat, k, self_loops, want_dists, alpha, sum_agg,
                  dropout_p=0.0, seed=0, emit_idx=False):
            a = (xs, xf, u1, u2m, w_d, hidden_flat, k, self_loops, want_dists, alpha, sum_agg,
                 dropout_p, seed)
            if xs.is_cuda:
                out = self.fused(*a, emit_idx)
                idx = out[1] if emit_idx else self.fused(*a, True)[1]
                self.count("card", idx.cpu(), xs.detach().cpu(), xf.detach().cpu(), k,
                           self_loops, u2m.detach()[..., -1:].cpu())
                self.card.append(idx)
                return out
            theirs = self.card.pop(0).cpu()
            self.count("cpu", theirs, xs, xf, k, self_loops, u2m[..., -1:])
            kk.knn_select_reference = lambda *_: theirs
            try:
                return self.fused(*a, emit_idx)
            finally:
                kk.knn_select_reference = self.select

        kk.knn_fused_layer = fused
        return self

    def __exit__(self, *exc):
        self.kk.knn_fused_layer, self.kk.knn_select_reference = self.fused, self.select


class FloatWheres(TorchFunctionMode):
    """The floating values ``torch.where`` takes where its condition holds (a
    LeakyReLU's pre-activations; a key drawn on the CPU inside the call uses it
    on ints), each through ``keep``."""

    def __init__(self, keep=lambda t: t.detach().clone()):
        super().__init__()
        self.keep = keep
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.where and len(args) == 3 and args[1].is_floating_point():
            self.seen.append(self.keep(args[1]))
        return func(*args, **(kwargs or {}))


class KinkRows:
    """Phases 8, 13 and 30 (b): the rows whose LeakyReLU pre-activations lie at
    the kink, left out of a card-against-CPU step's gradients on both sides.

    A pre-activation within rounding of zero may take the other slope on the
    card than on the CPU (ROADMAP Queue 3, "Traps") and move its row's whole
    gradient, and through it every gradient upstream. Every edge-layer call of
    a step (K2 with K3, K5 with K6, or their plain versions) and every MLP
    call (``linear.MLP``: torch on both sides) is recorded on each side
    (:attr:`side`). An edge-layer call records its inputs, copied to the CPU,
    and for the knn layer the card's neighbours (``held``, phase 13's
    :class:`CardNeighbours`, which the CPU's calls run on); :meth:`flag`
    recomputes its edge chain (the kernels' plain versions) on both sides'
    inputs: a pre-activation is at the kink where the two give it opposite
    signs, or where either lies within KINK_ULPS ulps of the sum of its terms'
    magnitudes (the kernel sums in another order), and where a gradient reaches
    it (the sender unmasked, the dropout multiplier not 0); the rows are the
    call's receivers. An MLP call records the pre-activations its LeakyReLUs
    take (``torch.where`` on floats, its only such call); one is at the kink where the
    two sides' differ in sign; the rows are the output's. From then on those
    rows of the call are left out: they pass forward as they are and take no
    gradient, on both sides, so that no gradient reaches their pre-activations.
    Every other row and every tensor is then held at 1e-4 as before."""

    def __init__(self, held=None):
        self.held = held
        self.side = "card"
        self.records = {"card": [], "cpu": []}
        self.left_out: list[torch.Tensor | None] = []

    def begin(self, side: str) -> None:
        self.side = side
        self.records[side] = []

    def rows_left_out(self) -> int:
        return sum(self.rows_by_call())

    def rows_by_call(self) -> list[int]:
        return [0 if r is None else int(r.sum()) for r in self.left_out]

    def _pass(self, rec, out):
        c = len(self.records[self.side])
        self.records[self.side].append(rec)
        rows = self.left_out[c] if c < len(self.left_out) else None
        if rows is None or not rows.any():
            return out
        return torch.where(rows.to(out.device)[..., None], out.detach(), out)

    def __enter__(self):
        from mpgan_tpu_torch.ops import linear, mp

        self.mp, self.dense, self.knn = mp, mp.EdgeAggregate, mp.knn_aggregate
        self.mlp, self.mlp_forward = linear.MLP, linear.MLP.forward
        cpu = lambda t: None if t is None else t.detach().cpu().clone()  # noqa: E731
        kinks = self

        class Dense:
            @staticmethod
            def apply(u1, u2, m, alpha, sum_agg, p, seed, *hidden):
                out = kinks.dense.apply(u1, u2, m, alpha, sum_agg, p, seed, *hidden)
                rec = None if not torch.is_grad_enabled() else dict(
                    kind="dense", u1=cpu(u1), u2=cpu(u2), m=cpu(m), hidden=[cpu(t) for t in hidden],
                    alpha=alpha, p=p, seed=cpu(seed) if isinstance(seed, torch.Tensor) else seed)
                return kinks._pass(rec, out)

        def knn(xs, xf, u1, u2m, w_d, hidden, k, self_loops, want_dists, alpha, sum_agg,
                dropout_p=0.0, seed=0, **search):
            out = kinks.knn(xs, xf, u1, u2m, w_d, hidden, k, self_loops, want_dists, alpha,
                            sum_agg, dropout_p, seed, **search)
            rec = None if not torch.is_grad_enabled() else dict(
                kind="knn", xs=cpu(xs), xf=cpu(xf), u1=cpu(u1), u2m=cpu(u2m), w_d=cpu(w_d),
                hidden=[cpu(t) for t in hidden], want_dists=want_dists, alpha=alpha,
                p=dropout_p, seed=cpu(seed) if isinstance(seed, torch.Tensor) else seed,
                idx=cpu(kinks.held.card[-1]) if kinks.side == "card" and kinks.held else None)
            return kinks._pass(rec, out)

        def mlp_forward(mlp, x, train=False, rng=None, update_sn=True):
            if not torch.is_grad_enabled():
                return kinks._pass(None, kinks.mlp_forward(mlp, x, train, rng, update_sn))
            with FloatWheres(cpu) as wheres:
                out = kinks.mlp_forward(mlp, x, train, rng, update_sn)
            return kinks._pass(dict(kind="mlp", zs=wheres.seen), out)

        mp.EdgeAggregate, mp.knn_aggregate = Dense, knn
        self.mlp.forward = mlp_forward
        return self

    def __exit__(self, *exc):
        self.mp.EdgeAggregate, self.mp.knn_aggregate = self.dense, self.knn
        self.mlp.forward = self.mlp_forward

    @staticmethod
    def _chain(rec, idx):
        """A recorded call's pre-activations, the sums of their terms'
        magnitudes, and where a gradient reaches them, layer by layer."""
        from mpgan_tpu_torch.ops import knn_kernels as kk
        from mpgan_tpu_torch.ops import mp_kernels as mk

        hidden, alpha, p, seed = rec["hidden"], rec["alpha"], rec["p"], rec["seed"]
        u1 = rec["u1"]
        if rec["kind"] == "dense":
            zs, acts, mults = mk._chain_recompute(u1, rec["u2"], hidden, alpha, p, seed)
            live = (rec["m"] != 0)[:, None, :, :]
            s1 = u1.abs()[:, :, None, :] + rec["u2"].abs()[:, None, :, :]
        else:
            dists = kk._edge_dists(rec["xs"], rec["xf"], idx)[0] if rec["want_dists"] else None
            zs, acts, mults, smask = kk._knn_chain(u1, rec["u2m"], idx, dists, rec["w_d"],
                                                   hidden, alpha, p, seed)
            live = smask != 0
            senders = kk._gather_rows(rec["u2m"], idx)[..., :u1.shape[-1]]
            s1 = u1.abs()[:, :, None, :] + senders.abs()
            if dists is not None:
                s1 = s1 + (dists[..., None] * rec["w_d"]).abs()
        scales = [s1] + [acts[i].abs() @ w.abs() + b.abs()
                         for i, (w, b) in enumerate(mk._pairs(hidden))]
        lives = [live if m is None else live & (m != 0) for m in mults]
        return zs, scales, lives

    def flag(self) -> int:
        """Leave out, from the next steps on, the receiver rows of each call that
        hold an edge at the kink on either side's inputs; the number of rows
        newly left out."""
        card, cpu = self.records["card"], self.records["cpu"]
        if len(card) != len(cpu):
            raise SystemExit(f"the step made {len(card)} edge-layer calls on the card and "
                             f"{len(cpu)} on the CPU")
        new = 0
        for c, (rc, rp) in enumerate(zip(card, cpu)):
            if c >= len(self.left_out):
                self.left_out.append(None)
            if rc is None or rp is None or (rc["kind"] == "mlp" and not rc["zs"]):
                continue
            if rc["kind"] == "mlp":
                if len(rc["zs"]) != len(rp["zs"]):
                    raise SystemExit(f"MLP call {c}: {len(rc['zs'])} activations on the card, "
                                     f"{len(rp['zs'])} on the CPU")
                rows = torch.zeros(rc["zs"][0].shape[:-1], dtype=torch.bool)
                for a, b in zip(rc["zs"], rp["zs"]):
                    rows |= ((a >= 0) != (b >= 0)).any(-1)
            else:
                idx = rc.get("idx")
                (za, sa, la), (zb, sb, _) = self._chain(rc, idx), self._chain(rp, idx)
                rows = torch.zeros(za[0].shape[:2], dtype=torch.bool)
                for a, b, s_a, s_b, live in zip(za, zb, sa, sb, la):
                    tol = KINK_ULPS * 2.0**-24 * torch.maximum(s_a, s_b)
                    at = ((a >= 0) != (b >= 0)) | (a.abs() <= tol) | (b.abs() <= tol)
                    rows |= (at & live).flatten(2).any(-1)
            old = self.left_out[c]
            merged = rows if old is None else rows | old
            new += int(merged.sum()) - (0 if old is None else int(old.sum()))
            self.left_out[c] = merged
        return new


def copy_state(src, dst) -> None:
    """``dst`` (a TrainState of the same models, on any device) made equal to
    ``src``: both models' parameters and buffers, both optimizers' state
    tensors (``step`` as the optimizer on ``dst``'s device keeps it) and the key."""
    with torch.no_grad():
        for a, b in ((src.g, dst.g), (src.d, dst.d)):
            for ta, tb in zip(a.state_dict().values(), b.state_dict().values()):
                tb.copy_(ta)
        for (ma, oa), (mb, ob) in (((src.g, src.g_opt), (dst.g, dst.g_opt)),
                                   ((src.d, src.d_opt), (dst.d, dst.d_opt))):
            capturable = ob.defaults.get("capturable", False)
            for pa, pb in zip(ma.parameters(), mb.parameters()):
                ob.state.pop(pb, None)
                if pa in oa.state:
                    ob.state[pb] = {
                        k: (torch.tensor(float(v), device=pb.device if capturable else "cpu")
                            if k == "step" else v.detach().to(pb.device, copy=True))
                        for k, v in oa.state[pa].items()}
        dst.rng.copy_(src.rng)


def part_figures(state, model_name, parts) -> dict:
    """What a part of a step leaves to compare: its losses, the stepped model's
    gradients (in JAX leaf order; in its parameters' order as its optimizer
    took them, None where it took none; and laid over ``params``, None for the
    other model's), both models' parameters and buffers,
    both optimizers' state tensors (``step`` left out) and the key, on the CPU."""
    from mpgan_tpu_torch.utils.weights import jax_leaves

    cpu = lambda t: t.detach().cpu().clone()  # noqa: E731
    model = getattr(state, model_name)
    stepped = {id(p): None if p.grad is None else cpu(p.grad) for p in model.parameters()}
    return {"losses": {k: v.item() for k, v in parts.items()},
            "grads": [cpu(p.grad) if p.grad is not None else torch.zeros(p.shape)
                      for p in jax_leaves(model, True)],
            "stepped_grads": list(stepped.values()),
            "params_grads": [stepped.get(id(p)) for p in (*state.g.parameters(),
                                                           *state.d.parameters())],
            **part_state(state)}


def part_state(state) -> dict:
    """Both models' parameters and floating buffers, both optimizers' state
    tensors (``step`` left out) and the key, on the CPU."""
    cpu = lambda t: t.detach().cpu().clone()  # noqa: E731
    return {"params": [cpu(p) for p in (*state.g.parameters(), *state.d.parameters())],
            "buffers": [cpu(b) for b in (*state.g.buffers(), *state.d.buffers())
                        if b.is_floating_point()],
            "opt": [cpu(v) for opt in (state.g_opt, state.d_opt) for s in opt.state.values()
                    for k, v in s.items() if k != "step"],
            "key": cpu(state.rng)}


def part_replay(st, start, model_name, grads) -> dict:
    """The stepped model's optimizer step on the CPU state ``st`` made equal to
    ``start`` (the state both sides started from), on the card's gradients
    ``grads``: the updated state the card's step must hold (:func:`part_state`)."""
    copy_state(start, st)
    for p, g in zip(getattr(st, model_name).parameters(), grads):
        p.grad = None if g is None else g.clone()
    getattr(st, model_name + "_opt").step()
    return part_state(st)


def part_agree(c, h, r, p0, floor=1.0) -> dict:
    """A part on the card (``c``) against the CPU (``h``), both started from the
    parameters ``p0``: the losses relative to max(1, |loss|); each gradient
    and optimizer state tensor over TOL * max(``floor``, max|ref|); the buffers
    elementwise over TOL + TOL * |ref|; the updated parameters where the
    gradient is clear of zero, 1e-3, within TOL; the key bit for bit. The
    updated state is also held elementwise against
    the CPU's optimizer step on the card's own gradients (``r``,
    :func:`part_replay`): each optimizer state tensor within TOL * |ref|, each
    updated parameter within TOL * |its update| (p - p0) and an ulp of the
    parameter (both sides round p0 + update). The same elementwise figures
    against the CPU's own step are logged, not held: there the two gradients'
    difference passes through RMSprop's division, so an element whose
    gradient is a small share of its tensor's scale carries that gradient's
    error (held above, against the scale) as a large relative error."""
    tiny = torch.finfo(torch.float32).tiny
    inf = torch.tensor(float("inf"))
    ulp = lambda t: torch.nextafter(t.abs(), inf) - t.abs()  # noqa: E731
    over = lambda a, b: (a - b).abs().max().item() / (  # noqa: E731
        TOL * max(floor, b.abs().max().item(), torch.finfo(torch.float32).tiny))

    def state_over(a, b):
        return (a - b).abs() / (TOL * b.abs() + tiny)

    def update_over(a, b, p):
        return (a - b).abs() / (TOL * (b - p).abs() + ulp(torch.maximum(a.abs(), b.abs())))

    def worst(overs):
        overs = [o for o in overs if o.numel()]
        return (max([o.max().item() for o in overs] or [0.0]),
                sum(int((o > 1.0).sum()) for o in overs))

    loss_err = max(abs(c["losses"][k] - h["losses"][k]) / max(1.0, abs(h["losses"][k]))
                   for k in h["losses"])
    grads = max([over(a, b) for a, b in zip(c["grads"], h["grads"]) if b.numel()] or [0.0])
    buffers = worst([(a - b).abs() / (TOL + TOL * b.abs())
                     for a, b in zip(c["buffers"], h["buffers"])])[0]
    opt_r, _ = worst([state_over(a, b) for a, b in zip(c["opt"], r["opt"])])
    upd_r, _ = worst([update_over(a, b, p) for a, b, p in zip(c["params"], r["params"], p0)])
    opt = max([over(a, b) for a, b in zip(c["opt"], h["opt"]) if b.numel()] or [0.0])
    params = max([((a - b).abs() * (g.abs() > 1e-3)).max().item()
                  for a, b, g in zip(c["params"], h["params"], h["params_grads"])
                  if g is not None and b.numel()] or [0.0])
    opt_h, opt_h_n = worst([state_over(a, b) for a, b in zip(c["opt"], h["opt"])])
    upd_h, upd_h_n = worst([update_over(a, b, p) for a, b, p in zip(c["params"], h["params"],
                                                                   p0)])
    flips = sum(int((torch.sign(a) != torch.sign(b)).sum())
                for a, b in zip(c["params_grads"], h["params_grads"]) if a is not None)
    key = torch.equal(c["key"], h["key"])
    return {"max_rel_loss_err": loss_err, "grad_over_bound": grads, "buffer_over_bound": buffers,
            "opt_over_bound": opt, "max_param_err_where_grad_clear": params,
            "opt_over_bound_vs_replay": opt_r, "update_over_bound_vs_replay": upd_r,
            "key_bit_identical": key,
            "opt_over_bound_vs_cpu_step_logged": opt_h, "opt_elements_over_vs_cpu_step": opt_h_n,
            "update_over_bound_vs_cpu_step_logged": upd_h,
            "update_elements_over_vs_cpu_step": upd_h_n, "grad_sign_flip_elements": flips,
            "ok": (loss_err <= TOL and grads <= 1.0 and buffers <= 1.0 and opt <= 1.0
                   and params <= TOL and opt_r <= 1.0 and upd_r <= 1.0 and key)}


def part_by_part(dev, args, data, labels, steps, phase, knn=None, draws=None, mesh=None,
                 floor=1.0):
    """Beside a free-running card-against-CPU comparison: each part of each of
    ``steps`` D+G steps on the kernel path started from the same state on both
    sides. Before a part, the card's whole state (both models, their
    optimizers' state and the key) is copied into a CPU state; the part runs on
    both (the CPU on the kernels' plain versions; with ``knn``, on the card's
    neighbours, :class:`CardNeighbours`) and is held by :func:`part_agree`,
    in rounds that leave out the rows at LeakyReLU's kink (:class:`KinkRows`);
    the next part starts from the card's state after the first round (the part
    as it ran). With ``mesh`` (phase 30 (b), a rank of it), every round runs,
    the reduces being collective, and ``draws(x)`` gives the parts' draws on
    ``x``'s device; ``floor``: as :func:`part_agree`'s. Returns,
    per part, its rounds' figures, the rows each round left out and the
    receiver rows of its edge-layer calls."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.train_step import d_step, g_step, step_config

    cfg, spec = step_config(args), build_suite(args).noise
    run = {"d": lambda st, x, lab: d_step(st, cfg, spec, x, lab, mesh=mesh,
                                          draws=None if draws is None else draws(x)[0]),
           "g": lambda st, x, lab: g_step(st, cfg, spec, x, lab, mesh=mesh,
                                          draws=None if draws is None else draws(x)[1])}
    cpu_dev = torch.device("cpu")
    start = make_state(args, dev)
    replay_st = make_state(args, cpu_dev)
    out = []
    for step in range(steps):
        for part in ("d", "g"):
            held = CardNeighbours(knn) if knn is not None else None
            kinks = KinkRows(held)
            rounds, after = [], None
            with contextlib.ExitStack() as stack:
                for ctx in (held, kinks):
                    if ctx is not None:
                        stack.enter_context(ctx)
                for r in range(KINK_ROUNDS):
                    if r and mesh is not None:
                        kinks.flag()
                    figures = {}
                    p0 = [p.detach().cpu().clone() for p in (*start.g.parameters(),
                                                             *start.d.parameters())]
                    for side, device in (("card", dev), ("cpu", cpu_dev)):
                        kinks.begin(side)
                        st = make_state(args, device)
                        copy_state(start, st)
                        use_kernels(st, True)
                        parts = run[part](st, data.to(device), labels.to(device))
                        figures[side] = part_figures(st, part, parts)
                        if side == "card" and r == 0:
                            after = st
                    replay = part_replay(replay_st, start, part,
                                         figures["card"]["stepped_grads"])
                    held_r = part_agree(figures["card"], figures["cpu"], replay, p0, floor)
                    rounds.append({**held_r, "rows_left_out": kinks.rows_left_out()})
                    if mesh is None and (held_r["ok"] or kinks.flag() == 0):
                        break
            if held is not None and held.card:
                raise SystemExit(f"{phase}: {len(held.card)} knn calls on the card had no "
                                 "counterpart on the CPU")
            out.append({"step": step + 1, "part": part, "rounds": rounds,
                        "kink_rows_by_call": kinks.rows_by_call(),
                        "receiver_rows": sum(r["u1"].shape[0] * r["u1"].shape[1]
                                             for r in kinks.records["card"]
                                             if r is not None and r["kind"] != "mlp")})
            start = after
    return out


def parts_held(phase, parts, held=None) -> list:
    """Logs the parts of :func:`part_by_part` (each with the figures of its
    round ``held[i]``, by default its first round that holds, else its last);
    returns those that no round held at 1e-4."""
    rows = []
    for i, p in enumerate(parts):
        r = held[i] if held is not None else \
            next((j for j, rr in enumerate(p["rounds"]) if rr["ok"]), None)
        figures = p["rounds"][-1 if r is None else r]
        rows.append({"step": p["step"], "part": p["part"], "round_held": r,
                     "kink_rows_left_out_by_round": [rr["rows_left_out"] for rr in p["rounds"]],
                     "kink_rows_by_call": p["kink_rows_by_call"],
                     "receiver_rows_of_the_edge_calls": p["receiver_rows"],
                     **{k: v for k, v in figures.items() if k not in ("ok", "rows_left_out")}})
    log(phase, comparison="part_by_part", parts=rows, tol=TOL)
    return [row for row in rows if row["round_held"] is None]

def step_check(dev, from_args_dict, card=FLAGSHIP, batch=16, phase="step_check",
               cpu_plain_kernels=True, loss_tol=TOL, grad_tol=TOL, knn=None, parts=False,
               floor=1.0):
    """Phases 8 and 13: a D+G step at the published widths on the card against the
    CPU. The kernel path runs with dropout 0.5 against the kernels' plain
    versions on the CPU, within rtol = atol = 1e-4 (where a round misses it, the
    next leaves out the rows at LeakyReLU's kink that it found, :class:`KinkRows`,
    for at most KINK_ROUNDS rounds); with ``knn`` (the knn kernels'
    module) every K5 call's neighbours are held to the plain search on the same
    inputs, and every knn layer call on the CPU runs on the card's neighbours
    (:class:`CardNeighbours`). The card's plain path runs with dropout 0, within
    ``loss_tol`` and ``grad_tol``: against the CPU's kernel path for the dense
    layer (one function, two paths), against the CPU's plain path for the knn
    layer (``cpu_plain_kernels=False``: its two paths search differently).
    With ``parts``, the kernel path's step is also held part by part, each part
    started from the same state on both sides (:func:`part_by_part`).
    ``floor``: the kernel path's gradients are held against 1e-4 * max(floor, max|ref|) (0:
    each its own scale). Fails where the card's step leaves a model without a nonzero
    gradient (a vacuous comparison); logs each gradient's error over its own
    scale."""
    from mpgan_tpu_torch.utils.weights import jax_leaves

    data, labels = real_batch(batch, card["num_hits"])
    worst = {}
    for path, dropout in (("kernel", 0.5), ("plain", 0.0)):
        args = from_args_dict({**card, "disc_dropout": dropout})
        res = {}
        held = CardNeighbours(knn) if knn is not None and path == "kernel" else None
        cpu_kernels = path == "kernel" or cpu_plain_kernels

        ltol, gtol = (TOL, TOL) if path == "kernel" else (loss_tol, grad_tol)
        gfloor = floor if path == "kernel" else 1.0  # the plain path has no kink rounds
        kinks = KinkRows(held) if path == "kernel" else None

        def run(device, kernels):
            st = make_state(args, device)
            use_kernels(st, kernels)
            parts = step_fn(st, args, data.to(device), labels.to(device))()
            grads = [p.grad for p in jax_leaves(st.d, True) + jax_leaves(st.g, True)]
            live = {m: any(p.grad is not None and p.grad.any() for p in jax_leaves(model, True))
                    for m, model in (("d", st.d), ("g", st.g))}
            if not all(live.values()):
                raise SystemExit(f"{phase}: the step on {device} left a model without a "
                                 f"nonzero gradient {live}: the comparison would hold vacuously")
            return ({k: v.item() for k, v in parts.items()}, [gr.detach().cpu() for gr in grads])

        def agree(card_side, cpu_side):
            (lc, gc), (lp, gp) = card_side, cpu_side
            return max(abs(lc[k] - lp[k]) / max(1.0, abs(lp[k])) for k in lp) <= ltol and \
                all(wgrad_err(a, b, gtol, gfloor)[1] for a, b in zip(gc, gp))

        rounds = []
        with contextlib.ExitStack() as stack:
            for ctx in (held, kinks):
                if ctx is not None:
                    stack.enter_context(ctx)
            for _ in range(KINK_ROUNDS if kinks is not None else 1):
                for side, device, kernels in (("card", dev, path == "kernel"),
                                              ("cpu", torch.device("cpu"), cpu_kernels)):
                    if kinks is not None:
                        kinks.begin(side)
                    res[side] = run(device, kernels)
                rounds.append(0 if kinks is None else kinks.rows_left_out())
                if agree(res["card"], res["cpu"]) or kinks is None or kinks.flag() == 0:
                    break
        if held is not None:
            card_c, cpu_c = held.counts["card"], held.counts["cpu"]
            log(phase, path=path, knn_calls_held=len(held.card) == 0, rows=card_c["rows"],
                card_search_vs_plain_on_its_inputs_rows_differing=card_c["differing"],
                of_them_beyond_a_bucket_step=card_c["far"],
                max_differing_share=MAX_DIFFERING_SHARE,
                cpu_search_on_cpu_inputs_rows_differing=cpu_c["differing"],
                cpu_of_them_beyond_a_bucket_step=cpu_c["far"])
            if held.card:
                raise SystemExit(f"{phase}: {len(held.card)} knn calls on the card had no "
                                 "counterpart on the CPU")
            if not held.card_search_ok():
                raise SystemExit(f"{phase}: K5's neighbours in the step disagree with the plain "
                                 f"search on the same inputs: {card_c}")
        (lc, gc), (lp, gp) = res["card"], res["cpu"]
        loss_err = max(abs(lc[k] - lp[k]) / max(1.0, abs(lp[k])) for k in lp)
        grad_err = [wgrad_err(a, b, gtol, gfloor) for a, b in zip(gc, gp)]
        log(phase, path=path, disc_dropout=dropout, batch=batch, losses_card=lc, losses_cpu=lp,
            max_rel_loss_err=loss_err, max_abs_grad_err=max(e for e, _ in grad_err),
            max_grad_err_over_bound=max(
                (a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(gc, gp)),
            max_grad_err_over_own_scale=max(
                (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                for a, b in zip(gc, gp) if b.numel()), grad_floor=gfloor,
            loss_tol=ltol, grad_tol=gtol, tensors=len(grad_err),
            kink_rows_left_out_by_round=rounds,
            kink_rows_by_call=None if kinks is None else kinks.rows_by_call(),
            receiver_rows_of_the_edge_calls=None if kinks is None else sum(
                r["u1"].shape[0] * r["u1"].shape[1] for r in kinks.records["card"]
                if r is not None and r["kind"] != "mlp"))
        if loss_err > ltol or not all(ok for _, ok in grad_err):
            raise SystemExit(f"{phase}: D+G step on the card ({path} path) disagrees with the CPU")
        if parts and path == "kernel":
            bad = parts_held(phase, part_by_part(dev, args, data, labels, 1, phase, knn=knn,
                                                 floor=floor))
            if bad:
                raise SystemExit(f"{phase}: parts of the step started from the card's state "
                                 f"disagree with the CPU: {bad}")
        worst[path] = loss_err
    return worst


def positive_pt_fpd(t, epoch) -> tuple[int, float]:
    """The jets of the trainer's epoch-``epoch`` evaluation (its generator as it
    stands, the evaluation's key, labels and real jets, as ``Trainer.evaluate``
    makes them): how many have a pT sum that is not positive, and the FPD of the
    others, computed as ``Trainer._score`` computes it."""
    from mpgan_tpu_torch.evaluation import efps, fpd
    from mpgan_tpu_torch.training import loop
    from mpgan_tpu_torch.training.sampling import generate_multi_batch

    args, ds = t.args, t.valid_dataset
    n = min(args.eval_tot_samples, len(ds))
    sel = np.sort(np.random.default_rng(args.seed).permutation(len(ds))[:n]) \
        if args.get("eval_shuffle") else slice(None, n)
    real, _ = loop._corrected(ds.particle_normalisation(ds.particle_data[sel], inverse=True),
                              t.use_labels, zero_mask_particles=False, zero_neg_pt=False)
    gen = generate_multi_batch(t.state.g, t.spec, prng_key(epoch, t.device), n,
                               args.batch_size, labels=ds.jet_data[sel] if t.use_labels else None,
                               post_fn=t.eval_post_fn)
    jets, _ = loop._corrected(ds.particle_normalisation(gen, inverse=True), t.use_labels,
                              zero_mask_particles=t.use_labels, zero_neg_pt=False)
    positive = jets[jets[..., 2].sum(axis=1) > 0]
    gen_efps = efps(positive, select="d<=4-all", device=t.device)
    bad = ~np.isfinite(gen_efps).all(axis=1)
    if bad.any():
        gen_efps[bad] = efps(positive[bad], select="d<=4-all", use_device=False)
    m = len(positive)
    value, _ = fpd(real, positive, real_efps=t._cached_real_efps(real), gen_efps=gen_efps,
                   min_samples=min(5000, m // 2), max_samples=min(20000, m))
    return n - m, float(value)


def main_train_path(mk, train_cli, gen_cli, tmp, device="cuda"):
    """Phase 9: the train CLI with the evaluation's metrics for 2 epochs, a resume
    that restores the state, a 3rd epoch; then ``gen`` from the epoch-2 checkpoint."""
    from mpgan_tpu_torch.training import loop

    argv = ["--device", device, "--name", "smoke", "--model", "mpgan", "--jets", "g",
            "--dir-path", str(tmp), "--num-samples", "10000", "--eval-tot-samples", "2000",
            "--w1-num-samples", "1000", "--save-model-epochs", "1", "--save-epochs", "2",
            "--efp", "--fpd", "--cov-mmd"]
    mk.reset_launch_counts()
    eval_parts, eval_calls = {}, {}
    t0 = time.perf_counter()
    with timed_parts(loop, EVAL_PARTS, eval_parts, eval_calls):
        t1 = train_cli.main(argv + ["--num-epochs", "2"])
    wall = time.perf_counter() - t0
    models = tmp / "smoke" / "models"
    files = sorted(p.name for p in models.iterdir())
    before = [t.detach().cpu().clone() for t in _leaves(t1.state)]
    rng_before = t1.state.rng.clone()
    t_resume = train_cli.main(argv + ["--num-epochs", "2"])  # resume, no epoch to run
    after = [t.detach().cpu() for t in _leaves(t_resume.state)]
    restored = (t_resume.start_epoch == 2 and len(before) == len(after)
                and all(torch.equal(a, b) for a, b in zip(before, after)))
    # the resumed run holds the key the saved run ended on
    restored = restored and torch.equal(t_resume.state.rng, rng_before)
    t3 = train_cli.main(argv + ["--num-epochs", "3"])
    counts = dict(mk.launch_counts)  # the three runs: 2 epochs, the resume, the 3rd epoch
    losses = {k: t3.losses[k] for k in ("Dr", "Df", "D", "G")}
    metrics = {k: t3.losses[k] for k in ("w1p", "w1m", "w1efp", "fpd", "cov_mmd")}
    # FPD is inf (fpd.py's rule for non-finite EFP moments) where the evaluated jets
    # hold a jet whose pT sum is not positive: an early generator's, whose
    # negative pT the evaluation keeps as the reference does (train.py:744-757);
    # the FPD of the others must be finite in any case
    nonpositive, fpd_positive = positive_pt_fpd(t1, 2)
    fpd_ok = np.isfinite(fpd_positive) and (
        nonpositive > 0 or np.isfinite(np.asarray(metrics["fpd"])).all())
    finite = all(np.isfinite(v).all() for v in losses.values()) and fpd_ok and \
        all(len(v) == 1 for v in metrics.values()) and \
        all(np.isfinite(np.asarray(v)).all() for k, v in metrics.items() if k != "fpd")
    cache = tmp / "smoke" / "real_efps_d4all_g.npy"
    log("main_path_train", wall_s_2_epochs=wall, eval_parts_s=eval_parts, checkpoints=files,
        resumed_from=t_resume.start_epoch, state_restored=restored,
        epochs=len(t3.losses["G"]), losses=losses, metrics=metrics,
        eval_jets_with_nonpositive_pt_sum=nonpositive, fpd_of_the_others=fpd_positive,
        real_efp_cache=cache.exists(), best_epoch=t3.best_epoch, launches=counts)
    if files != ["state_1.npz", "state_2.npz"] or not (models / "state_3.npz").exists():
        raise SystemExit(f"train CLI checkpoints missing: {files}")
    if not cache.exists() or np.load(cache).shape != (2000, 35):
        raise SystemExit(f"train CLI: no real-EFP cache {cache.name} of 2000 x 35")
    if not restored:
        raise SystemExit("resume did not restore the saved train state")
    if not finite or len(t3.losses["G"]) != 3 or t3.losses["G"][:2] != t1.losses["G"]:
        raise SystemExit(f"train CLI losses or metrics not finite or not resumed: {losses} "
                         f"{metrics} ({nonpositive} evaluated jets with a pT sum <= 0)")
    for name in ("edge_aggregate_train", "edge_aggregate_bwd", "edge_aggregate_bwd_no_wgrads",
                 "edge_aggregate_fn"):
        if counts[name] == 0:
            raise SystemExit(f"kernel {name} never launched on the train path")

    # gen from the run's own TrainState checkpoint
    mk.reset_launch_counts()
    out = tmp / "gen_npz.npy"
    gen_cli.main(["--g-args", str(tmp / "smoke" / "smoke_args.txt"),
                  "--g-state", str(models / "state_2.npz"), "--output-file", str(out),
                  "--device", device, "--num-samples", "2000"])
    gen_counts = dict(mk.launch_counts)
    jets = np.load(out)
    log("main_path_gen_npz", jets=list(jets.shape), finite=bool(np.isfinite(jets).all()),
        launches={k: v for k, v in gen_counts.items() if v})
    if jets.shape != (2000, 30, 3) or not np.isfinite(jets).all():
        raise SystemExit(f"gen from state_2.npz: {jets.shape} not finite (2000, 30, 3)")
    if gen_counts["edge_aggregate_fn"] == 0:
        raise SystemExit("gen from state_2.npz never launched edge_aggregate_fn")
    counts["edge_aggregate_fn"] += gen_counts["edge_aggregate_fn"]
    return counts


def _leaves(state):
    from mpgan_tpu_torch.utils.weights import jax_leaves

    out = []
    for m, opt in ((state.g, state.g_opt), (state.d, state.d_opt)):
        params = jax_leaves(m, True)
        out += params + jax_leaves(m, False)
        for p in params:
            out += [v for k, v in sorted(opt.state[p].items()) if k != "step"]
    return out


def profile_steps(step, card, phase, **kv):
    """Device-time breakdown of three steps: kernel rows only. CUDA activity
    alone, since tracing every host op slows a host-bound step."""
    from torch.profiler import ProfilerActivity, profile

    # host issue time: the host's wall time to enqueue three steps after a sync
    # (an upper bound: a full launch queue makes the host wait for the device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    host_issue_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.record()
        for _ in range(3):
            step()
        e.record()
        torch.cuda.synchronize()
    window_ms = s.elapsed_time(e) / 3  # the profiled steps' own wall time
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0 and ev.self_cpu_time_total == 0:
            rows.append((dt / 1e3 / 3, ev.count // 3, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(phase, card=card, profiled_step_ms=window_ms, device_ms_per_step=busy,
        idle_share=1 - busy / window_ms, host_issue_ms=host_issue_ms,
        kernels_per_step=sum(r[1] for r in rows),
        top=[{"name": k[:90], "ms": t, "share": t / busy, "calls": c} for t, c, k in rows[:14]],
        **kv)


def train_kernel_times(mk, dev, shapes, inner=1) -> dict:
    """K3 with and without weight gradients and K2 with dropout 0.5 at each (B, N)
    of ``shapes``, kernel and plain version timed (``inner`` kernel calls a
    timing): ``{n: {kind: {shape, ms, plain_ms, bound_ms, ...}}}`` (phases 10 and
    26; below a millisecond one call a timing also times the launch's host gap)."""
    times = {}
    for b, n in shapes:
        u1, u2, mask, hidden, _, _ = kernel_inputs(dev, b, n, 3, seed=b + n)
        g = torch.randn(b, n, 192, generator=torch.Generator(device=dev).manual_seed(b + n),
                        device=dev)
        jobs = {
            "bwd": (lambda: mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, True, 0.5, 5),
                    lambda: mk.edge_aggregate_bwd_reference(u1, u2, mask, hidden, g, 0.2, True,
                                                            0.5, 5), dense_bwd_bound(b, n)),
            "bwd_no_wgrads": (
                lambda: mk.edge_aggregate_bwd(u1, u2, mask, hidden, g, 0.2, True, 0.5, 5, False),
                lambda: mk.edge_aggregate_bwd_reference(u1, u2, mask, hidden, g, 0.2, True, 0.5,
                                                        5, False),
                dense_bwd_bound(b, n, wgrads=False)),
            "train_fwd": (lambda: mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True, 0.5, 5),
                          lambda: mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, True,
                                                              0.5, 5), dense_fwd_bound(b, n)),
        }
        times[n] = {k: {"shape": f"B={b} N={n}", "ms": best_ms(kf, inner=inner),
                        "plain_ms": best_ms(pf, inner=1), **bd}
                    for k, (kf, pf, bd) in jobs.items()}
        del u1, u2, mask, hidden, g
        torch.cuda.empty_cache()
    return times


def train_timings(mk, dev, from_args_dict, card):
    """Phase 10: the D+G step, K3 and K2-train against their plain versions; a profile."""
    args = from_args_dict(FLAGSHIP)
    data, labels = (t.to(dev) for t in real_batch(256))
    st = make_state(args, dev)
    step = step_fn(st, args, data, labels)

    def run(flag):
        def f():
            use_kernels(st, flag)
            step()
        return f

    ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            ms[which] = min(ms[which], best_ms(run(which == "kernel"), inner=2))
    use_kernels(st, True)
    log("train_step_time", card=card, batch=256, n=30, kernel_ms=ms["kernel"],
        plain_ms=ms["plain"], kernel_tflops=STEP_GFLOP / ms["kernel"],
        plain_tflops=STEP_GFLOP / ms["plain"])

    times = train_kernel_times(mk, dev, ((256, 30), (32, 150)))
    log("train_kernel_times", card=card,
        **{f"{k}_{n}": v for n, by_kind in times.items() for k, v in by_kind.items()})

    profile_steps(step, card, "train_step_profile", parent_kernels_per_step=PARENT_STEP_LAUNCHES)
    return ms, times


def knn_inputs(dev, b, n, c, widths, k, seed):
    """Operands of the fused knn layer; jets hold between 1 and n real
    particles (some fewer than k), the first one all n."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, scale=0.5: torch.randn(*s, generator=g, device=dev) * scale  # noqa: E731
    xs = r(b, n, c, scale=0.3)
    counts = torch.randint(1, n + 1, (b,), generator=g, device=dev)
    counts[0] = n
    mask = (torch.arange(n, device=dev)[None, :] < counts[:, None]).float()[..., None]
    hidden = tuple(t for a, w in zip(widths[:-1], widths[1:])
                   for t in (r(a, w, scale=a ** -0.5), r(w, scale=0.1)))
    return dict(xs=xs, xf=((1 - 1e4) * mask + 1e4) * xs, u1=r(b, n, widths[0]),
                u2m=torch.cat([r(b, n, widths[0]), mask], dim=-1), w_d=r(widths[0], scale=0.3),
                hidden=hidden, g=r(b, n, widths[-1]), mask=mask)


def check_k5(kk, d, fwd, out, idx, what):
    """K5's output and ``idx`` against its plain version on the same inputs: the
    neighbours under the near-tie rule, the agreeing rows' outputs within
    rtol = atol = 1e-4. Returns the log fields; raises where they disagree."""
    ref, idx_ref, _ = kk.knn_fused_layer_reference(*fwd, emit_idx=True)
    agree, differing, far = kk.compare_neighbours(idx, idx_ref, kk.knn_keys(d["xs"], d["xf"]),
                                                  d["mask"])
    abs_err, _, bad = errors(out[agree], ref[agree])
    fields = dict(rows_differing=differing, rows_not_near_ties=far, max_abs_err=abs_err,
                  out_of_tol=bad)
    if bad or far or differing > MAX_DIFFERING_SHARE * agree.numel():
        raise SystemExit(f"knn_fused_layer disagrees with its plain version at {what}: {fields}")
    return fields


def knn_main_shape_checks(kk, dev, identical):
    """Phase 11 at the main path's shapes: K5 at B=512 eval and at B=160 with
    dropout 0.5 writing ``idx`` against its plain version and launched twice bit
    for bit; K8 on K5's ``idx`` equal to K5 bit for bit."""
    worst = 0.0
    for b, p, emit in ((512, 0.0, False), (160, 0.5, True)):
        d = knn_inputs(dev, b, 150, 32, FE, 20, seed=b + 1)
        fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], None, d["hidden"], 20, True, False, 0.2,
               True, p, 123457)
        out = kk.knn_fused_layer(*fwd, emit)[0]
        again = kk.knn_fused_layer(*fwd, emit)[0]
        out_idx, idx, _ = kk.knn_fused_layer(*fwd, True)
        out8 = kk.knn_edge_aggregate(d["u1"], d["u2m"], idx, None, None, d["hidden"], 0.2, True,
                                     p, 123457)
        torch.cuda.synchronize()
        repeat = torch.equal(out, again) and torch.equal(out, out_idx)
        k8_same = torch.equal(out8, out)
        identical["knn_fused_layer"] &= repeat
        identical["knn_edge_aggregate"] &= k8_same
        what = f"B={b} N=150 k=20 dropout {p}" + (", idx written" if emit else "")
        fields = check_k5(kk, d, fwd, out, idx, what)
        log("knn_kernel_check", kernel="knn_fused_layer", shape=what, **fields,
            two_runs_bit_identical=repeat, knn_edge_aggregate_bit_identical=k8_same)
        if not repeat or not k8_same:
            raise SystemExit(f"knn_fused_layer at {what}: bit-identical rerun {repeat}, "
                             f"K8 on its idx bit-identical {k8_same}")
        worst = max(worst, fields["max_abs_err"])
        del d, out, again, out_idx, idx, out8
        torch.cuda.empty_cache()
    return worst


def knn_kernel_checks(kk, mk, dev):
    """Phase 11: K5 and K6 against their plain versions."""
    max_err = {"knn_fused_layer": 0.0, "knn_edge_aggregate_bwd": 0.0}
    rows_differing = rows_total = 0
    for b, n, c, widths, k in ((160, 150, 32, FE, 20), (3, 13, 8, [24, 16, 12], 5)):
        d = knn_inputs(dev, b, n, c, widths, k, seed=100 + n)
        keys = kk.knn_keys(d["xs"], d["xf"])
        for self_loops, sum_agg, pos_diffs in ((True, True, False), (False, False, True),
                                               (True, False, False), (False, True, True)):
            w_d = d["w_d"] if pos_diffs else None
            for p in (0.0, 0.5):
                fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], w_d, d["hidden"], k, self_loops,
                       pos_diffs, 0.2, sum_agg, p, 123457)
                out, idx, dists = kk.knn_fused_layer(*fwd, True)
                out_eval = kk.knn_fused_layer(*fwd)[0]
                ref, idx_ref, dists_ref = kk.knn_fused_layer_reference(*fwd, True)
                torch.cuda.synchronize()
                agree, differing, far = kk.compare_neighbours(idx, idx_ref, keys, d["mask"])
                rows_differing += differing
                rows_total += agree.numel()
                abs_err, _, bad = errors(out[agree], ref[agree])
                if pos_diffs:
                    live = torch.gather(d["mask"][:, None, :, 0].expand(-1, n, -1), 2,
                                        idx_ref.long()) > 0
                    live &= agree[..., None]
                    bad += errors(dists[live], dists_ref[live])[2]
                same = torch.equal(out, out_eval)
                log("knn_kernel_check", kernel="knn_fused_layer", b=b, n=n, k=k, dropout=p,
                    self_loops=self_loops, sum_agg=sum_agg, pos_diffs=pos_diffs,
                    rows_differing=differing, rows_not_near_ties=far, max_abs_err=abs_err,
                    out_of_tol=bad, launch_without_idx_equal=same)
                if bad or far or not same or differing > MAX_DIFFERING_SHARE * agree.numel():
                    raise SystemExit(f"knn_fused_layer disagrees at b={b} n={n} p={p} "
                                     f"self_loops={self_loops} sum={sum_agg} dists={pos_diffs}")
                max_err["knn_fused_layer"] = max(max_err["knn_fused_layer"], abs_err)
                for need in (True, False):
                    bwd = (d["u1"], d["u2m"], idx_ref, dists_ref, w_d, d["hidden"], d["g"], 0.2,
                           sum_agg, p, 123457, need)
                    res = kk.knn_edge_aggregate_bwd(*bwd)
                    again = kk.knn_edge_aggregate_bwd(*bwd)
                    rref = kk.knn_edge_aggregate_bwd_reference(*bwd)
                    torch.cuda.synchronize()
                    flat = lambda t: [x for x in (*t[:5], *t[5]) if x is not None]  # noqa: E731
                    repeat = all(torch.equal(x, y) for x, y in zip(flat(res), flat(again)))
                    # dmask of a masked sender sums activations at the scale of its
                    # pushed-away distance (1e4 under pos_diffs), with cancellation: it is
                    # held to the weight gradients' bound, the real senders' to the strict one
                    real = d["mask"] > 0
                    errs = [errors(o, r) for o, r in ((res[0], rref[0]), (res[1], rref[1]),
                                                      (res[2][real], rref[2][real]))]
                    if pos_diffs:
                        errs.append(errors(res[3], rref[3]))
                    wpairs = list(zip(res[5], rref[5])) + ([(res[4], rref[4])] if pos_diffs
                                                           else [])
                    wpairs.append((res[2][~real], rref[2][~real]))
                    werrs = [wgrad_err(o, r) for o, r in wpairs]
                    bad = sum(e[2] for e in errs) + sum(not ok for _, ok in werrs)
                    wgrads_out = [o for o in (*res[5], res[4]) if o is not None]
                    if not need and any(o.any().item() for o in wgrads_out):
                        bad += 1
                    err = max([e[0] for e in errs] + [e for e, _ in werrs[:-1]])
                    log("knn_kernel_check", kernel="knn_edge_aggregate_bwd", b=b, n=n, k=k,
                        dropout=p, wgrads=need, sum_agg=sum_agg, pos_diffs=pos_diffs,
                        max_abs_err_du1_du2_dmask_ddists=[e[0] for e in errs],
                        max_abs_err_wgrads=[e for e, _ in werrs[:-1]],
                        max_abs_err_dmask_of_masked_senders=werrs[-1][0], failures=bad,
                        two_runs_bit_identical=repeat)
                    if bad or not repeat:
                        raise SystemExit(f"knn_edge_aggregate_bwd disagrees at b={b} n={n} p={p} "
                                         f"wgrads={need} sum={sum_agg} dists={pos_diffs}")
                    max_err["knn_edge_aggregate_bwd"] = max(max_err["knn_edge_aggregate_bwd"],
                                                            err)
                del out, ref, res, again, rref
        del d, keys
        torch.cuda.empty_cache()
    log("knn_neighbour_rows", compared=rows_total, differing=rows_differing,
        share=rows_differing / rows_total, bound=MAX_DIFFERING_SHARE)
    return max_err


def knn_generation(mk, gen_cli, dev, card):
    """Phase 12: the 150-particle knn-20 generation path."""
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.models.mpgan import MPGenerator
    from mpgan_tpu_torch.training.config import build_mpgan_generator, from_args_dict
    from mpgan_tpu_torch.training.sampling import generate_multi_batch, noise_spec
    from mpgan_tpu_torch.utils.weights import mp_generator_to_reference_sd

    args = from_args_dict(KNN150)
    cfg = build_mpgan_generator(args)
    g_cpu = MPGenerator(cfg, prng_key(3, "cpu"))
    g = MPGenerator(cfg, prng_key(3, "cpu"), device=dev)
    spec = noise_spec("mpgan", {"latent_node_size": 32}, 150, args.sd)
    ds = JetNetDataset("g", num_particles=150, split="valid")
    lab = ds.jet_data[np.random.default_rng(0).choice(len(ds), size=2048)]
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate_multi_batch(g, spec, prng_key(1, dev), 2048, 512,
                               labels=lab)
    wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "card.txt").write_text(repr(args.to_dict()))
        torch.save(mp_generator_to_reference_sd(g_cpu), tmp / "G.pt")
        t0 = time.perf_counter()
        gen_cli.main(["--g-args", str(tmp / "card.txt"), "--g-state", str(tmp / "G.pt"),
                      "--output-file", str(tmp / "gen.npy"), "--device", "cuda", "--seed", "0",
                      "--num-samples", "2048", "--batch-size", "512"])
        wall_cli = time.perf_counter() - t0
        jets = np.load(tmp / "gen.npy")
    launches = dict(mk.launch_counts)
    counts = (lab[:, -1].astype(np.float32) * 150).astype(np.int32)
    if out.shape != (2048, 150, 4) or not np.isfinite(out).all():
        raise SystemExit(f"150p knn output {out.shape} is not finite (2048, 150, 4)")
    if not np.array_equal((out[..., -1] + 0.5).sum(1), counts):
        raise SystemExit("150p knn mask counts disagree with the labels")
    if jets.shape != (2048, 150, 3) or not np.isfinite(jets).all():
        raise SystemExit(f"knn gen CLI output {jets.shape} is not finite (2048, 150, 3)")
    if not np.array_equal(np.any(jets != 0, axis=-1).sum(axis=1), counts) \
            or (jets[:, :, 2] < 0).any():
        raise SystemExit("knn gen CLI output: masked particles not zero or negative pT")
    log("main_path_150p_knn20", jets=list(out.shape), wall_s=wall, cli_jets=list(jets.shape),
        cli_wall_s=wall_cli, launches=launches)
    if launches["knn_fused_layer"] != 2 * 4 * 2:  # 2 layers, 4 batches, both entry points
        raise SystemExit(f"knn generation launched K5 {launches['knn_fused_layer']} times, not 16")

    # 8 jets against the same path through the plain versions (CPU), whose knn calls
    # run on the card's neighbours (CardNeighbours, as phase 13: the two devices round
    # the second layer's inputs otherwise and may break a near-tie otherwise; the
    # card's search is held to the plain search on its own inputs); the sampler's
    # batch against the plain path
    from mpgan_tpu_torch.ops import knn_kernels as kk

    noise = torch.randn(512, 150, 32, generator=torch.Generator(device=dev).manual_seed(2),
                        device=dev) * 0.2
    labels = torch.as_tensor(lab[:512], device=dev)
    kernel_cfg, plain_cfg = cfg, dataclasses.replace(cfg, use_kernels=False)
    g_cpu.cfg = dataclasses.replace(cfg, use_kernels=True)
    held = CardNeighbours(kk)
    with torch.inference_mode():
        y_k = g(noise, labels)
        y_own = g_cpu(noise[:8].cpu(), labels[:8].cpu()).to(dev)  # the CPU's own search
        with held:
            y_k8 = g(noise[:8], labels[:8])
            y_ref = g_cpu(noise[:8].cpu(), labels[:8].cpu()).to(dev)
        g.cfg = plain_cfg
        y_p = g(noise, labels)
        g.cfg = kernel_cfg
    abs_err, rel_err, bad = errors(y_k8, y_ref)
    own_err, _, own_bad = errors(y_k[:8], y_own)
    p_err, _, p_bad = errors(y_k, y_p)
    share = p_bad / y_p.numel()
    card_c, cpu_c = held.counts["card"], held.counts["cpu"]
    log("knn_generator_check", n=150, jets_vs_plain_versions=8,
        max_abs_err_vs_plain_versions=abs_err, out_of_tol_vs_plain_versions=bad,
        card_8_jets_bit_identical_to_its_512=torch.equal(y_k8, y_k[:8]),
        rows=card_c["rows"], card_search_vs_plain_on_its_inputs_rows_differing=card_c[
            "differing"], of_them_beyond_a_bucket_step=card_c["far"],
        cpu_search_on_cpu_inputs_rows_differing=cpu_c["differing"],
        max_abs_err_vs_plain_versions_own_search=own_err,
        out_of_tol_vs_plain_versions_own_search=own_bad,
        jets_vs_plain_path=512, max_abs_err_vs_plain_path=p_err,
        share_beyond_tol_vs_plain_path=share, max_share=MAX_PLAIN_PATH_SHARE)
    if held.card or not held.card_search_ok():
        raise SystemExit(f"150p knn generator: K5's neighbours disagree with the plain search "
                         f"on the same inputs ({card_c}, {len(held.card)} calls unmatched)")
    if bad or not torch.equal(y_k8[..., -1], y_ref[..., -1]):
        raise SystemExit("150p knn generator: kernel path disagrees with its plain versions")
    if share > MAX_PLAIN_PATH_SHARE or not torch.equal(y_k[..., -1], y_p[..., -1]):
        raise SystemExit("150p knn generator: kernel path too far from the plain path")

    def run(c):
        def f():
            g.cfg = c
            with torch.inference_mode():
                g(noise, labels)
        return f

    ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            ms[which] = min(ms[which], best_ms(run(kernel_cfg if which == "kernel"
                                                   else plain_cfg)))
    g.cfg = kernel_cfg
    log("generation_rate", card=card, n=150, knn=20, batch=512, kernel_ms=ms["kernel"],
        plain_ms=ms["plain"], kernel_jets_per_s=512 / ms["kernel"] * 1e3,
        plain_jets_per_s=512 / ms["plain"] * 1e3)
    return launches


def knn_train_path(mk, train_cli, tmp):
    """Phase 14: the train CLI on the 150-particle knn-20 model at its default
    batch, 2 epochs, then a resume that restores the state exactly."""
    argv = ["--device", "cuda", "--name", "knn", "--model", "mpgan", "--jets", "g",
            "--num-hits", "150", "--no-fully-connected", "--num-knn", "20",
            "--dir-path", str(tmp), "--num-samples", "3200", "--eval-tot-samples", "640",
            "--w1-num-samples", "320", "--save-model-epochs", "1", "--save-epochs", "2",
            "--num-epochs", "2"]
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    t1 = train_cli.main(argv)
    wall = time.perf_counter() - t0
    before = [t.detach().cpu().clone() for t in _leaves(t1.state)]
    rng_before = t1.state.rng.clone()
    t2 = train_cli.main(argv)  # resume, no epoch to run
    counts = dict(mk.launch_counts)
    after = [t.detach().cpu() for t in _leaves(t2.state)]
    restored = (t2.start_epoch == 2 and len(before) == len(after)
                and all(torch.equal(a, b) for a, b in zip(before, after))
                and torch.equal(t2.state.rng, rng_before))
    batch = t1.args.batch_size
    steps = 2 * (len(t1.train_dataset) // batch)
    eval_batches = -(-min(t1.args.eval_tot_samples, len(t1.valid_dataset)) // batch)
    # per D+G step: D on real and fake (D step) and G and D (G step) emit idx, 2 layers
    # each; K6 with weight gradients for D twice and G once, without for D in the G step;
    # the D step's fake batch and the evaluation run K5 without idx
    predicted = {"knn_fused_layer_train": 8 * steps, "knn_edge_aggregate_bwd": 6 * steps,
                 "knn_edge_aggregate_bwd_no_wgrads": 2 * steps,
                 "knn_fused_layer": 2 * steps + 2 * eval_batches}
    losses = {k: t1.losses[k] for k in ("Dr", "Df", "D", "G")}
    finite = all(np.isfinite(v).all() for v in losses.values()) and \
        all(np.isfinite(np.asarray(t1.losses[k])).all() for k in ("w1p", "w1m"))
    files = sorted(f.name for f in (tmp / "knn" / "models").iterdir())
    log("main_path_train_knn20", wall_s_2_epochs=wall, batch=batch, steps=steps,
        eval_batches=eval_batches, checkpoints=files, resumed_from=t2.start_epoch,
        state_restored=restored, losses=losses, w1m=t1.losses["w1m"], launches=counts,
        predicted=predicted)
    if batch != 160 or not all(not c.fully_connected and c.num_knn == 20
                               for c in t1.state.d.cfg.layers + t1.state.g.cfg.layers):
        raise SystemExit("knn train CLI did not build the knn-20 model at batch 160")
    if files != ["state_1.npz", "state_2.npz"] or not restored:
        raise SystemExit(f"knn train CLI: checkpoints {files}, state restored: {restored}")
    if not finite or len(t1.losses["G"]) != 2 or t2.losses["G"] != t1.losses["G"]:
        raise SystemExit(f"knn train CLI losses not finite or not resumed: {losses}")
    for name, want in predicted.items():
        if counts[name] != want:
            raise SystemExit(f"knn train path launched {name} {counts[name]} times, "
                             f"predicted {want}")
    if any(v for k, v in counts.items() if k not in predicted):
        raise SystemExit(f"knn train path launched a dense kernel: {counts}")
    return counts


def knn_timings(kk, dev, from_args_dict, card):
    """Phase 15: the knn D+G step at B=128 N=150 and K5/K6 beside their plain versions."""
    args = from_args_dict(KNN150)
    data, labels = (t.to(dev) for t in real_batch(128, 150))
    st = make_state(args, dev)
    step = step_fn(st, args, data, labels)

    def run(flag):
        def f():
            use_kernels(st, flag)
            step()
        return f

    ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            ms[which] = min(ms[which], best_ms(run(which == "kernel"), inner=2))
    log("train_step_time", card=card, batch=128, n=150, knn=20, kernel_ms=ms["kernel"],
        plain_ms=ms["plain"])
    use_kernels(st, True)
    profile_steps(step, card, "knn_train_step_profile", batch=128, n=150, knn=20)
    del st, step
    torch.cuda.empty_cache()

    times = {}
    d = knn_inputs(dev, 512, 150, 32, FE, 20, seed=8)
    fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], None, d["hidden"], 20, True, False, 0.2, True)
    out = kk.knn_fused_layer(*fwd)[0]
    log("knn_kernel_check", kernel="knn_fused_layer", stage="timings",
        **check_k5(kk, d, fwd, out, kk.knn_fused_layer(*fwd, emit_idx=True)[1],
                   "B=512 eval, timed"))
    times["eval"] = dict(
        shape="B=512 N=150 k=20 eval",
        ms=best_ms(lambda: kk.knn_fused_layer(*fwd), inner=1),
        plain_ms=best_ms(lambda: kk.knn_fused_layer_reference(*fwd), inner=1),
        **bound(2 * 512 * 150 * (20 * macs(FE) + 150 * 33),
                nbytes(d["xs"], d["xf"], d["u1"], d["u2m"], *d["hidden"], out)))
    del d, fwd, out
    torch.cuda.empty_cache()
    d = knn_inputs(dev, 160, 150, 32, FE, 20, seed=9)
    fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], None, d["hidden"], 20, True, False, 0.2, True,
           0.5, 5)
    out, idx, _ = kk.knn_fused_layer(*fwd, True)
    log("knn_kernel_check", kernel="knn_fused_layer", stage="timings",
        **check_k5(kk, d, fwd, out, idx, "B=160 dropout 0.5 with idx, timed"))
    rows = 160 * 150 * 20
    times["train"] = dict(
        shape="B=160 N=150 k=20 dropout 0.5, idx written",
        ms=best_ms(lambda: kk.knn_fused_layer(*fwd, True), inner=1),
        plain_ms=best_ms(lambda: kk.knn_fused_layer_reference(*fwd, True), inner=1),
        **bound(2 * rows * macs(FE) + 2 * 160 * 150 * 150 * 33,
                nbytes(d["xs"], d["xf"], d["u1"], d["u2m"], *d["hidden"], out, idx)))
    for need in (True, False):
        bwd = (d["u1"], d["u2m"], idx, None, None, d["hidden"], d["g"], 0.2, True, 0.5, 5, need)
        res = kk.knn_edge_aggregate_bwd(*bwd)
        grads = (*res[:3], *(res[5] if need else ()))
        times["bwd" if need else "bwd_no_wgrads"] = dict(
            shape="B=160 N=150 k=20 dropout 0.5, " + ("with" if need else "without")
            + " weight gradients",
            ms=best_ms(lambda: kk.knn_edge_aggregate_bwd(*bwd), inner=1),
            plain_ms=best_ms(lambda: kk.knn_edge_aggregate_bwd_reference(*bwd), inner=1),
            **bound((3 if need else 2) * 2 * rows * macs(FE),
                    nbytes(d["u1"], d["u2m"], idx, d["g"], *d["hidden"], *grads)))
        del res, grads
    log("knn_kernel_times", card=card, **times)
    return ms, times


def gapt_flops(b, n, e, layers, feat):
    """FLOP of the GAPT generator forward: per layer the qkv, out and ff
    projections and the two attention products, then the final FC."""
    per_layer = 2 * n * e * 3 * e + 4 * n * n * e + 2 * (2 * n * e * e)
    return b * (layers * per_layer + 2 * n * e * feat)


def gapt_kernel_inputs(dev, g, b, masked, seed):
    cfg = g.cfg
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, cfg.num_particles, cfg.embed_dim, generator=gen, device=dev) * 0.2
    mask = None
    if masked:
        counts = torch.randint(1, cfg.num_particles + 1, (b,), generator=gen, device=dev)
        counts[0] = cfg.num_particles
        mask = (torch.arange(cfg.num_particles, device=dev)[None, :]
                < counts[:, None]).float()[..., None]
    return x, mask


def gapt_kernel_checks(gk, dev, from_args_dict):
    """Phase 16: K9 against its plain version, and a rerun bit for bit, at the shapes that
    are timed and that the main paths launch (B=4096 walks several items a CTA)."""
    from mpgan_tpu_torch.models.registry import build_suite

    worst, identical = 0.0, True
    for n, b, masked in ((30, 1024, True), (30, 1024, False), (30, 37, True), (30, 1023, False),
                         (30, 4096, True), (150, 128, True), (150, 512, True)):
        g = build_suite(from_args_dict({**GAPT, "num_hits": n})).generator(
            prng_key(n, "cpu"), device=dev)
        x, mask = gapt_kernel_inputs(dev, g, b, masked, seed=b)
        w = g.fused_weights()
        plan = gk.gapt_plan(b, n, g.cfg.embed_dim, g.cfg.num_heads,
                            torch.cuda.get_device_properties(dev).multi_processor_count)
        with torch.no_grad():
            out = gk.gapt_g_fused(x, mask, w, g.cfg.num_heads, 0.2)
            again = gk.gapt_g_fused(x, mask, w, g.cfg.num_heads, 0.2)
            torch.cuda.synchronize()
            ref = gk.gapt_g_fused_reference(x, mask, w, g.cfg.num_heads, 0.2)
        abs_err, rel_err, bad = errors(out, ref)
        mask_equal = (not masked) or torch.equal(out[..., -1], ref[..., -1])
        same = torch.equal(out, again)
        log("gapt_kernel_check", kernel="gapt_g_fused", b=b, n=n, e=g.cfg.embed_dim,
            heads=g.cfg.num_heads, layers=g.cfg.sab_layers, masked=masked,
            jets_an_item=plan.jets, items=plan.items, max_abs_err=abs_err, max_rel_err=rel_err,
            out_of_tol=bad, mask_column_bit_identical=mask_equal, two_runs_bit_identical=same)
        if bad or not mask_equal or not same or out.shape != ref.shape \
                or not torch.isfinite(out).all():
            raise SystemExit(f"gapt_g_fused disagrees with its plain version or with its rerun "
                             f"at b={b} n={n} masked={masked}")
        worst = max(worst, abs_err)
        identical &= same
    return worst, identical


def gapt_generation(mk, gen_cli, dev, card, from_args_dict):
    """Phase 17: 50,000 default GAPT jets through the gen CLI, and
    ``generate_multi_batch`` on both routes."""
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.sampling import generate_multi_batch
    from mpgan_tpu_torch.utils.weights import gapt_generator_to_reference_sd

    args = from_args_dict(GAPT)
    suite = build_suite(args)
    g_cpu = suite.generator(prng_key(5, "cpu"))
    batch, total = 4096, 50000
    mk.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "card.txt").write_text(repr(args.to_dict()))
        torch.save(gapt_generator_to_reference_sd(g_cpu), tmp / "G.pt")
        t0 = time.perf_counter()
        gen_cli.main(["--g-args", str(tmp / "card.txt"), "--g-state", str(tmp / "G.pt"),
                      "--output-file", str(tmp / "gen.npy"), "--device", "cuda", "--seed", "0",
                      "--num-samples", str(total), "--batch-size", str(batch)])
        wall = time.perf_counter() - t0
        jets = np.load(tmp / "gen.npy")
    launches = dict(mk.launch_counts)
    ds = JetNetDataset("g", num_particles=30, split="valid")
    labels = ds.jet_data[np.random.default_rng(0).choice(len(ds), size=total)]
    counts = (labels[:, -1].astype(np.float32) * 30).astype(np.int32)
    if jets.shape != (total, 30, 3) or not np.isfinite(jets).all():
        raise SystemExit(f"GAPT gen output {jets.shape} is not finite ({total}, 30, 3)")
    if not np.array_equal(np.any(jets != 0, axis=-1).sum(axis=1), counts) \
            or (jets[:, :, 2] < 0).any():
        raise SystemExit("GAPT gen output: masked particles not zero or negative pT")
    batches = -(-total // batch)
    log("main_path_gapt_gen", jets=list(jets.shape), wall_s=wall, batch=batch,
        batches=batches, launches=launches)
    if launches["gapt_g_fused"] != batches or sum(launches.values()) != batches:
        raise SystemExit(f"GAPT generation launched K9 {launches['gapt_g_fused']} times over "
                         f"{batches} batches (all launches: {launches})")

    # generate_multi_batch at B=1024 on both routes, from the same noise
    g = suite.generator(prng_key(5, "cpu"), device=dev)
    lab = labels[:8192]
    outs = {}
    for route, flag in (("kernel", None), ("plain", False)):
        g.cfg = dataclasses.replace(g.cfg, use_kernels=flag)
        mk.reset_launch_counts()
        outs[route] = generate_multi_batch(g, suite.noise,
                                           prng_key(1, dev), 8192,
                                           1024, labels=lab)
        outs[route + "_launches"] = mk.launch_counts["gapt_g_fused"]
    g.cfg = dataclasses.replace(g.cfg, use_kernels=None)
    yk, yp = torch.from_numpy(outs["kernel"]), torch.from_numpy(outs["plain"])
    abs_err, _, bad = errors(yk, yp)
    log("gapt_generator_check", jets=list(yk.shape), batch=1024, max_abs_err=abs_err,
        out_of_tol=bad, kernel_route_launches=outs["kernel_launches"],
        plain_route_launches=outs["plain_launches"])
    if bad or not torch.equal(yk[..., -1], yp[..., -1]) or yk.shape != (8192, 30, 4):
        raise SystemExit("GAPT generator: kernel route disagrees with the plain route")
    if outs["kernel_launches"] != 8 or outs["plain_launches"] != 0:
        raise SystemExit("GAPT generate_multi_batch: K9 launch counts are not 8 and 0")
    if not np.array_equal((outs["kernel"][..., -1] + 0.5).sum(1),
                          (lab[:, -1].astype(np.float32) * 30).astype(np.int32)):
        raise SystemExit("GAPT mask counts disagree with the labels")
    return launches["gapt_g_fused"] + outs["kernel_launches"]


def gapt_train_path(mk, train_cli, tmp):
    """Phase 19: the train CLI on default GAPT at batch 512: 2 epochs, a resume
    that restores the state, a 3rd epoch; K9 launches as predicted."""
    argv = ["--device", "cuda", "--name", "gapt", "--model", "gapt", "--jets", "g",
            "--dir-path", str(tmp), "--num-samples", "10000", "--eval-tot-samples", "2000",
            "--w1-num-samples", "1000", "--save-model-epochs", "1", "--save-epochs", "2"]
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    t1 = train_cli.main(argv + ["--num-epochs", "2"])
    wall = time.perf_counter() - t0
    models = tmp / "gapt" / "models"
    files = sorted(p.name for p in models.iterdir())
    before = [t.detach().cpu().clone() for t in _leaves(t1.state)]
    rng_before = t1.state.rng.clone()
    t2 = train_cli.main(argv + ["--num-epochs", "2"])  # resume, no epoch to run
    after = [t.detach().cpu() for t in _leaves(t2.state)]
    restored = (t2.start_epoch == 2 and len(before) == len(after)
                and all(torch.equal(a, b) for a, b in zip(before, after))
                and torch.equal(t2.state.rng, rng_before))
    t3 = train_cli.main(argv + ["--num-epochs", "3"])
    counts = dict(mk.launch_counts)
    batch = t1.args.batch_size
    steps = 3 * (len(t1.train_dataset) // batch)
    eval_batches = -(-min(t1.args.eval_tot_samples, len(t1.valid_dataset)) // batch)
    # the D step's fake batch comes from G in eval mode: one K9 launch a step; the
    # evaluation at epoch 2 generates eval_batches batches; G in train mode and D
    # take the plain path
    predicted = steps + eval_batches
    losses = {k: t3.losses[k] for k in ("Dr", "Df", "D", "G")}
    finite = all(np.isfinite(v).all() for v in losses.values()) and \
        all(np.isfinite(np.asarray(t3.losses[k])).all() for k in ("w1p", "w1m"))
    log("main_path_train_gapt", wall_s_2_epochs=wall, batch=batch, steps=steps,
        eval_batches=eval_batches, checkpoints=files, resumed_from=t2.start_epoch,
        state_restored=restored, epochs=len(t3.losses["G"]), losses=losses,
        w1m=t3.losses["w1m"], launches=counts, predicted_gapt_g_fused=predicted)
    if batch != 512 or type(t1.state.g).__name__ != "GAPTGenerator" \
            or type(t1.state.d).__name__ != "GAPTDiscriminator":
        raise SystemExit("GAPT train CLI did not build the default GAPT at batch 512")
    if files != ["state_1.npz", "state_2.npz"] or not (models / "state_3.npz").exists() \
            or not restored:
        raise SystemExit(f"GAPT train CLI: checkpoints {files}, state restored: {restored}")
    if not finite or len(t3.losses["G"]) != 3 or t3.losses["G"][:2] != t1.losses["G"]:
        raise SystemExit(f"GAPT train CLI losses not finite or not resumed: {losses}")
    if counts["gapt_g_fused"] != predicted or sum(counts.values()) != predicted:
        raise SystemExit(f"GAPT train path launched {counts}, predicted gapt_g_fused "
                         f"{predicted} and nothing else")
    return counts["gapt_g_fused"]


def gapt_timings(gk, dev, from_args_dict, card):
    """Phase 20: GAPT generation and step times, K9 beside its bound."""
    import torch.nn.functional as F

    from mpgan_tpu_torch.models.registry import build_suite

    args = from_args_dict(GAPT)
    suite = build_suite(args)
    g = suite.generator(prng_key(5, "cpu"), device=dev)
    cfg = g.cfg
    rates = {}
    for b in (1024, 4096):
        noise = torch.randn(b, 30, cfg.embed_dim, device=dev) * 0.2
        lab = torch.as_tensor(
            (np.random.default_rng(b).integers(1, 31, size=(b, 1)) / 30).astype(np.float32),
            device=dev)

        def run(flag):
            def f():
                g.cfg = dataclasses.replace(cfg, use_kernels=flag)
                with torch.inference_mode():
                    g(noise, lab)
            return f

        ms = {"kernel": float("inf"), "plain": float("inf")}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for which in order:
                ms[which] = min(ms[which], best_ms(run(None if which == "kernel" else False)))
        rates[b] = ms
        log("generation_rate", card=card, model="gapt", n=30, batch=b, kernel_ms=ms["kernel"],
            plain_ms=ms["plain"], kernel_jets_per_s=b / ms["kernel"] * 1e3,
            plain_jets_per_s=b / ms["plain"] * 1e3)
    g.cfg = cfg

    # K9 alone at the main path's shapes, beside its plain version and its bound
    times = {}
    w = g.fused_weights()
    for b in (1024, 4096):
        x, mask = gapt_kernel_inputs(dev, g, b, True, seed=b + 1)
        with torch.no_grad():
            out = gk.gapt_g_fused(x, mask, w, cfg.num_heads, 0.2)
            times[b] = dict(
                shape=f"B={b} N=30 E=64 H=4 L=4 masked",
                ms=best_ms(lambda: gk.gapt_g_fused(x, mask, w, cfg.num_heads, 0.2)),
                plain_ms=best_ms(lambda: gk.gapt_g_fused_reference(x, mask, w, cfg.num_heads,
                                                                   0.2)),
                **bound(gapt_flops(b, 30, cfg.embed_dim, cfg.sab_layers, cfg.feat_size),
                        nbytes(x, mask, out, *w)))
        # the attention stage alone through the library, as a yardstick: the port never calls it
        hd = cfg.embed_dim // cfg.num_heads
        q, k, v = (torch.randn(b, cfg.num_heads, 30, hd, device=dev) for _ in range(3))
        times[b]["sdpa_attention_stage_ms_per_layer"] = best_ms(
            lambda: F.scaled_dot_product_attention(q, k, v))
    g150 = build_suite(from_args_dict({**GAPT, "num_hits": 150})).generator(
        prng_key(6, "cpu"), device=dev)
    x, mask = gapt_kernel_inputs(dev, g150, 512, True, seed=3)
    w150 = g150.fused_weights()
    with torch.no_grad():
        out = gk.gapt_g_fused(x, mask, w150, 4, 0.2)
        times[150] = dict(
            shape="B=512 N=150 E=64 H=4 L=4 masked",
            ms=best_ms(lambda: gk.gapt_g_fused(x, mask, w150, 4, 0.2), inner=1),
            plain_ms=best_ms(lambda: gk.gapt_g_fused_reference(x, mask, w150, 4, 0.2), inner=1),
            **bound(gapt_flops(512, 150, 64, 4, 3), nbytes(x, mask, out, *w150)))
    log("gapt_kernel_times", card=card, **{f"b{k}" if k != 150 else "n150": v
                                          for k, v in times.items()})
    del x, mask, out, g150

    # the D+G step at the default batch
    data, labels = (t.to(dev) for t in real_batch(512))
    st = make_state(args, dev)
    step = step_fn(st, args, data, labels)

    def run_step(flag):
        def f():
            use_kernels(st, flag)
            step()
        return f

    step_ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            step_ms[which] = min(step_ms[which],
                                 best_ms(run_step(None if which == "kernel" else False), inner=2))
    use_kernels(st, None)
    log("train_step_time", card=card, model="gapt", batch=512, n=30,
        kernel_ms=step_ms["kernel"], plain_ms=step_ms["plain"])
    profile_steps(step, card, "gapt_train_step_profile", batch=512, n=30)
    return rates, times, step_ms


def set_knn_route(kernel=None, select=None):
    """Set or clear the two variables the knn layer reads at call time."""
    import os

    for name, value in (("MPGAN_TPU_KNN_KERNEL", kernel), ("MPGAN_TPU_KNN_SELECT", select)):
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


def knn_split_checks(kk, dev):
    """Phase 21, first half: K7 and K8 against their plain versions and K5, and
    K8 -> K6 gradients against the plain backward, at the published widths."""
    b, n, c, k = 160, 150, 32, 20
    d = knn_inputs(dev, b, n, c, FE, k, seed=21)
    err = {"knn_search": 0.0, "knn_edge_aggregate": 0.0}
    for self_loops, pos_diffs, sum_agg in ((True, False, True), (False, True, False)):
        w_d = d["w_d"] if pos_diffs else None
        idx, dists = kk.knn_search(d["xs"], d["xf"], k, self_loops, pos_diffs)
        idx_ref, dists_ref = kk.knn_search_reference(d["xs"], d["xf"], k, self_loops, pos_diffs)
        _, idx5, dists5 = kk.knn_fused_layer(d["xs"], d["xf"], d["u1"], d["u2m"], w_d,
                                             d["hidden"], k, self_loops, pos_diffs, 0.2, sum_agg,
                                             0.0, 0, True)
        torch.cuda.synchronize()
        rows_plain = int((idx != idx_ref).any(dim=-1).sum())
        rows_k5 = int((idx != idx5).any(dim=-1).sum())
        dist_err, dist_bad, dists_equal_k5 = 0.0, 0, True
        if pos_diffs:
            live = torch.gather(d["mask"][:, None, :, 0].expand(-1, n, -1), 2, idx.long()) > 0
            dist_err, _, dist_bad = errors(dists[live], dists_ref[live])
            dists_equal_k5 = torch.equal(dists, dists5)
        log("knn_split_check", kernel="knn_search", b=b, n=n, k=k, self_loops=self_loops,
            want_dists=pos_diffs, rows_differing_from_plain=rows_plain,
            rows_differing_from_k5=rows_k5, max_abs_err_dists=dist_err,
            dists_out_of_tol=dist_bad, dists_bit_identical_to_k5=dists_equal_k5)
        if rows_plain or rows_k5 or dist_bad or not dists_equal_k5:
            raise SystemExit(f"knn_search disagrees at self_loops={self_loops} "
                             f"dists={pos_diffs}")
        err["knn_search"] = max(err["knn_search"], dist_err)
        for p in (0.0, 0.5):
            agg = (d["u1"], d["u2m"], idx, dists, w_d, d["hidden"], 0.2, sum_agg, p, 123457)
            out = kk.knn_edge_aggregate(*agg)
            ref = kk.knn_edge_aggregate_reference(*agg)
            out5 = kk.knn_fused_layer(d["xs"], d["xf"], d["u1"], d["u2m"], w_d, d["hidden"], k,
                                      self_loops, pos_diffs, 0.2, sum_agg, p, 123457)[0]
            torch.cuda.synchronize()
            abs_err, _, bad = errors(out, ref)
            same = torch.equal(out, out5)
            log("knn_split_check", kernel="knn_edge_aggregate", b=b, n=n, k=k, dropout=p,
                sum_agg=sum_agg, pos_diffs=pos_diffs, max_abs_err=abs_err, out_of_tol=bad,
                bit_identical_to_k5=same)
            if bad or not same:
                raise SystemExit(f"knn_edge_aggregate disagrees at p={p} sum={sum_agg} "
                                 f"dists={pos_diffs}")
            err["knn_edge_aggregate"] = max(err["knn_edge_aggregate"], abs_err)

            # K8 -> K6 through the Function against autograd through the plain chain
            def grads(kernel):
                ins = [d[key].clone().requires_grad_() for key in ("u1", "u2m")]
                wd = None if w_d is None else w_d.clone().requires_grad_()
                dd = None if dists is None else dists.clone().requires_grad_()
                hidden = [t.clone().requires_grad_() for t in d["hidden"]]
                if kernel:
                    o = kk.KnnEdgeAggregate.apply(*ins, idx, dd, wd, 0.2, sum_agg, p, 123457,
                                                  *hidden)
                else:
                    o = kk.knn_edge_aggregate_reference(*ins, idx, dd, wd, hidden, 0.2, sum_agg,
                                                        p, 123457)
                (o * d["g"]).sum().backward()
                return [t.grad for t in ins] + ([dd.grad] if dd is not None else []), \
                    [t.grad for t in hidden] + ([wd.grad] if wd is not None else [])

            (kin, kw), (pin, pw) = grads(True), grads(False)
            torch.cuda.synchronize()
            real = d["mask"] > 0
            # u2m's mask column of a masked sender sums activations at the scale of its
            # pushed-away distance: held to the weight gradients' bound, as in phase 11
            in_errs = [errors(kin[0], pin[0]), errors(kin[1][..., :-1], pin[1][..., :-1]),
                       errors(kin[1][..., -1:][real], pin[1][..., -1:][real])]
            if pos_diffs:
                in_errs.append(errors(kin[2], pin[2]))
            werrs = [wgrad_err(a, r) for a, r in zip(kw, pw)]
            werrs.append(wgrad_err(kin[1][..., -1:][~real], pin[1][..., -1:][~real]))
            bad = sum(e[2] for e in in_errs) + sum(not ok for _, ok in werrs)
            log("knn_split_check", kernel="knn_edge_aggregate -> knn_edge_aggregate_bwd",
                dropout=p, sum_agg=sum_agg, pos_diffs=pos_diffs,
                max_abs_err_du1_du2_dmask_ddists=[e[0] for e in in_errs],
                max_abs_err_wgrads=[e for e, _ in werrs], failures=bad)
            if bad:
                raise SystemExit(f"K8 -> K6 gradients disagree at p={p} dists={pos_diffs}")
    return err


def knn_split_route(kk, mk, dev, from_args_dict, card):
    """Phase 21, second half: the knn-20 model generates and trains on route 3
    (K7 -> K8 -> K6); times beside route 4; kernel times and bounds."""
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.sampling import generate_multi_batch

    args = from_args_dict(KNN150)
    suite = build_suite(args)
    g = suite.generator(prng_key(3, "cpu"), device=dev)
    ds = JetNetDataset("g", num_particles=150, split="valid")
    lab = ds.jet_data[np.random.default_rng(0).choice(len(ds), size=1024)]
    data, labels = (t.to(dev) for t in real_batch(128, 150))
    st = make_state(args, dev)
    step = step_fn(st, args, data, labels)
    try:
        set_knn_route("3")
        mk.reset_launch_counts()
        out3 = generate_multi_batch(g, suite.noise, prng_key(1, dev),
                                    1024, 512, labels=lab)
        parts = step()
        parts = {k: v.item() for k, v in step().items()}
        torch.cuda.synchronize()
        launches = dict(mk.launch_counts)
        set_knn_route()
        out4 = generate_multi_batch(g, suite.noise, prng_key(1, dev),
                                    1024, 512, labels=lab)
        # 2 generation batches x 2 layers, and per D+G step 10 forwards x ... as phase 14 counts:
        # 8 layer forwards with a gradient and 2 without, 6 K6 with and 2 without weight gradients
        predicted = {"knn_search": 4 + 2 * 10, "knn_edge_aggregate": 4 + 2 * 10,
                     "knn_edge_aggregate_bwd": 2 * 6, "knn_edge_aggregate_bwd_no_wgrads": 2 * 2}
        same = np.array_equal(out3, out4)
        log("main_path_knn_route3", jets=list(out3.shape), steps=2, step_losses=parts,
            launches=launches, predicted=predicted, generation_bit_identical_to_route4=same)
        if out3.shape != (1024, 150, 4) or not np.isfinite(out3).all() or not same:
            raise SystemExit("knn route 3 generation is not finite or differs from route 4")
        if not all(np.isfinite(v) for v in parts.values()):
            raise SystemExit(f"knn route 3 step losses not finite: {parts}")
        if {k: v for k, v in launches.items() if v} != predicted:
            raise SystemExit(f"knn route 3 launched {launches}, predicted {predicted}")

        noise = torch.randn(512, 150, 32, device=dev) * 0.2
        glab = torch.as_tensor(lab[:512], device=dev)

        def gen_on(route):
            def f():
                set_knn_route(route)
                with torch.inference_mode():
                    g(noise, glab)
            return f

        def step_on(route):
            def f():
                set_knn_route(route)
                step()
            return f

        gen_ms = {"3": float("inf"), "4": float("inf")}
        step_ms = {"3": float("inf"), "4": float("inf")}
        for order in (("4", "3"), ("3", "4")):
            for route in order:
                gen_ms[route] = min(gen_ms[route], best_ms(gen_on(route)))
                step_ms[route] = min(step_ms[route], best_ms(step_on(route), inner=2))
        log("knn_route_times", card=card, n=150, knn=20, generation_batch=512,
            generation_ms_route3=gen_ms["3"], generation_ms_route4=gen_ms["4"],
            jets_per_s_route3=512 / gen_ms["3"] * 1e3, jets_per_s_route4=512 / gen_ms["4"] * 1e3,
            step_batch=128, step_ms_route3=step_ms["3"], step_ms_route4=step_ms["4"])
    finally:
        set_knn_route()
    del st, step, g
    torch.cuda.empty_cache()

    times = {}
    for b, name in ((512, "eval"), (160, "train")):
        d = knn_inputs(dev, b, 150, 32, FE, 20, seed=b)
        p = (0.0, 0) if name == "eval" else (0.5, 5)
        idx, _ = kk.knn_search(d["xs"], d["xf"], 20, True)
        times[f"search_{name}"] = dict(
            shape=f"B={b} N=150 C=32 k=20",
            ms=best_ms(lambda: kk.knn_search(d["xs"], d["xf"], 20, True)),
            plain_ms=best_ms(lambda: kk.knn_search_reference(d["xs"], d["xf"], 20, True),
                             inner=1),
            **bound(2 * b * 150 * 150 * 33, nbytes(d["xs"], d["xf"], idx)))
        agg = (d["u1"], d["u2m"], idx, None, None, d["hidden"], 0.2, True, *p)
        out = kk.knn_edge_aggregate(*agg)
        times[f"aggregate_{name}"] = dict(
            shape=f"B={b} N=150 k=20" + (" eval" if name == "eval" else " dropout 0.5"),
            ms=best_ms(lambda: kk.knn_edge_aggregate(*agg), inner=1),
            plain_ms=best_ms(lambda: kk.knn_edge_aggregate_reference(*agg), inner=1),
            **bound(2 * b * 150 * 20 * macs(FE),
                    nbytes(d["u1"], d["u2m"], idx, *d["hidden"], out)))
        del d, idx, out, agg
        torch.cuda.empty_cache()
    # with the distances, as the search writes them at B=160
    d = knn_inputs(dev, 160, 150, 32, FE, 20, seed=7)
    idx, dists = kk.knn_search(d["xs"], d["xf"], 20, True, True)
    times["search_dists"] = dict(
        shape="B=160 N=150 C=32 k=20 with distances",
        ms=best_ms(lambda: kk.knn_search(d["xs"], d["xf"], 20, True, True)),
        plain_ms=best_ms(lambda: kk.knn_search_reference(d["xs"], d["xf"], 20, True, True),
                         inner=1),
        **bound(2 * 160 * 150 * (150 * 33 + 20 * 3 * 32), nbytes(d["xs"], d["xf"], idx, dists)))
    log("knn_split_kernel_times", card=card, **times)
    return launches, times


EVAL_JETS = 50000  # the loop's evaluation size (eval_tot_samples' default)
EVAL_F64_ROWS = {30: 2000, 150: 256}  # real jets whose card EFPs are held to float64
EVAL_PARTS = ("generate_multi_batch", "w1p", "w1m", "efps", "w1efp", "fpd", "cov_mmd")


def efp_plan_squares() -> int:
    """The most ``[chunk, N, N]`` tensors ``efps`` holds at once over the 20
    primes' plans: theta, the factors its plan made so far and the step's
    result (``evaluation/efp.py::_run_plan``; theta's places in the list are one
    tensor); at least 2, theta and the temporary that builds it."""
    from mpgan_tpu_torch.evaluation.efp import contraction_plan, efp_multigraphs

    peak = 2
    for graph in efp_multigraphs(4):
        # per factor in the plan's list: a square the plan made (not theta, not z)
        made = [False] * (len(graph) + len({v for e in graph for v in e}))
        for i, j, spec in contraction_plan(graph):
            square = len(spec.split("->")[1]) == 3
            peak = max(peak, 1 + sum(made) + square)
            for k in sorted((i, j), reverse=True):
                made.pop(k)
            made.append(square)
    return peak


@contextlib.contextmanager
def timed_parts(module, names, times, calls):
    """Wrap the functions ``names`` of ``module``: each call's wall time (the
    device synchronised before and after) adds to ``times[name]``, and its
    arguments, result and peak device memory above what was allocated before it
    go to ``calls[name]``."""
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def inner(*args, **kw):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            calls.setdefault(name, []).append((args, kw, out, peak))
            return out
        return inner

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def positive_pt_metrics(calls, compute=True) -> tuple[int, list | None, list | None]:
    """An evaluation's generated jets (as ``Trainer._score`` passed them to
    ``w1efp`` and ``fpd``, recorded by :func:`timed_parts`): how many have a pT
    sum that is not positive and, with ``compute``, the w1efp and FPD of the
    others, on the same real jets, EFPs and arguments."""
    from mpgan_tpu_torch.training import loop

    (real, gen), w_kw, _, _ = calls["w1efp"][0]
    keep = gen[..., 2].sum(axis=1) > 0
    m = int(keep.sum())
    if not compute:
        return len(gen) - m, None, None
    w1em, w1es = loop.w1efp(real, gen[keep], **w_kw)
    (real_f, gen_f), f_kw, _, _ = calls["fpd"][0]
    f_kw = dict(f_kw, gen_efps=f_kw["gen_efps"][keep], min_samples=min(5000, m // 2),
                max_samples=min(20000, m))
    return len(gen) - m, [*w1em, *w1es], list(loop.fpd(real_f, gen_f[keep], **f_kw))


def evaluation(mk, dev, card, tmp):
    """Phase 22: ``Trainer.eval_save_plot`` at the loop's size (50,000 jets
    against 50,000 synthetic real jets, ``--efp --fpd --cov-mmd``) for the flagship
    30p and the 150p dense generator, twice each (the first computes the real
    side's EFP cache), timed by part; then the checks on what the parts were
    given and returned."""
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.evaluation import efp
    from mpgan_tpu_torch.evaluation.cov_mmd import _pairwise_emd
    from mpgan_tpu_torch.training import loop
    from mpgan_tpu_torch.training.config import from_args_dict

    squares = efp_plan_squares()
    launches = {}
    for n, kernel in ((30, "edge_aggregate_fn"), (150, "edge_aggregate")):
        args = from_args_dict({**FLAGSHIP, "num_hits": n, "name": f"eval{n}",
                               "dir_path": str(tmp), "efp": True, "fpd": True, "cov_mmd": True})
        valid = JetNetDataset(
            "g", num_particles=n, split="valid", split_fraction=(0.0, 1.0),
            synthetic_num_jets=EVAL_JETS, mask_feature=args.get("mask", False),
            num_particles_label=bool(args.clabels or args.get("mask_c")))
        trainer = loop.Trainer(args, valid_dataset=valid, device=dev)
        mk.reset_launch_counts()
        runs = []
        for epoch in (1, 2):
            times, calls = {}, {}
            with timed_parts(loop, EVAL_PARTS, times, calls):
                t0 = time.perf_counter()
                trainer.eval_save_plot(epoch)
                torch.cuda.synchronize()
                times["total"] = time.perf_counter() - t0
            times["other"] = times["total"] - sum(times[k] for k in EVAL_PARTS)
            runs.append((times, calls))
        launches[kernel] = mk.launch_counts[kernel]
        if launches[kernel] == 0:
            raise SystemExit(f"evaluation at {n}p never launched {kernel}")

        calls = runs[0][1]
        (real,), real_kw, real_efps, _ = calls["efps"][0]
        gen_norm = calls["generate_multi_batch"][0][2]
        metrics = {k: trainer.losses[k] for k in ("w1efp", "fpd", "cov_mmd")}
        if gen_norm.shape != (EVAL_JETS, n, 4) or not np.isfinite(gen_norm).all():
            raise SystemExit(f"evaluation at {n}p: generated {gen_norm.shape}, not finite")
        # as phase 9: an untrained generator's evaluated jets may hold a jet whose pT
        # sum is not positive, whose EFPs are not finite (w1efp nan, FPD inf); the
        # metrics of the others must be finite in any case
        nonpositive, others = [], []
        for i, (_, run_calls) in enumerate(runs):
            finite = all(len(v) == 2 and np.isfinite(np.asarray(v[i])).all()
                         for v in metrics.values())
            left, w1e, fpd_v = positive_pt_metrics(run_calls, compute=not finite)
            nonpositive.append(left)
            others.append(None if finite else {"w1efp": w1e, "fpd": fpd_v})
            cov_ok = np.isfinite(np.asarray(metrics["cov_mmd"][i])).all()
            if not finite and not (left > 0 and cov_ok and np.isfinite(w1e).all()
                                   and np.isfinite(fpd_v).all()):
                raise SystemExit(f"evaluation at {n}p: metrics not finite: {metrics} ({left} "
                                 f"jets with a pT sum <= 0; the others' {others[-1]})")
        if len(real) * n * n <= efp.DEVICE_THRESHOLD["cuda"] or real_efps.shape != (EVAL_JETS, 35):
            raise SystemExit(f"evaluation at {n}p: the real EFPs did not take the device path")
        # the card's FP32 EFPs against the float64 path (the JAX package's bar)
        rows = EVAL_F64_ROWS[n]
        ref = efp.efps(real[:rows], select="d<=4-all", use_device=False)
        got = real_efps[:rows]
        efp_rel = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))
        efp_bad = int((np.abs(got - ref) > 1e-9 + 2e-3 * np.abs(ref)).sum())
        # peak memory of the FP32 EFP calls against the plan's squares
        efp_peak = max(peak for _, kw, _, peak in calls["efps"] if kw.get("use_device") is None)
        # + 2: a copy einsum may make of an operand, and one of slack
        efp_bound = (squares + 2) * min(4096, EVAL_JETS) * n * n * 4
        f64_rows = [len(a[0]) for r in runs for a, kw, _, _ in r[1]["efps"]
                    if kw.get("use_device") is False]
        # the Sinkhorn EMD: three float64 tensors of the cost's size at once, one of slack
        (cov_real, cov_gen), cov_kw, _, cov_peak = calls["cov_mmd"][0]
        cov_n = cov_kw["num_eval_samples"]
        cov_bound = 4 * 8 * cov_n * cov_n * (n + 1) ** 2
        emd_rel = None
        if n == 30:
            # the first batch cov_mmd drew, on the card and on the CPU
            rng = np.random.default_rng(42)
            ri = rng.choice(len(cov_real), size=cov_n, replace=False)
            gi = rng.choice(len(cov_gen), size=cov_n, replace=False)
            pair = (cov_gen[gi][:, :, :3], cov_real[ri][:, :, :3])
            on_card = _pairwise_emd(*pair, device=dev)
            on_cpu = _pairwise_emd(*pair, device="cpu")
            emd_rel = float(np.max(np.abs(on_card - on_cpu) / np.abs(on_cpu)))
        log("evaluation", card=card, n=n, jets=EVAL_JETS, batch=args.batch_size,
            seconds=[r[0] for r in runs], metrics=metrics, launches=launches[kernel],
            jets_with_nonpositive_pt_sum=nonpositive, metrics_of_the_others=others,
            efp_rel_err_f64=efp_rel, efp_rows_beyond_tol=efp_bad, efp_rows_checked=rows,
            efp_peak_bytes=efp_peak, efp_bound_bytes=efp_bound, plan_squares=squares,
            gen_rows_recomputed_f64=f64_rows, cov_mmd_peak_bytes=cov_peak,
            cov_mmd_bound_bytes=cov_bound, emd_rel_err_cpu=emd_rel)
        if efp_bad:
            raise SystemExit(f"evaluation at {n}p: {efp_bad} EFP values of the card beyond "
                             "rtol 2e-3, atol 1e-9 of the float64 path")
        if efp_peak > efp_bound or cov_peak > cov_bound:
            raise SystemExit(f"evaluation at {n}p: peak memory {efp_peak} (EFPs), {cov_peak} "
                             f"(cov_mmd) above the bounds {efp_bound}, {cov_bound}")
        if emd_rel is not None and emd_rel > 1e-9:
            raise SystemExit(f"evaluation: the card's EMD is {emd_rel} from the CPU's")
        del trainer, runs, calls
        torch.cuda.empty_cache()
    return launches


# phase 23: every generator/discriminator family of the reference's trained_models/ but
# mp (phases 4-10): (model, model_D, extra flags); the legacy families take the MPGAN
# learning rates (their presets set none) and MPGAN's widths
LEGACY_LR = ["--lr-disc", "3e-5", "--lr-gen", "1e-5"]
ZOO = {
    "fc": ("rgan", "rgan", []),
    "fcmp": ("rgan", "mpgan", []),
    "fcpnet": ("rgan", "pointnet", []),
    "graphcnn": ("graphcnngan", "rgan", []),
    "graphcnnmp": ("graphcnngan", "mpgan", []),
    "graphcnnpnet": ("graphcnngan", "pointnet", []),
    "mpfc": ("old_mpgan", "rgan", ["--lfc", *LEGACY_LR]),
    # --mask-c: the args processing clears it for old_mpgan, as the reference's does
    "mplfc": ("old_mpgan", "mpgan", ["--lfc", "--mask-c", *LEGACY_LR]),
    "mppnet": ("mpgan", "pointnet", []),
    "pcgan": ("pcgan", "pcgan", []),
    "treeganfc": ("treegan", "rgan", []),
    "treeganmp": ("treegan", "mpgan", []),
    "treeganpnet": ("treegan", "pointnet", []),
    "old_mpgan": ("old_mpgan", "old_mpgan", LEGACY_LR),
}
ZOO_BATCHES = 7  # batches an epoch: 7 D steps and, at num_critic 5, 2 G steps
# the shipped mplfc card: the legacy generator with lfc and its masks (mask_c), MPGAN's D
MPLFC_CARD = {"model": "old_mpgan", "model_D": "mpgan", "jets": "g", "num_hits": 30,
              "lfc": True, "lr_disc": 3e-5, "lr_gen": 1e-5}


def legacy_card(from_args_dict):
    """``from_args_dict`` for the mplfc card: its mask flags set after the processing."""
    def build(d):
        args = from_args_dict(d)
        args.mask = args.mask_c = True
        return args
    return build


def zoo_timings(t, dev):
    """A trained family's D+G step at its batch and its generation rate at B=4096
    (CUDA events, best of 3); the point decoder is part of PCGAN's generation."""
    from mpgan_tpu_torch.training.train_step import d_step, epoch_kwargs, g_step

    st, b = t.state, t.args.batch_size
    data_all, labels_all = t._stage(t._staged_loader)
    data = data_all[:b]
    labels = labels_all[:b] if labels_all is not None else None

    def step():
        d_step(st, t.step_cfg, t.spec, data, labels, post_gen=t.post_gen,
               encode_real=t.suite.encode_real, epoch=t.model_epoch)
        g_step(st, t.step_cfg, t.spec, data, labels, post_gen=t.post_gen, epoch=t.model_epoch)

    gb = 4096
    noise = t.spec.sample(prng_key(3, dev), gb)
    points = t.spec.sample_points(prng_key(4, dev), gb)
    glabels = None
    if labels_all is not None:
        glabels = labels_all[torch.arange(gb, device=dev) % len(labels_all)]

    def generate():
        with torch.inference_mode():
            out = st.g(noise, glabels, update_sn=False, **epoch_kwargs(st.g, t.model_epoch))
            if t.eval_post_fn is not None:
                out = t.eval_post_fn(out, points)
        return out

    return best_ms(step, inner=1), best_ms(generate, inner=1), gb


def model_zoo(mk, train_cli, gen_cli, dev, card, from_args_dict, tmp):
    """Phase 23: the model zoo. Each family of ``ZOO`` through the train CLI on
    synthetic gluon jets with its presets and the reference's default widths
    (30 particles; TreeGAN rounds to 32), one epoch of ``ZOO_BATCHES`` batches
    with a checkpoint and the evaluation, then 2,000 jets through the gen CLI
    from its ``state_1.npz``; PCGAN's G_inv and G_pc are seeded random weights
    written here. The legacy generator's kernel path against its plain path at
    B=4096 (mpfc as trained, and the mplfc card with its masks), one mplfc D+G
    step on the card against the CPU, and each family's step time and
    generation rate. Counters reset before, read after: K4, K2 with dropout and
    K3 with and without weight gradients must have launched."""
    from mpgan_tpu_torch.cli.args import parse_cli
    from mpgan_tpu_torch.models.ext.pcgan import GInv, GPc
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.models.ext import pcgan_config

    weights = tmp / "pcgan_weights"
    weights.mkdir()
    pc_cfg = pcgan_config(from_args_dict({"model": "pcgan", "jets": "g"}))
    torch.save(GInv(pc_cfg, prng_key(21, "cpu")).state_dict(),
               weights / "pcgan_G_inv_g.pt")
    torch.save(GPc(pc_cfg, prng_key(22, "cpu")).state_dict(),
               weights / "pcgan_G_pc_g.pt")

    mk.reset_launch_counts()
    results, trainers = {}, {}
    for fam, (model, model_d, extra) in ZOO.items():
        argv = ["--device", str(dev), "--name", fam, "--model", model, "--model-D", model_d,
                "--jets", "g", "--dir-path", str(tmp), "--eval-tot-samples", "2000",
                "--w1-num-samples", "1000", "--num-epochs", "1", "--save-epochs", "1",
                "--pcgan-weights-dir", str(weights), *extra]
        args = parse_cli(argv[2:])
        batch = args.batch_size
        # ZOO_BATCHES training batches (70% of the jets), at least the evaluation's 2,000
        args.num_samples = max(-(-ZOO_BATCHES * batch * 10 // 7) + 10, 3000)
        # one epoch: the rGAN-D presets set 1000 or 2000 over the command line
        args.num_epochs = 1
        t0 = time.perf_counter()
        t = train_cli.run(args, dev)
        wall = time.perf_counter() - t0
        losses = {k: t.losses[k][-1] for k in t.d_loss_keys + ["G"]}
        state = tmp / fam / "models" / "state_1.npz"
        out = tmp / f"{fam}_gen.npy"
        gen_cli.main(["--g-args", str(tmp / fam / f"{fam}_args.txt"), "--g-state", str(state),
                      "--output-file", str(out), "--device", str(dev), "--num-samples", "2000",
                      "--batch-size", "1000"])
        jets = np.load(out)
        ok = (np.isfinite(list(losses.values())).all() and state.exists()
              and jets.shape == (2000, t.args.num_hits, 3) and np.isfinite(jets).all()
              and np.isfinite(np.asarray(t.losses["w1m"])).all())
        step_ms, gen_ms, gb = zoo_timings(t, dev)
        results[fam] = {"g": type(t.state.g).__name__, "d": type(t.state.d).__name__,
                        "batch": batch, "num_hits": t.args.num_hits, "loss": t.args.loss,
                        "gp": t.args.gp, "num_critic": t.args.num_critic,
                        "mask_c": bool(t.args.mask_c), "losses": losses,
                        "w1m": t.losses["w1m"][-1], "jets": list(jets.shape), "wall_s": wall,
                        "step_ms": step_ms, "gen_batch": gb, "gen_ms": gen_ms,
                        "jets_per_s": gb / gen_ms * 1e3}
        log("zoo_family", card=card, family=fam, model=model, model_D=model_d, **results[fam])
        if not ok:
            raise SystemExit(f"zoo {fam}: losses, checkpoint or generated jets not as expected")
        trainers[fam] = t

    # the legacy generator: kernel path against plain path at the sampler's batch
    mplfc_args = legacy_card(from_args_dict)(MPLFC_CARD)
    mplfc_g = build_suite(mplfc_args).generator(prng_key(4, "cpu"), device=dev)
    lab = torch.as_tensor((np.random.default_rng(2).integers(1, 31, size=(4096, 1)) / 30)
                          .astype(np.float32), device=dev)
    for name, g, labels in (("mpfc", trainers["mpfc"].state.g, None), ("mplfc", mplfc_g, lab)):
        noise = torch.randn(4096, 128, generator=torch.Generator(device=dev).manual_seed(5),
                            device=dev) * 0.2
        kernel_cfg = g.cfg
        with torch.inference_mode():
            y_k = g(noise, labels, update_sn=False)
            g.cfg = dataclasses.replace(kernel_cfg, use_kernels=False)
            y_p = g(noise, labels, update_sn=False)
            g.cfg = kernel_cfg
        abs_err, rel_err, bad = errors(y_k, y_p)
        mask_equal = labels is None or torch.equal(y_k[..., -1], y_p[..., -1])
        log("zoo_generator_check", family=name, batch=4096, features=y_k.shape[-1],
            max_abs_err=abs_err, max_rel_err=rel_err, out_of_tol=bad,
            mask_column_equal=mask_equal)
        if bad or not mask_equal or y_k.shape[-1] != (4 if labels is not None else 3):
            raise SystemExit(f"zoo {name}: the legacy generator's kernel path disagrees with "
                             "its plain path")

    step_check(dev, legacy_card(from_args_dict), card=MPLFC_CARD, batch=16,
               phase="zoo_step_check")
    counts = dict(mk.launch_counts)
    log("zoo_launches", launches=counts)
    for name in ("edge_aggregate_fn", "edge_aggregate_train", "edge_aggregate_bwd",
                 "edge_aggregate_bwd_no_wgrads"):
        if counts[name] == 0:
            raise SystemExit(f"zoo: kernel {name} never launched on the model zoo's paths")
    return counts, results


# phases 24-26: FPND at the loop's size, the train CLI with every flag, train_mnist
FPND_JETS = 50000  # the protocol's jets a side (train.py:549-555)
FPND_CPU_JETS = 2000  # jets a side whose activations the CPU path recomputes
FPND_TOL = 1e-4  # rtol = atol on activations: FP32 on both, products in another order
# jets whose activations may lie beyond FPND_TOL: a block 2-3 neighbour search in the
# learned features can swap two near-tied neighbours when the card rounds otherwise
MAX_FPND_SWAP_SHARE = 0.01
FPND_REL_TOL = 1e-3  # the card's FPND against the CPU's on the same jets
AUG_FLAGS = ["--aug-t", "--aug-f", "--aug-r90", "--aug-s"]
MNIST_SHAPES = ((32, 75), (32, 100))  # (batch, particles) of the MNIST defaults' D and G
# clouds the MoNet scores on the host an evaluation (its Python graclus loop makes a
# cloud cost the host tens of milliseconds, PERF.md)
MNIST_FID_JETS = 256


def fpnd_flops(n=30) -> int:
    """FLOPs of the ParticleNet trunk for one jet: the edge MLPs on n * k edges and the
    shortcuts on n particles (products only)."""
    from mpgan_tpu_torch.evaluation.fpnd import CONV_WIDTHS, INPUT_DIMS, K

    flops, cin = 0, INPUT_DIMS
    for block in CONV_WIDTHS:
        flops += 2 * n * K * macs([2 * cin, *block]) + 2 * n * cin * block[-1]
        cin = block[-1]
    return flops


def corrected(ds, norm):
    from mpgan_tpu_torch.data.jetnet import gen_jet_corrections

    return gen_jet_corrections(ds.particle_normalisation(norm, inverse=True),
                               ret_mask_separate=True, zero_mask_particles=True,
                               zero_neg_pt=False)[0]


def fpnd_phase(mk, dev, card, from_args_dict):
    """Phase 24: FPND at the loop's size. The flagship 30p generator (K4) makes
    50,000 jets, scored against 50,000 synthetic real jets on the random trunk:
    activations on the card and moments on the host, timed apart; the card's
    activations of 2,000 jets a side against the CPU path's, and the FPND of
    those 2,000 a side on the card against the CPU's."""
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.evaluation import fpnd as F
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.sampling import generate_multi_batch

    args = from_args_dict(FLAGSHIP)
    suite = build_suite(args)
    g = suite.generator(prng_key(0, "cpu"), device=dev)
    ds = JetNetDataset("g", num_particles=30, split="valid", split_fraction=(0.0, 1.0),
                       synthetic_num_jets=FPND_JETS, mask_feature=True, num_particles_label=True)
    real = corrected(ds, ds.particle_data)
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    gen_norm = generate_multi_batch(g, suite.noise, prng_key(1, dev),
                                    FPND_JETS, args.batch_size, labels=ds.jet_data)
    gen_s = time.perf_counter() - t0
    launches = mk.launch_counts["edge_aggregate_fn"]
    gen = corrected(ds, gen_norm)
    if gen.shape != (FPND_JETS, 30, 3) or not np.isfinite(gen).all() or launches == 0:
        raise SystemExit(f"fpnd: generated {gen.shape}, finite {np.isfinite(gen).all()}, "
                         f"K4 launches {launches}")

    params = F.particlenet_init()
    F.activations(params, real[:256], device=dev)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a_real = F.activations(params, real, device=dev)
    a_gen = F.activations(params, gen, device=dev)
    act_s = time.perf_counter() - t0  # ends in the host copy, so synchronised
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    score = F.frechet_from_activations(a_real, a_gen)
    host_s = time.perf_counter() - t0

    m = FPND_CPU_JETS
    t0 = time.perf_counter()
    c_real = F.activations(params, real[:m], device="cpu")
    c_gen = F.activations(params, gen[:m], device="cpu")
    cpu_s = time.perf_counter() - t0
    card_acts = np.concatenate([a_real[:m], a_gen[:m]])
    cpu_acts = np.concatenate([c_real, c_gen])
    err = np.abs(card_acts - cpu_acts)
    beyond = (err > FPND_TOL + FPND_TOL * np.abs(cpu_acts)).any(axis=1)
    sub_card = F.frechet_from_activations(a_real[:m], a_gen[:m])
    sub_cpu = F.frechet_from_activations(c_real, c_gen)
    rel = abs(sub_card - sub_cpu) / abs(sub_cpu)
    flops = fpnd_flops() * 2 * FPND_JETS
    log("fpnd", card=card, jets_a_side=FPND_JETS, fpnd=score, generation_s=gen_s,
        k4_launches=launches, activations_s=act_s, host_moments_s=host_s,
        activation_tflop=flops / 1e12, activation_tflops=flops / act_s / 1e12,
        peak_device_bytes=peak, cpu_jets_a_side=m, cpu_activations_s=cpu_s,
        act_max_abs_err=float(err.max()), jets_beyond_tol=int(beyond.sum()),
        jets_beyond_tol_share=float(beyond.mean()), max_share=MAX_FPND_SWAP_SHARE,
        fpnd_card_on_cpu_jets=sub_card, fpnd_cpu=sub_cpu, fpnd_rel_err=rel,
        fpnd_rel_tol=FPND_REL_TOL)
    if not np.isfinite(score) or score <= 0:
        raise SystemExit(f"fpnd: {score} at the loop's size")
    if beyond.mean() > MAX_FPND_SWAP_SHARE or rel > FPND_REL_TOL:
        raise SystemExit(f"fpnd: the card's activations ({beyond.sum()} jets beyond {FPND_TOL}) "
                         f"or FPND ({rel} relative) disagree with the CPU's")
    return launches


def trace_kernels(trace: pathlib.Path) -> dict[str, int]:
    """Kernel events in a Chrome trace by port kernel: K2 (``edge_aggregate_kernel``
    without the node MLP), K4 (with it) and K3 (``edge_aggregate_bwd_kernel``)."""
    import re

    counts = {"edge_aggregate": 0, "edge_aggregate_fn": 0, "edge_aggregate_bwd": 0}
    for ev in json.loads(trace.read_text())["traceEvents"]:
        name = ev.get("name", "")
        if ev.get("cat") != "kernel" or "edge_aggregate" not in name:
            continue
        if "edge_aggregate_bwd_kernel" in name:
            counts["edge_aggregate_bwd"] += 1
        elif "edge_aggregate_kernel" in name:
            fused = re.search(r"edge_aggregate_kernel<\s*(true|\(bool\)1|1)\s*[,>]", name)
            counts["edge_aggregate_fn" if fused else "edge_aggregate"] += 1
    return counts


class LogRecords(logging.Handler):
    """The records of the port's loggers while the context is open (INFO and up)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records, self.root_level = [], None

    def __enter__(self):
        root = logging.getLogger()
        self.root_level = root.level
        root.setLevel(logging.INFO)
        root.addHandler(self)
        return self

    def emit(self, record):
        self.records.append(record.getMessage())

    def __exit__(self, *exc):
        root = logging.getLogger()
        root.removeHandler(self)
        root.setLevel(self.root_level)


def train_cli_all_flags(mk, train_cli, dev, card, from_args_dict, tmp):
    """Phase 25: the flagship train CLI with ``--aug-* --fpnd --profile --debug``,
    one epoch of 10 batches and its evaluation; the augmented flagship D+G step
    against the CPU; one step under ``--debug-nans``, clean and with a NaN weight."""
    from mpgan_tpu_torch.cli.args import parse_cli
    from mpgan_tpu_torch.data.loader import BatchLoader
    from mpgan_tpu_torch.training.loop import Trainer

    argv = ["--name", "all", "--model", "mpgan", "--jets", "g", "--dir-path", str(tmp),
            "--num-samples", "4000", "--eval-tot-samples", "1200", "--w1-num-samples", "600",
            "--num-epochs", "1", "--save-epochs", "1", "--fpnd", "--profile", "--debug",
            *AUG_FLAGS]
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    with LogRecords() as logs:
        t = train_cli.run(parse_cli(argv), dev)
    wall = time.perf_counter() - t0
    counts = dict(mk.launch_counts)
    profile = tmp / "all" / "profile"
    traced = trace_kernels(profile / "epoch_1_trace.json")
    text = "\n".join(logs.records)
    debug = {k: text.count(k) for k in ("D real output", "G output", "D fake output")}
    losses = {k: t.losses[k] for k in ("Dr", "Df", "D", "G", "fpnd")}
    log("train_all_flags", card=card, wall_s=wall, batch=t.args.batch_size,
        aug=dataclasses.asdict(t.step_cfg.augment), losses=losses, debug_blocks=debug,
        trace_kernels=traced, profile_files=sorted(p.name for p in profile.iterdir()),
        random_trunk_warned="random ParticleNet trunk" in text, launches=counts)
    if not all(np.isfinite(v).all() and len(v) == 1 for v in losses.values()):
        raise SystemExit(f"train CLI with every flag: losses or FPND not finite: {losses}")
    if any(v != 1 for v in debug.values()) or not all(traced.values()):
        raise SystemExit(f"train CLI with every flag: debug blocks {debug}, traced {traced}")
    for name in ("edge_aggregate_train", "edge_aggregate_bwd", "edge_aggregate_bwd_no_wgrads",
                 "edge_aggregate_fn"):
        if counts[name] == 0:
            raise SystemExit(f"kernel {name} never launched on the all-flags train path")

    aug_card = {**FLAGSHIP, "aug_t": True, "aug_f": True, "aug_r90": True, "aug_s": True,
                "aug_prob": 0.5}
    step_check(dev, from_args_dict, card=aug_card, batch=16, phase="aug_step_check")

    # --debug-nans: one D+G step (--break-zero), clean, then with a NaN weight in G
    mk.reset_launch_counts()
    args = parse_cli(["--name", "nans", "--dir-path", str(tmp), "--num-samples", "2000",
                      "--debug-nans", "--break-zero"])
    from mpgan_tpu_torch.data.jetnet import JetNetDataset

    ds = JetNetDataset("g", num_particles=30, split="train", synthetic_num_jets=2000,
                       mask_feature=True, num_particles_label=True)
    nt = Trainer(args, ds, device=dev)
    loader = BatchLoader(ds.particle_data, ds.jet_data, batch_size=args.batch_size,
                         shuffle=True, seed=args.seed)
    nt.train_epoch(1, loader)
    clean = nt.losses["G"][-1]
    with torch.no_grad():
        next(nt.state.g.parameters()).fill_(float("nan"))
    try:
        nt.train_epoch(2, loader)
        raised = None
    except FloatingPointError as exc:
        raised = str(exc)
    log("debug_nans", clean_step_g_loss=clean, raised=raised,
        launches={k: v for k, v in mk.launch_counts.items() if v})
    if not np.isfinite(clean) or raised is None:
        raise SystemExit(f"--debug-nans: clean step {clean}, NaN weight raised {raised}")
    return {k: counts[k] + mk.launch_counts[k] for k in counts}


def write_mnist_resources(path: pathlib.Path, num_hits: int, seed: int = 0) -> None:
    """A random MoNet classifier in the ``C_sm_nh_*_state_dict.pt`` schema and
    real-side moments for all digits, from a seed."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(*s, generator=g, dtype=torch.float64) * scale  # noqa
    widths, kernels, sd = (1, 32, 64, 64), 25, {}
    for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:]), 1):
        sd[f"conv{i}.g"] = r(cin, kernels * cout, scale=cin ** -0.5)
        sd[f"conv{i}.mu"] = torch.rand(kernels, 2, generator=g, dtype=torch.float64)
        sd[f"conv{i}.sigma"] = 0.1 + torch.rand(kernels, 2, generator=g, dtype=torch.float64)
        sd[f"conv{i}.root"] = r(cin, cout, scale=cin ** -0.5)
        sd[f"conv{i}.bias"] = r(cout, scale=0.1)
    sd["fc1.weight"], sd["fc1.bias"] = r(128, widths[-1], scale=0.125), r(128, scale=0.1)
    torch.save(sd, path / f"C_sm_nh_{num_hits}_state_dict.pt")
    a = np.random.default_rng(seed).normal(size=(512, 128))
    np.savetxt(path / f"all_nums_sm_2_nh_{num_hits}_mu2.txt", a.mean(axis=0))
    np.savetxt(path / f"all_nums_sm_2_nh_{num_hits}_sigma2.txt", np.cov(a, rowvar=False))


def mnist_phase(mk, dev, card, identical, tmp):
    """Phase 26: ``cli.train_mnist`` on the card, one epoch of the synthetic
    clouds at N = 100 and N = 75 on the reference's dense MPGAN defaults (batch
    32; G on K2, N > 64; D on K2 with dropout 0.5 and K3), FID on resources
    written from a seed; K2 (eval, p = 0.5) and K3 at B = 32, N = 75 and 100
    against their plain versions, rerun bit for bit, and timed."""
    import importlib.util

    from mpgan_tpu_torch.cli import train_mnist
    from mpgan_tpu_torch.training import mnist_loop

    res = tmp / "mnist_resources"
    res.mkdir()
    mk.reset_launch_counts()
    runs = {}
    for n in (100, 75):
        write_mnist_resources(res, n)
        argv = ["--device", str(dev), "--name", f"mnist{n}", "--dir-path", str(tmp),
                "--num-hits", str(n), "--num-epochs", "1", "--save-epochs", "1",
                "--fid-eval-samples", str(MNIST_FID_JETS), "--mnist-eval-resources", str(res)]
        parts, calls = {}, {}
        t0 = time.perf_counter()
        with timed_parts(mnist_loop, ("generate_multi_batch", "get_fid"), parts, calls):
            t = train_mnist.main(argv)
        wall = time.perf_counter() - t0
        b = t.args.batch_size
        data = torch.as_tensor(t.train_dataset.particle_data[:b], device=dev)
        step_ms = best_ms(step_fn(t.state, t.args, data, None), inner=1)
        run_dir = tmp / f"mnist{n}"
        runs[n] = {"batch": b, "batches": len(t.train_dataset) // b, "wall_s": wall,
                   "fid_clouds": MNIST_FID_JETS, "eval_parts_s": parts, "step_ms": step_ms,
                   "losses": {k: t.losses[k] for k in ("D", "G")}, "fid": t.losses["fid"],
                   "state": (run_dir / "models" / "state_1.npz").exists(),
                   "raster": (run_dir / "figs" / "1_clouds.pdf").exists()}
        if (b != 32 or not runs[n]["state"] or not np.isfinite(t.losses["G"]).all()
                or len(t.losses["fid"]) != 1 or not np.isfinite(t.losses["fid"]).all()):
            raise SystemExit(f"train_mnist at N={n}: {runs[n]}")
        if importlib.util.find_spec("matplotlib") is not None and not runs[n]["raster"]:
            raise SystemExit(f"train_mnist at N={n}: no cloud raster with matplotlib present")
    counts = dict(mk.launch_counts)
    log("train_mnist", card=card, runs=runs, launches={k: v for k, v in counts.items() if v})
    for name in ("edge_aggregate", "edge_aggregate_train", "edge_aggregate_bwd",
                 "edge_aggregate_bwd_no_wgrads"):
        if counts[name] == 0:
            raise SystemExit(f"kernel {name} never launched on the train_mnist path")

    # the kernels at the MNIST shapes: K2 eval (the main path's check), then K2 p = 0.5
    # and K3 (phase 7's checks), all timed (phase 10's)
    err = {"edge_aggregate": 0.0}
    times = train_kernel_times(mk, dev, MNIST_SHAPES, inner=3)
    for b, n in MNIST_SHAPES:
        u1, u2, mask, hidden, _, _ = kernel_inputs(dev, b, n, 3, seed=n)
        ms, plain_ms = main_shape(
            identical, err, "edge_aggregate", b, n,
            lambda: mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True),
            lambda: mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, True), inner=3)
        times[n]["eval"] = {"shape": f"B={b} N={n}", "ms": ms, "plain_ms": plain_ms,
                            **dense_fwd_bound(b, n)}
        del u1, u2, mask, hidden
        torch.cuda.empty_cache()
    train_err = train_kernel_checks(mk, dev, identical, shapes=MNIST_SHAPES, sums=(True,))
    err.update({k: max(v, err.get(k, 0.0)) for k, v in train_err.items()})
    log("mnist_kernel_times", card=card, **{f"n{n}": v for n, v in times.items()})
    return counts, err, times, runs


# phase 27: the static-buffer steps and the sampler as CUDA graphs against the eager loop
GRAPH_STEPS = 5  # batches an epoch in phase 27's runs
# with num_critic 5 the G step runs at batches 1, 6 and 11: its third call captures
GRAPH_STEPS_CRITIC5 = 12
GRAPH_RATE_BATCHES = 8  # batches a sampler timing, the host's copy of the jets included
GRAPH_TURNS = ("eager", "graph", "graph", "eager")


def graph_paths(from_args_dict):
    """Phase 27's training paths: name -> (processed args, knn route)."""
    from mpgan_tpu_torch.cli.args import parse_cli

    def card(d, batch=None):
        args = from_args_dict(d)
        if batch:
            args.batch_size = batch
        return args

    mnist = parse_cli(["--num-hits", "100"])  # cli.train_mnist's processing
    mnist.mask = mnist.mask_c = mnist.gapt_mask = False
    mnist.dataset = "mnist"
    return {
        "flagship": (card(FLAGSHIP, 256), None),
        "knn20": (card(KNN150, 128), None),
        "knn20_route3": (card(KNN150, 128), "3"),
        "gapt": (card(GAPT, 512), None),
        "mnist100": (mnist, None),
        # an external pair with its presets: WGAN-GP, num_critic 5, Adam (D and G graphs)
        "fcmp_wgan_gp": (card({"model": "rgan", "model_D": "mpgan", "jets": "g",
                               "num_hits": 30}), None),
        # the legacy pair with mplfc's masks from model epoch 1 (the MPGAN D of mplfc
        # reads a mask column from the start): the second epoch captures again
        "legacy_mask_epoch": (legacy_card(from_args_dict)(
            {**MPLFC_CARD, "model_D": "old_mpgan", "mask_epoch": 1}), None),
    }


def graph_data(args, n_jets):
    """``n_jets`` training jets (or MNIST clouds) for ``args`` and their labels."""
    if args.get("dataset") == "mnist":
        from mpgan_tpu_torch.data.mnist import MNISTGraphDataset

        ds = MNISTGraphDataset(None, args.num_hits, train=True, synthetic_num_samples=n_jets)
        return np.asarray(ds.X, np.float32)[:n_jets], None
    from mpgan_tpu_torch.data.jetnet import JetNetDataset

    # the train CLI's dataset flags (cli/train.py)
    ds = JetNetDataset("g", num_particles=args.num_hits, synthetic_num_jets=2 * n_jets,
                       mask_feature=args.get("mask", False),
                       num_particles_label=bool(args.clabels or args.get("mask_c")
                                                or args.get("gapt_mask")))
    return ds.particle_data[:n_jets], None if ds.jet_data is None else ds.jet_data[:n_jets]


def graph_trainer(args, dev, tmp, name, scan):
    from mpgan_tpu_torch.training.config import from_args_dict
    from mpgan_tpu_torch.training.loop import Trainer

    a = from_args_dict(args.to_dict(), apply_processing=False)
    a.name, a.dir_path, a.epoch_scan, a.load_model = name, str(tmp), scan, False
    a.override_load_check = True
    return Trainer(a, device=dev)


def state_diff(a, b) -> tuple[bool, float]:
    """Whether two TrainStates are bit-identical (parameters, BN statistics, SN
    vectors, optimizer state and step counts, the key), and the largest
    relative difference of their tensors."""
    ta, tb = _leaves(a), _leaves(b)
    for sa, sb in ((a.g_opt, b.g_opt), (a.d_opt, b.d_opt)):
        ta += [st["step"].reshape(1).float() for st in sa.state.values() if "step" in st]
        tb += [st["step"].reshape(1).float() for st in sb.state.values() if "step" in st]
    same = len(ta) == len(tb) and torch.equal(a.rng, b.rng)
    rel = 0.0
    for x, y in zip(ta, tb):
        same = same and torch.equal(x, y)
        if x.numel() and not torch.equal(x, y):
            rel = max(rel, ((x - y).abs() / y.abs().clamp_min(1e-30)).max().item())
    return same, rel


def timed_epoch(t, epoch, loader) -> float:
    """One epoch's wall time, ms a step (the epoch ends in its one sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train_epoch(epoch, loader)
    return (time.perf_counter() - t0) * 1e3 / len(loader)


def issue_epoch(t, epoch, loader) -> float:
    """The host's time to issue a step, ms: one epoch with the device drained
    before each step call (the graphs' ``StaticStep.__call__``, a replay once
    captured; the eager loop's ``d_step``/``g_step``), each call timed until it
    returns."""
    from mpgan_tpu_torch.training import loop
    from mpgan_tpu_torch.training import train_step as tts

    spent = [0.0]

    def timed(fn):
        def inner(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[0] += time.perf_counter() - t0
            return out
        return inner

    saved = (tts.StaticStep.__call__, loop.d_step, loop.g_step)
    tts.StaticStep.__call__, loop.d_step, loop.g_step = (timed(f) for f in saved)
    try:
        t.train_epoch(epoch, loader)
    finally:
        tts.StaticStep.__call__, loop.d_step, loop.g_step = saved
    return spent[0] * 1e3 / len(loader)


def epoch_profile(t, epoch, loader) -> dict:
    """Device time a step from ``torch.profiler`` (CUDA activity only) over one
    epoch, with the epoch's wall time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.train_epoch(epoch, loader)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = kernels = 0
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0 and ev.self_cpu_time_total == 0:
            busy += dt / 1e3
            kernels += ev.count
    steps = len(loader)
    return {"device_ms": busy / steps, "wall_ms": wall / steps, "kernels_per_step": kernels / steps,
            "idle_share": 1 - busy / wall if wall else None}


def graph_step_paths(mk, dev, card, from_args_dict, tmp):
    """Phase 27, training: every path's :func:`graph_step_path`."""
    return {name: graph_step_path(mk, dev, card, name, args, route, tmp)
            for name, (args, route) in graph_paths(from_args_dict).items()}


def graph_step_path(mk, dev, card, name, args, route, tmp) -> dict:
    """A training path's epoch of GRAPH_STEPS batches on the eager loop and on
    the graphs from one seed, bit for bit, the eager epoch moving each model
    (:func:`params_moved`); launches, peak memory, and step times in turns
    (phases 27 and 34)."""
    from mpgan_tpu_torch.data.loader import BatchLoader

    set_knn_route(route)
    try:
        b = args.batch_size
        steps = GRAPH_STEPS if args.num_critic == 1 else GRAPH_STEPS_CRITIC5
        data, labels = graph_data(args, steps * b)
        epochs = 2 if name == "legacy_mask_epoch" else 1
        runs = {}
        for scan in (False, True):
            t = graph_trainer(args, dev, tmp, f"{name}_{int(scan)}", scan)
            loader = BatchLoader(data, labels if t.use_labels else None, batch_size=b,
                                 shuffle=True, seed=args.seed)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = model_params(t.state)
            mk.reset_launch_counts()
            for e in range(1, epochs + 1):
                t.train_epoch(e, loader)
            torch.cuda.synchronize()
            runs[scan] = {"trainer": t, "loader": loader, "before": before,
                          "launches": {k: v for k, v in mk.launch_counts.items() if v},
                          "peak_mb": (torch.cuda.max_memory_allocated() - base) / 2**20}
        eager, graph = runs[False], runs[True]
        te, tg = eager["trainer"], graph["trainer"]
        moved = params_moved(te.state, eager.pop("before"), name)
        graph.pop("before")
        same, rel = state_diff(te.state, tg.state)
        keys = te.d_loss_keys + ["G"]
        losses_same = all(te.losses[k] == tg.losses[k] for k in keys)
        kinds = sorted(tg.graphs.steps)
        res = {"batch": b, "epochs": epochs, "kinds": kinds,
               "captures": tg.graphs.captures, "replays": tg.graphs.replays,
               "state_bit_identical": same, "max_rel_diff": rel, "params_moved": moved,
               "losses_equal": losses_same,
               "losses": {k: tg.losses[k] for k in keys},
               "launches_eager": eager["launches"], "launches_graph": graph["launches"],
               "peak_mb_eager": eager["peak_mb"], "peak_mb_graph": graph["peak_mb"]}
        if not same and rel > 1e-6:
            log("graph_step", card=card, path=name, **res)
            raise SystemExit(f"{name}: the graph steps' state differs from the eager "
                             f"loop's by {rel} relative")
        # (the external pair reaches no hand-written kernel: rGAN G, WGAN-GP's plain D)
        if eager["launches"] != graph["launches"] or (not eager["launches"]
                                                      and name != "fcmp_wgan_gp"):
            raise SystemExit(f"{name}: kernel launches eager {eager['launches']} != graph "
                             f"{graph['launches']}")
        if not tg.graphs.replays or tg.graphs.captures != epochs * len(kinds):
            raise SystemExit(f"{name}: {tg.graphs.captures} captures, "
                             f"{tg.graphs.replays} replays")
        # step times in turns, on the captured graphs; then a profile of each
        ms = {"eager": [], "graph": []}
        epoch = epochs
        for which in GRAPH_TURNS:
            epoch += 1
            ms[which].append(timed_epoch(runs[which == "graph"]["trainer"], epoch,
                                         runs[which == "graph"]["loader"]))
        for which, r in (("eager", eager), ("graph", graph)):
            res[f"wall_ms_{which}"] = ms[which]
            res[f"issue_ms_{which}"] = issue_epoch(r["trainer"], epoch + 1, r["loader"])
            res[f"profile_{which}"] = epoch_profile(r["trainer"], epoch + 2, r["loader"])
            epoch += 2
        res["replays"] = tg.graphs.replays
        log("graph_step", card=card, path=name, **res)
        return res
    finally:
        set_knn_route()
        runs = te = tg = None
        torch.cuda.empty_cache()


def graph_cli(train_cli, dev, tmp):
    """Phase 27: the flagship through ``cli.train``, two epochs with --epoch-scan
    and two with --no-epoch-scan from one seed: equal losses."""
    losses = {}
    for flag in ("--epoch-scan", "--no-epoch-scan"):
        argv = ["--device", str(dev), "--name", f"cli{flag}", "--model", "mpgan", "--jets", "g",
                "--dir-path", str(tmp), "--num-samples", "4000", "--num-epochs", "2",
                "--save-epochs", "100", "--save-model-epochs", "100", flag]
        t = train_cli.main(argv)
        losses[flag] = {k: t.losses[k] for k in ("Dr", "Df", "D", "G")}
        if flag == "--epoch-scan" and not t.graphs.replays:
            raise SystemExit("cli.train --epoch-scan replayed no graph")
    equal = losses["--epoch-scan"] == losses["--no-epoch-scan"]
    log("graph_cli", losses=losses, equal=equal)
    if not equal:
        raise SystemExit("cli.train: --epoch-scan and --no-epoch-scan losses differ")


def graph_samplers(mk, dev, card, from_args_dict):
    """Phase 27: each sampler shape's graph against the eager loop, jets bit for
    bit, launches equal; jets/s of both in turns, and peak memory."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.sampling import drop_samplers, generate_multi_batch

    shapes = (("30p", FLAGSHIP, 4096), ("150p_dense", {**FLAGSHIP, "num_hits": 150}, 512),
              ("150p_dense", {**FLAGSHIP, "num_hits": 150}, 32), ("knn20", KNN150, 512),
              ("gapt", GAPT, 1024), ("gapt", GAPT, 4096))
    out = {}
    for name, card_d, b in shapes:
        args = from_args_dict(card_d)
        suite = build_suite(args)
        g = suite.generator(prng_key(6, "cpu"), device=dev)
        n_jets = 3 * b  # the third batch replays a captured graph
        _, labels = real_batch(GRAPH_RATE_BATCHES * b, args.num_hits)
        labels = labels.numpy()

        def run(static, n=n_jets):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            jets = generate_multi_batch(g, suite.noise, prng_key(2, dev),
                                        n, b, labels=labels[:n], static=static)
            return jets, time.perf_counter() - t0

        res = {}
        for static in (False, True):
            drop_samplers(g)
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mk.reset_launch_counts()
            res[static] = run(static)[0]
            res[f"launches_{static}"] = {k: v for k, v in mk.launch_counts.items() if v}
            res[f"peak_mb_{static}"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        same = np.array_equal(res[False], res[True])
        rate = {"eager": [], "graph": []}
        n_rate = GRAPH_RATE_BATCHES * b
        for which in GRAPH_TURNS:
            rate[which].append(n_rate / run(which == "graph", n_rate)[1])
        row = {"batch": b, "jets": n_jets, "rate_jets": n_rate, "bit_identical": same,
               "launches_eager": res["launches_False"], "launches_graph": res["launches_True"],
               "jets_per_s_eager": rate["eager"], "jets_per_s_graph": rate["graph"],
               "peak_mb_eager": res["peak_mb_False"], "peak_mb_graph": res["peak_mb_True"]}
        log("graph_sampler", card=card, path=name, **row)
        if not same or res["launches_False"] != res["launches_True"]:
            raise SystemExit(f"sampler {name} B={b}: graph jets differ from the eager loop's "
                             "or launched other kernels")
        out[f"{name}_b{b}"] = row
        drop_samplers(g)
        del g
        torch.cuda.empty_cache()
    return out


def graph_phase(mk, train_cli, dev, card, from_args_dict, tmp):
    """Phase 27: the training paths, the CLI and the samplers on CUDA graphs."""
    t0 = time.perf_counter()
    steps = graph_step_paths(mk, dev, card, from_args_dict, tmp)
    graph_cli(train_cli, dev, tmp)
    samplers = graph_samplers(mk, dev, card, from_args_dict)
    log("graphs", card=card, seconds=time.perf_counter() - t0,
        step_ms={k: {"eager": min(v["wall_ms_eager"]), "graph": min(v["wall_ms_graph"])}
                 for k, v in steps.items()},
        jets_per_s={k: {"eager": max(v["jets_per_s_eager"]), "graph": max(v["jets_per_s_graph"])}
                    for k, v in samplers.items()})
    return steps, samplers


# phase 28: bf16 mixed-precision training (--compute-dtype bfloat16, StepConfig.bf16)
# One bf16 rounding is 2^-8: the kernels and their plain versions sum each hidden
# product in another order before an activation is rounded for the next product.
# Gradients on the scale of their largest: a pre-activation within rounding of zero
# takes the other LeakyReLU slope in one of the two (more often in bf16).
BF16_TOL = 1e-2
BF16_STEP_LOSS_TOL = 0.05  # bf16 losses against float32's (tests/test_training.py:454-455)
BF16_FP32_KINDS = ("edge_aggregate", "edge_aggregate_train", "edge_aggregate_bwd",
                   "edge_aggregate_bwd_no_wgrads")
BF16_KINDS = tuple(f"{k}_bf16" for k in BF16_FP32_KINDS) + ("edge_aggregate_fn_bf16",)
BF16_SOURCES = {"edge_aggregate": "mpgan_tpu_torch/csrc/edge_aggregate_bf16.cu",
                "edge_aggregate_fn": "mpgan_tpu_torch/csrc/edge_aggregate_bf16.cu",
                "edge_aggregate_bwd": "mpgan_tpu_torch/csrc/edge_aggregate_bwd_bf16.cu"}


def bf16_bound(b, n, kind, wgrads=True) -> dict:
    """Bound of a bf16-mode kernel at the published widths: the forward and
    recompute products over the dense bf16 tensor cores' rate, plus (K3) the
    backward's float32 products as split-TF32 (split_tf32_flops) and
    (K4) fn's first layer over the FP32 rate, or the bytes at their bf16 sizes,
    whichever is larger."""
    hidden = macs(FE) + sum(FE[1:])
    chain = 2 * b * n * n * macs(FE)
    f32_flops = tf32_flops = 0
    if kind == "bwd":
        elems = (2 * b * n * FE[0] + b * n) * 2 + b * n * FE[-1] + hidden * (2 if wgrads else 1)
        tf32_flops = split_tf32_flops(chain, wgrads)
        bf16_flops = chain
    else:
        out = FE[-1] if kind == "fwd" else 3
        elems = 2 * b * n * FE[0] + b * n + hidden + b * n * out
        bf16_flops = chain
        if kind == "fn":
            fn = FN + [3]
            elems += b * n * 32 + macs(fn) + sum(fn[1:])
            f32_flops = 2 * b * n * FN[0] * FN[1]
            bf16_flops += 2 * b * n * macs(fn[1:])
    ops = (bf16_flops / PEAK_BF16 + tf32_flops / PEAK_TF32 + f32_flops / PEAK_FP32) * 1e3
    mem = 2 * elems / PEAK_HBM * 1e3
    return {"bound_ms": max(ops, mem), "bound_by": "operations" if ops >= mem else "bytes",
            "library_ms": None}


def to_bf16(*ts):
    return tuple(t.to(torch.bfloat16) for t in ts)


def bf16_err(out, ref, scaled):
    """Max abs error, and the count beyond BF16_TOL (``scaled``: against
    BF16_TOL * max(1, max|ref|))."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if scaled:
        bound = BF16_TOL * max(1.0, r.abs().max().item())
        return err.max().item(), int((err > bound).sum().item())
    return err.max().item(), int((err > BF16_TOL + BF16_TOL * r.abs()).sum().item())


# K3's and K6's bf16 backward products as split-TF32. The bf16 rules hold any float32
# product of TF32 accuracy or better, so this check reads the split itself: the share of
# the bf16 gradients (du1 and du2: "dx"; the weight gradients: "dw") that differ from the
# plain version's (float32 products), beside the same share of the plain version with its
# products taken as one TF32 product (hi hi) or with one lo term of the split left out
# (emulated on the card on float32 bits). The kernel reads at most SPLIT_MAX_DIFFERING,
# each of those controls above it; the emulated split itself is logged beside. It runs on
# the job's inputs with LeakyReLU's slope set to 1: at 0.2 a pre-activation within
# rounding of zero takes the other slope in the kernel's recompute and moves a whole row
# of dW, as often as one TF32 product's rounding does. da's lo_b is W's, zero for bf16
# weights: dx is held against the controls that drop a lo term it has. The limit sits
# between the readings of scripts/torch_split_tf32_shares.py (PERF.md §6, PR 15): at slope
# 1 the kernel at most 0.16%, the held controls at least 1.5%.
SPLIT_MAX_DIFFERING = 0.005
SPLIT_CONTROLS = {"one_tf32_product": (), "without_lo_a": ("lo_b",),
                  "without_lo_b": ("lo_a",), "split": ("lo_a", "lo_b")}
SPLIT_CONTROLS_HELD = {"dx": ("one_tf32_product", "without_lo_a"),
                       "dw": ("one_tf32_product", "without_lo_a", "without_lo_b")}


def tf32_hi(x):
    """float32 ``x`` rounded to TF32, to nearest with ties away (the kernels' split)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


class SplitProducts(types.ModuleType):
    """``torch`` as a plain version's module sees it, with its float32 ``matmul``
    taken as hi_a hi_b plus the split's ``terms`` ("lo_a": lo_a hi_b, "lo_b":
    hi_a lo_b), each product exact in float32. The recompute's operands are bf16
    values, whose lo is zero: its products come out as before."""

    def __init__(self, terms):
        super().__init__("torch")
        self.terms = terms

    def __getattr__(self, name):
        return getattr(torch, name)

    def matmul(self, a, b):
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            return torch.matmul(a, b)
        ah, bh = tf32_hi(a), tf32_hi(b)
        out = torch.matmul(ah, bh)
        if "lo_a" in self.terms:
            out = out + torch.matmul(tf32_hi(a - ah), bh)
        if "lo_b" in self.terms:
            out = out + torch.matmul(ah, tf32_hi(b - bh))
        return out


def differing_share(outs, refs) -> float:
    """Share of the elements of ``outs`` that differ from ``refs``'s."""
    total = sum(o.numel() for o in outs)
    return sum(int((o != r).sum().item()) for o, r in zip(outs, refs)) / max(total, 1)


def split_tf32_check(kernel, plain, args, alpha_at, groups):
    """The readings of :func:`split_tf32_shares` on ``args`` with the slope at
    ``args[alpha_at]`` set to 1, and whether the kernel is within
    SPLIT_MAX_DIFFERING and every held control above it."""
    args = (*args[:alpha_at], 1.0, *args[alpha_at + 1:])
    shares = split_tf32_shares(kernel(*args), plain, args, groups)
    ok = all(s <= SPLIT_MAX_DIFFERING for s in shares["kernel"].values()) and all(
        shares[c][g] > SPLIT_MAX_DIFFERING for g in shares["kernel"]
        for c in SPLIT_CONTROLS_HELD[g])
    return shares, ok


def split_tf32_shares(out, plain, args, groups) -> dict:
    """The kernel's bf16 gradients ``out`` against ``plain(*args)``, and the
    controls (SPLIT_CONTROLS) against it, as shares of differing elements by
    group (``groups(outputs)``: {"dx": [...], "dw": [...]})."""
    mod = sys.modules[plain.__module__]
    ref = groups(plain(*args))
    shares = {"kernel": {g: differing_share(o, ref[g]) for g, o in groups(out).items()}}
    for name, terms in SPLIT_CONTROLS.items():
        mod.torch = SplitProducts(terms)
        try:
            ctl = groups(plain(*args))
        finally:
            mod.torch = torch
        shares[name] = {g: differing_share(o, ref[g]) for g, o in ctl.items()}
    return shares


def bf16_kernel_checks(mk, dev):
    """K2 (eval, dropout 0.5), K3 (with and without weight gradients) and K4 in
    bf16 against their bf16 plain versions at the flagship's shapes (B=256 N=30)
    and 150p dense (B=32 N=150, K2 and K3), each launched twice bit for bit;
    then each one's time beside its FP32 mode's (in turns), its plain version's
    and its bound."""
    worst = {k: 0.0 for k in ("edge_aggregate", "edge_aggregate_fn", "edge_aggregate_bwd")}
    identical = dict.fromkeys(worst, True)
    times = {}
    for b, n in ((256, 30), (32, 150)):
        u1, u2, mask, hidden, x, fn = kernel_inputs(dev, b, n, 3, seed=28 + n)
        g = torch.randn(b, n, 192, generator=torch.Generator(device=dev).manual_seed(n),
                        device=dev)
        f32 = (u1, u2, mask, hidden, x, fn, g)
        u1, u2, mask, x, g = to_bf16(u1, u2, mask, x, g)
        hidden, fn = to_bf16(*hidden), to_bf16(*fn)
        jobs = {
            "k2_eval": ("edge_aggregate", lambda h: (mk.edge_aggregate, mk.edge_aggregate_reference,
                        (*h[:4], 0.2, True)), False, "fwd"),
            "k2_train": ("edge_aggregate", lambda h: (mk.edge_aggregate,
                         mk.edge_aggregate_reference, (*h[:4], 0.2, False, 0.5, 2828)), False,
                         "fwd"),
            "k3": ("edge_aggregate_bwd", lambda h: (
                mk.edge_aggregate_bwd, mk.edge_aggregate_bwd_reference,
                (*h[:4], h[6], 0.2, True, 0.5, 2828, True)), True, "bwd"),
            "k3_no_wgrads": ("edge_aggregate_bwd", lambda h: (
                mk.edge_aggregate_bwd, mk.edge_aggregate_bwd_reference,
                (*h[:4], h[6], 0.2, False, 0.0, 0, False)), True, "bwd"),
        }
        if n <= 64:
            jobs["k4"] = ("edge_aggregate_fn", lambda h: (
                mk.edge_aggregate_fn, mk.edge_aggregate_fn_reference,
                (*h[:4], h[4], h[5], 0.2, True, 0.2, True)), False, "fn")
        bf = (u1, u2, mask, hidden, x, fn, g)
        for job, (name, make, scaled, kind) in jobs.items():
            kernel, plain, a = make(bf)
            out, again, ref = kernel(*a), kernel(*a), plain(*a)
            torch.cuda.synchronize()
            split, split_ok = None, True
            if name == "edge_aggregate_bwd":
                pairs = list(zip((*out[:3], *out[3]), (*ref[:3], *ref[3])))
                repeat = all(torch.equal(p, q) for p, q in zip((*out[:3], *out[3]),
                                                              (*again[:3], *again[3])))
                if not a[-1]:
                    repeat = repeat and not any(t.any().item() for t in out[3])
                split, split_ok = split_tf32_check(
                    kernel, plain, a, 5,
                    lambda t, w=a[-1]: {"dx": t[:2], **({"dw": t[3]} if w else {})})
            else:
                pairs, repeat = [(out, ref)], torch.equal(out, again)
            errs = [bf16_err(o, r, scaled) for o, r in pairs]
            dtypes_ok = all(o.dtype == torch.bfloat16 for o, _ in pairs)
            err, bad = max(e for e, _ in errs), sum(c for _, c in errs)
            identical[name] &= repeat
            # each output's error beside what the rule allows it (scaled: BF16_TOL of
            # max(1, max|ref|); else BF16_TOL + BF16_TOL |ref| at the worst element)
            rule = [(e, BF16_TOL * max(1.0, r.float().abs().max().item()) if scaled else None)
                    for (e, _), (_, r) in zip(errs, pairs)]
            log("bf16_kernel_check", kernel=name, job=job, b=b, n=n, max_abs_err=err,
                out_of_tol=bad, tol=BF16_TOL, scaled_to_max=scaled,
                err_and_allowed_by_output=rule, two_runs_bit_identical=repeat,
                outputs_bf16=dtypes_ok, split_tf32_differing_shares=split,
                split_max_differing=SPLIT_MAX_DIFFERING)
            if bad or not repeat or not dtypes_ok or not split_ok:
                raise SystemExit(f"bf16 {name} ({job}) disagrees with its plain version or "
                                 f"itself at b={b} n={n}: {bad} beyond {BF16_TOL}, rerun "
                                 f"bit-identical {repeat}, split-TF32 shares {split}")
            worst[name] = max(worst[name], err)
            del out, again, ref
            # timings: the bf16 mode and the FP32 mode in turns, the plain version once
            _, _, a32 = make(f32)
            ms = {"bf16": float("inf"), "fp32": float("inf")}
            for which in ("fp32", "bf16", "bf16", "fp32"):
                ms[which] = min(ms[which], best_ms(lambda: kernel(*(a if which == "bf16"
                                                                   else a32)), inner=2))
            plain_ms = best_ms(lambda: plain(*a), reps=2, inner=1)
            wg = job != "k3_no_wgrads"
            times[f"{job}_n{n}"] = {"shape": f"B={b} N={n}", "ms": ms["bf16"],
                                    "fp32_ms": ms["fp32"], "plain_ms": plain_ms,
                                    **bf16_bound(b, n, kind, wg)}
        del u1, u2, mask, hidden, x, fn, g, f32, bf
        torch.cuda.empty_cache()
    identical["edge_aggregate_fn"] &= k4_fp32_pass_bits(mk, dev)
    return worst, identical, times


def k4_fp32_pass_bits(mk, dev) -> bool:
    """K4's bf16 mode on the seeded cases of ``scripts/torch_k4_bf16_bits.py`` against
    the outputs the FP32 pass's bf16 mode gave (``tests/data/k4_bf16_fp32_pass.npz``),
    bit for bit."""
    import importlib.util

    root = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("torch_k4_bf16_bits",
                                                  root / "scripts" / "torch_k4_bf16_bits.py")
    kb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kb)
    want = np.load(root / "tests" / "data" / "k4_bf16_fp32_pass.npz")
    got = kb.outputs(mk, dev)
    differing = {k: int((got[k] != want[k]).sum()) for k in want.files}
    log("bf16_k4_fp32_pass_bits", cases=list(want.files), differing=differing)
    if any(differing.values()) or sorted(got) != sorted(want.files):
        raise SystemExit(f"bf16 K4 differs from the FP32 pass's bf16 mode: {differing}")
    return True


# The ATen operators that allocate and launch nothing
ALLOCATIONS = ("aten.empty.memory_format", "aten.empty_strided.default")


def torch_ops_of_call(call) -> list[str]:
    """The ATen operators that one ``call`` runs (a ``TorchDispatchMode`` that
    records them): a cast, or any other torch kernel, is one of them; a
    kernel launched through ``ctypes`` is not."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops() as mode:
        call()
    return mode.ops


def one_k9_launch(gk, call) -> dict:
    """What one bf16 K9 ``call`` runs: its K9 launches (the wrapper's count) and
    the torch operators beside them, which must only allocate (no cast)."""
    before = gk.launch_counts["gapt_g_fused_bf16"]
    ops = torch_ops_of_call(call)
    return {"k9_launches": gk.launch_counts["gapt_g_fused_bf16"] - before,
            "torch_ops": ops, "only_allocations": all(o in ALLOCATIONS for o in ops)}


def trace_names(prof) -> list[str]:
    return [ev.key for ev in prof.key_averages()
            if (getattr(ev, "self_device_time_total", None)
                or getattr(ev, "self_cuda_time_total", 0.0)) > 0]


# The bf16 forward pass's kernel (csrc/edge_fwd_bf16_tiles.cuh) in a trace: named by its
# width class and flags (dense K2, or knn K5 and K8), however the demangler spells them
TILES_DENSE = r"bf16_tiles_kernel<\s*(\(int\))?\d+\s*,\s*(false|\(bool\)0|0)\s*,"
TILES_KNN = r"bf16_tiles_kernel<\s*(\(int\))?\d+\s*,\s*(true|\(bool\)1|1)\s*,"
# K4's bf16 mode on the same pass, with fn on its receivers after a grid-wide barrier
TILES_FN = r"bf16_tiles_fn_kernel<"


def bf16_step_check(mk, dev, card, from_args_dict, card_d=FLAGSHIP, batch=256):
    """A bf16 D+G step (by default the flagship's at B=256) from the same
    weights and draws as a float32 one: losses within 5%, every master tensor
    float32, the bf16 edge kernels a step predicts launched
    (:func:`dense_steps_expected`) and the float32 ones by the float32 step;
    a torch.profiler trace of bf16 steps names the bf16 kernels: K2, K3 and,
    at N <= 64, K4."""
    from torch.profiler import ProfilerActivity, profile

    data, labels = (t.to(dev) for t in real_batch(batch, card_d["num_hits"]))
    res = {}
    for name, extra in (("f32", {}), ("bf16", {"compute_dtype": "bfloat16"})):
        args = from_args_dict({**card_d, **extra})
        st = make_state(args, dev)
        step = step_fn(st, args, data, labels)
        mk.reset_launch_counts()
        parts = {k: v.item() for k, v in step().items()}
        res[name] = (parts, {k: v for k, v in mk.launch_counts.items() if v}, st, step)
    (l32, c32, _, _), (l16, c16, st16, step16) = res["f32"], res["bf16"]
    rel = max(abs(l16[k] - l32[k]) / abs(l32[k]) for k in l32)
    leaves_f32 = all(t.dtype == torch.float32 for t in _leaves(st16))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step16()
        torch.cuda.synchronize()
    names = trace_names(prof)
    k4 = card_d["num_hits"] <= 64
    named = {what: [k for k in names if re.search(pat, k) and (not bf16 or "bfloat16" in k)]
             for what, pat, bf16 in (("K2", TILES_DENSE, False),
                                     ("K4", TILES_FN, False),
                                     ("K3", "edge_aggregate_bwd_kernel<", True))
             if k4 or what != "K4"}
    expected = {k: dense_steps_expected(card_d["num_hits"], 1, bf16=bf16)
                for k, bf16 in (("f32", False), ("bf16", True))}
    log("bf16_step_check", card=card, batch=batch, n=card_d["num_hits"], losses_f32=l32,
        losses_bf16=l16, max_rel_loss_diff=rel, tol=BF16_STEP_LOSS_TOL,
        master_state_float32=leaves_f32, launches_f32=c32, launches_bf16=c16,
        expected=expected, trace_kernels={k: v[:1] for k, v in named.items()})
    if rel > BF16_STEP_LOSS_TOL or not leaves_f32:
        raise SystemExit(f"bf16 step: losses {l16} against float32 {l32}, master float32 "
                         f"{leaves_f32}")
    if c16 != expected["bf16"] or c32 != expected["f32"]:
        raise SystemExit(f"bf16 step launched {c16}, the float32 step {c32}, predicted "
                         f"{expected}")
    if not all(named.values()):
        raise SystemExit(f"the bf16 step's trace names no bf16 kernel for "
                         f"{[k for k, v in named.items() if not v]}: {names[:20]}")
    return c16


def bf16_graph_and_timing(mk, dev, card, from_args_dict, tmp, card_d=FLAGSHIP, b=256):
    """A bf16 epoch (GRAPH_STEPS batches of ``b``; by default the flagship's at
    256) on the eager loop and on the captured graph from one seed, bit for
    bit, the eager epoch moving each model (:func:`params_moved`); then the
    bf16 and the float32 graph steps in turns (float32, bf16, bf16, float32)
    and a profile of each: wall, device time, idle share."""
    from mpgan_tpu_torch.data.loader import BatchLoader

    a32 = from_args_dict(card_d)
    a16 = from_args_dict({**card_d, "compute_dtype": "bfloat16"})
    a32.batch_size = a16.batch_size = b
    data, labels = graph_data(a16, GRAPH_STEPS * b)
    runs = {}
    for name, args, scan in (("bf16_eager", a16, False), ("bf16_graph", a16, True),
                             ("f32_graph", a32, True)):
        t = graph_trainer(args, dev, tmp, name, scan)
        loader = BatchLoader(data, labels, batch_size=b, shuffle=True, seed=args.seed)
        before = model_params(t.state)
        mk.reset_launch_counts()
        t.train_epoch(1, loader)
        torch.cuda.synchronize()
        runs[name] = (t, loader, {k: v for k, v in mk.launch_counts.items() if v})
        if name == "bf16_eager":
            moved = params_moved(t.state, before, "bf16 epoch")
    (te, _, ce), (tg, _, cg) = runs["bf16_eager"], runs["bf16_graph"]
    same, rel = state_diff(te.state, tg.state)
    losses_same = all(te.losses[k] == tg.losses[k] for k in ("Dr", "Df", "D", "G"))
    if not same or not losses_same or ce != cg or not tg.graphs.replays:
        raise SystemExit(f"bf16 graph step differs from the eager one: state {same} ({rel}), "
                         f"losses {losses_same}, launches {ce} vs {cg}")
    ms = {"f32_graph": [], "bf16_graph": []}
    epoch = 1
    for which in ("f32_graph", "bf16_graph", "bf16_graph", "f32_graph"):
        epoch += 1
        t, loader, _ = runs[which]
        ms[which].append(timed_epoch(t, epoch, loader))
    prof = {}
    for which in ("f32_graph", "bf16_graph"):
        t, loader, _ = runs[which]
        prof[which] = epoch_profile(t, epoch + 1, loader)
    log("bf16_graph_step", card=card, batch=b, n=card_d["num_hits"], steps=GRAPH_STEPS,
        state_bit_identical=same, params_moved=moved,
        losses_equal=losses_same, replays=tg.graphs.replays, launches=cg,
        wall_ms_f32=ms["f32_graph"], wall_ms_bf16=ms["bf16_graph"],
        profile_f32=prof["f32_graph"], profile_bf16=prof["bf16_graph"])
    return {"wall_ms_f32": min(ms["f32_graph"]), "wall_ms_bf16": min(ms["bf16_graph"]),
            "launches_per_step": {k: v / GRAPH_STEPS for k, v in cg.items()},
            "profile_f32": prof["f32_graph"], "profile_bf16": prof["bf16_graph"]}


def bf16_cli(mk, train_cli, tmp):
    """``cli.train --compute-dtype bfloat16`` on the flagship: 2 epochs, a resume
    that restores the state exactly, a 3rd epoch; the bf16 launches equal the
    prediction and no float32 training kernel launches (the evaluation
    generates in float32, through K4)."""
    argv = ["--device", "cuda", "--name", "bf16", "--model", "mpgan", "--jets", "g",
            "--dir-path", str(tmp), "--num-samples", "5000", "--eval-tot-samples", "1000",
            "--w1-num-samples", "500", "--save-model-epochs", "1", "--save-epochs", "2",
            "--compute-dtype", "bfloat16"]
    mk.reset_launch_counts()
    t1 = train_cli.main(argv + ["--num-epochs", "2"])
    before = [t.detach().cpu().clone() for t in _leaves(t1.state)]
    t2 = train_cli.main(argv + ["--num-epochs", "2"])  # resume, no epoch to run
    after = [t.detach().cpu() for t in _leaves(t2.state)]
    restored = (t2.start_epoch == 2 and len(before) == len(after)
                and all(torch.equal(a, c) for a, c in zip(before, after)))
    t3 = train_cli.main(argv + ["--num-epochs", "3"])
    counts = dict(mk.launch_counts)
    steps = 3 * (len(t1.train_dataset) // t1.args.batch_size)
    predicted = dense_steps_expected(30, steps, bf16=True)
    npz = np.load(tmp / "bf16" / "models" / "state_3.npz")
    ckpt_f32 = all(npz[k].dtype == np.float32 for k in npz.files if npz[k].dtype.kind in "fV")
    losses = {k: t3.losses[k] for k in ("Dr", "Df", "D", "G")}
    finite = all(np.isfinite(v).all() for v in losses.values())
    log("bf16_cli", steps=steps, resumed_from=t2.start_epoch, state_restored=restored,
        epochs=len(t3.losses["G"]), losses=losses, w1m=t3.losses["w1m"],
        checkpoint_float32=ckpt_f32, launches={k: v for k, v in counts.items() if v},
        predicted=predicted)
    if not restored or not finite or len(t3.losses["G"]) != 3 or not ckpt_f32:
        raise SystemExit(f"bf16 train CLI: restored {restored}, losses {losses}, float32 "
                         f"checkpoint {ckpt_f32}")
    for name, want in predicted.items():
        if counts[name] != want:
            raise SystemExit(f"bf16 train CLI launched {name} {counts[name]} times, "
                             f"predicted {want}")
    if any(counts[k] for k in BF16_FP32_KINDS) or not counts["edge_aggregate_fn"]:
        raise SystemExit(f"bf16 train CLI: float32 training kernels launched, or the "
                         f"float32 evaluation did not: {counts}")
    return counts


def batched_d_check(dev, from_args_dict):
    """One batched_d D step of the GAPT pair on the card against the CPU, from
    the same state and draws: losses and D's gradients within 1e-4."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.train_step import d_step, step_config
    from mpgan_tpu_torch.utils.weights import jax_leaves

    args = from_args_dict(GAPT)
    data, labels = real_batch(16)
    cfg = dataclasses.replace(step_config(args), batched_d=True)
    res = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        st = make_state(args, device)
        parts = d_step(st, cfg, build_suite(args).noise, data.to(device), labels.to(device))
        res[side] = ({k: v.item() for k, v in parts.items()},
                     [p.grad.detach().cpu() for p in jax_leaves(st.d, True) if p.grad is not None])
    (lc, gc), (lp, gp) = res["card"], res["cpu"]
    loss_err = max(abs(lc[k] - lp[k]) / max(1.0, abs(lp[k])) for k in lp)
    grad_err = [wgrad_err(a, c) for a, c in zip(gc, gp)]
    log("batched_d_check", pair="gapt", batch=16, losses_card=lc, losses_cpu=lp,
        max_rel_loss_err=loss_err, max_abs_grad_err=max(e for e, _ in grad_err),
        tensors=len(grad_err), tol=TOL)
    if loss_err > TOL or len(gc) != len(gp) or not all(ok for _, ok in grad_err):
        raise SystemExit("batched_d: the GAPT D step on the card disagrees with the CPU")


def bf16_phase(mk, train_cli, dev, card, from_args_dict, tmp):
    """Phase 28: bf16 training on the card."""
    t0 = time.perf_counter()
    worst, identical, times = bf16_kernel_checks(mk, dev)
    step_launches = bf16_step_check(mk, dev, card, from_args_dict)
    steps = bf16_graph_and_timing(mk, dev, card, from_args_dict, tmp)
    cli_launches = bf16_cli(mk, train_cli, tmp)
    batched_d_check(dev, from_args_dict)
    log("bf16", card=card, seconds=time.perf_counter() - t0, step=steps, kernel_times=times)
    launches = {k: step_launches.get(k, 0) + cli_launches[k] for k in BF16_KINDS}
    return worst, identical, times, launches, steps


# ---------------------------------------------------------------------------
# phase 29: bf16 training on the knn-20 and GAPT paths (K5-K9 in their bf16 modes)
# ---------------------------------------------------------------------------

# K6's gradients are held as a whole, as the card tests hold bf16 gradients:
# a bf16 rounding boundary crossed a hair apart, or a LeakyReLU slope flipped near
# zero, moves one edge's whole gradient row, and a sender's du2 sums only its few
# edges (the plain version perturbed by 1e-6 relative moves its gradients by up to
# 3% of the largest, PERF.md); the element count beyond 1e-2 of max(1, max|ref|)
# is logged beside
BF16_REL_L2 = 3e-2
BF16_MAX_SHARE = 0.1
BF16_KNN_SOURCES = {"knn_fused_layer": "mpgan_tpu_torch/csrc/knn_fused_bf16.cu",
                    "knn_edge_aggregate": "mpgan_tpu_torch/csrc/knn_fused_bf16.cu",
                    "knn_search": "mpgan_tpu_torch/csrc/knn_search.cu",
                    "knn_edge_aggregate_bwd": "mpgan_tpu_torch/csrc/knn_edge_bwd_bf16.cu",
                    "gapt_g_fused": "mpgan_tpu_torch/csrc/gapt_fused.cu"}
# the bf16 launch counts of each kernel's row in the kernels line
BF16_KNN_KINDS = {"knn_fused_layer": ("knn_fused_layer_bf16", "knn_fused_layer_train_bf16"),
                  "knn_edge_aggregate_bwd": ("knn_edge_aggregate_bwd_bf16",
                                             "knn_edge_aggregate_bwd_no_wgrads_bf16"),
                  "knn_search": ("knn_search_bf16",),
                  "knn_edge_aggregate": ("knn_edge_aggregate_bf16",),
                  "gapt_g_fused": ("gapt_g_fused_bf16",)}
# a D+G step's bf16 launches (phase 14's count: the D step's real and fake passes and
# the G step's G and D emit idx, 2 layers each; K6 with weight gradients for D twice
# and G once, without for D in the G step; the D step's fake batch without idx; route 3:
# a K7 and a K8 a layer call; GAPT: K9 for the D step's fake batch)
BF16_STEP_LAUNCHES = {
    "knn20": {"knn_fused_layer_train_bf16": 8, "knn_fused_layer_bf16": 2,
              "knn_edge_aggregate_bwd_bf16": 6, "knn_edge_aggregate_bwd_no_wgrads_bf16": 2},
    "knn20_route3": {"knn_search_bf16": 10, "knn_edge_aggregate_bf16": 10,
                     "knn_edge_aggregate_bwd_bf16": 6, "knn_edge_aggregate_bwd_no_wgrads_bf16": 2},
    "gapt": {"gapt_g_fused_bf16": 1},
}
BF16_STEP_PATHS = {"knn20": (KNN150, None, 128), "knn20_route3": (KNN150, "3", 128),
                   "gapt": (GAPT, None, 512)}
# the kernels a bf16 step's profiler trace must name: (label, name pattern, bf16 in name)
# the kernels a bf16 step's trace names (a regular expression, and whether the name
# holds bfloat16)
BF16_TRACE = {"knn20": (("K5", TILES_KNN, False),
                        ("K6", "knn_edge_bwd_kernel<", True)),
              "knn20_route3": (("K7", "knn_search_kernel<", True),
                               ("K8", TILES_KNN, False),
                               ("K6", "knn_edge_bwd_kernel<", True)),
              "gapt": (("K9", "gapt_item_kernel_bf16", False),)}


def bf16_knn_bound(b, n, c, k, kind, moved, wgrads=True) -> dict:
    """Bound of a knn kernel's bf16 mode at the published widths: the fe chain's
    products (forward, K6's recompute) over the dense bf16 tensor cores' rate,
    the search's distances (2 (c + 1) FLOP a pair) over the FP32 rate and K6's
    backward products as split-TF32 (split_tf32_flops), or ``moved``
    bytes (the tensors at their real sizes), whichever is larger."""
    chain = 2 * b * n * k * macs(FE)
    search = 2 * b * n * n * (c + 1)
    bf16_flops, f32_flops, tf32_flops = {
        "k5": (chain, search, 0), "k7": (0, search, 0), "k8": (chain, 0, 0),
        "k6": (chain, 0, split_tf32_flops(chain, wgrads))}[kind]
    ops = (bf16_flops / PEAK_BF16 + f32_flops / PEAK_FP32 + tf32_flops / PEAK_TF32) * 1e3
    mem = moved / PEAK_HBM * 1e3
    return {"bound_ms": max(ops, mem), "bound_by": "operations" if ops >= mem else "bytes",
            "library_ms": None}


def bf16_whole(out, ref) -> tuple[float, float, bool]:
    """Relative L2 error, largest error over max(1, max|ref|), and whether both
    are within BF16_REL_L2 and BF16_MAX_SHARE."""
    o, r = out.float(), ref.float()
    if not o.numel():
        return 0.0, 0.0, True
    rel = ((o - r).norm() / r.norm().clamp_min(1e-30)).item()
    share = (o - r).abs().max().item() / max(1.0, r.abs().max().item())
    return rel, share, rel <= BF16_REL_L2 and share <= BF16_MAX_SHARE


def knn_bf16(d):
    """The knn operands rounded to bf16 (the mask stays float32 for the checks)."""
    out = {k: v.to(torch.bfloat16) if k in ("xs", "xf", "u1", "u2m", "w_d", "g") else v
           for k, v in d.items()}
    out["hidden"] = to_bf16(*d["hidden"])
    return out


def bf16_turns(kernel, a16, a32, plain, inner=1):
    """The bf16 mode and the FP32 mode of one wrapper in turns (fp32, bf16, bf16,
    fp32), best of each, and the bf16 plain version once."""
    ms = {"bf16": float("inf"), "fp32": float("inf")}
    for which in ("fp32", "bf16", "bf16", "fp32"):
        a = a16 if which == "bf16" else a32
        ms[which] = min(ms[which], best_ms(lambda: kernel(*a), inner=inner))
    return {"ms": ms["bf16"], "fp32_ms": ms["fp32"],
            "plain_ms": best_ms(lambda: plain(*a16), reps=2, inner=1)}


def bf16_knn_kernel_checks(kk, dev):
    """K5 (eval; dropout 0.5 with idx; with and without distances), K7 (with and
    without distances), K8 and K6 (with and without weight gradients) in their
    bf16 modes against their bf16 plain versions at knn-20's widths (B=160
    N=150 C=32 k=20) and a ragged N=13 k=5, each launched twice bit for bit
    (K7 equal to K5's search, K8 on its idx to K5's output); then each timed
    beside its FP32 mode in turns, its plain version and its bound at B=160."""
    names = ("knn_fused_layer", "knn_search", "knn_edge_aggregate", "knn_edge_aggregate_bwd")
    worst, identical = dict.fromkeys(names, 0.0), dict.fromkeys(names, True)
    for b, n, c, widths, k in ((160, 150, 32, FE, 20), (3, 13, 8, [24, 16, 12], 5)):
        d = knn_bf16(knn_inputs(dev, b, n, c, widths, k, seed=290 + n))
        keys = kk.knn_keys(d["xs"].float(), d["xf"].float())
        real = d["mask"] > 0
        for self_loops, sum_agg, dists_on, p in ((True, True, False, 0.0),
                                                 (False, False, True, 0.5),
                                                 (True, False, True, 0.0),
                                                 (False, True, False, 0.5)):
            w_d = d["w_d"] if dists_on else None
            fwd = (d["xs"], d["xf"], d["u1"], d["u2m"], w_d, d["hidden"], k, self_loops,
                   dists_on, 0.2, sum_agg, p, 292929)
            out, idx, dists = kk.knn_fused_layer(*fwd, True)
            again = kk.knn_fused_layer(*fwd, True)
            out_eval = kk.knn_fused_layer(*fwd)[0]
            idx7, dists7 = kk.knn_search(d["xs"], d["xf"], k, self_loops, dists_on)
            again7 = kk.knn_search(d["xs"], d["xf"], k, self_loops, dists_on)
            agg = (d["u1"], d["u2m"], idx, dists, w_d, d["hidden"], 0.2, sum_agg, p, 292929)
            out8, again8 = kk.knn_edge_aggregate(*agg), kk.knn_edge_aggregate(*agg)
            ref, idx_ref, dists_ref = kk.knn_fused_layer_reference(*fwd, True)
            ref8 = kk.knn_edge_aggregate_reference(*agg)
            torch.cuda.synchronize()
            agree, differing, far = kk.compare_neighbours(idx, idx_ref, keys, d["mask"])
            err5, bad5 = bf16_err(out[agree], ref[agree], False)
            err8, bad8 = bf16_err(out8, ref8, False)
            bad7 = 0
            if dists_on:
                live = torch.gather(d["mask"][:, None, :, 0].expand(-1, n, -1), 2,
                                    idx_ref.long()) > 0
                live &= agree[..., None]
                bad7 = errors(dists[live], dists_ref[live])[2]
            repeat5 = (torch.equal(out, again[0]) and torch.equal(idx, again[1])
                       and torch.equal(out, out_eval))
            repeat7 = torch.equal(idx7, again7[0]) and torch.equal(idx7, idx)
            if dists_on:
                repeat7 = repeat7 and torch.equal(dists7, dists) and torch.equal(dists7, again7[1])
            repeat8 = torch.equal(out8, again8) and torch.equal(out8, out)
            dtypes_ok = (out.dtype == out8.dtype == torch.bfloat16 and idx.dtype == torch.int32
                         and (dists is None or dists.dtype == torch.float32))
            for name, rep in (("knn_fused_layer", repeat5), ("knn_search", repeat7),
                              ("knn_edge_aggregate", repeat8)):
                identical[name] &= rep
            log("bf16_knn_kernel_check", b=b, n=n, k=k, dropout=p, self_loops=self_loops,
                sum_agg=sum_agg, dists=dists_on, rows_differing=differing, rows_not_near_ties=far,
                k5_max_abs_err=err5, k5_out_of_tol=bad5, k8_max_abs_err=err8, k8_out_of_tol=bad8,
                dists_out_of_tol=bad7, k5_rerun_bit_identical=repeat5,
                k7_rerun_and_k5_search_bit_identical=repeat7,
                k8_rerun_and_k5_output_bit_identical=repeat8, dtypes_ok=dtypes_ok, tol=BF16_TOL)
            if (bad5 or bad8 or bad7 or far or differing > MAX_DIFFERING_SHARE * agree.numel()
                    or not (repeat5 and repeat7 and repeat8 and dtypes_ok)):
                raise SystemExit(f"bf16 K5/K7/K8 disagree at b={b} n={n} p={p} "
                                 f"dists={dists_on}: see the log line above")
            worst["knn_fused_layer"] = max(worst["knn_fused_layer"], err5)
            worst["knn_edge_aggregate"] = max(worst["knn_edge_aggregate"], err8)
            for need in (True, False):
                bwd = (d["u1"], d["u2m"], idx_ref, dists_ref, w_d, d["hidden"], d["g"], 0.2,
                       sum_agg, p, 292929, need)
                res, rerun = kk.knn_edge_aggregate_bwd(*bwd), kk.knn_edge_aggregate_bwd(*bwd)
                rref = kk.knn_edge_aggregate_bwd_reference(*bwd)
                torch.cuda.synchronize()
                flat = lambda t: [x for x in (*t[:5], *t[5]) if x is not None]  # noqa: E731
                repeat = all(torch.equal(x, y) for x, y in zip(flat(res), flat(rerun)))
                pairs = {"du1": (res[0], rref[0]), "du2": (res[1], rref[1]),
                         "dmask": (res[2][real], rref[2][real]),
                         "dmask_masked_senders": (res[2][~real], rref[2][~real])}
                if dists_on:
                    pairs["ddists"] = (res[3], rref[3])
                if need:
                    pairs.update({f"dhidden{i}": (o, r) for i, (o, r) in
                                  enumerate(zip(res[5], rref[5]))})
                    if dists_on:
                        pairs["dw_d"] = (res[4], rref[4])
                split, split_ok = split_tf32_check(
                    kk.knn_edge_aggregate_bwd, kk.knn_edge_aggregate_bwd_reference, bwd, 7,
                    lambda t: {"dx": t[:2], **({"dw": t[5]} if need else {})})
                errs = {name: bf16_err(o, r, True) if o.numel() else (0.0, 0)
                        for name, (o, r) in pairs.items()}
                wholes = {name: bf16_whole(o, r) for name, (o, r) in pairs.items()}
                zeros = need or not any(t.any().item() for t in (*res[5], res[4])
                                        if t is not None)
                dtypes_ok = (all(t.dtype == torch.bfloat16 for t in (*res[:3], *res[5]))
                             and (res[3] is None or res[3].dtype == torch.float32))
                err = max(e for e, _ in errs.values())
                bad = sum(not ok for *_, ok in wholes.values())
                identical["knn_edge_aggregate_bwd"] &= repeat
                log("bf16_knn_kernel_check", kernel="knn_edge_aggregate_bwd", b=b, n=n, k=k,
                    dropout=p, wgrads=need, sum_agg=sum_agg, dists=dists_on,
                    rel_l2_and_share={name: w[:2] for name, w in wholes.items()},
                    rel_l2_tol=BF16_REL_L2, max_share_tol=BF16_MAX_SHARE, failures=bad,
                    max_abs_err={name: e for name, (e, _) in errs.items()},
                    beyond_1e2_of_max={name: c for name, (_, c) in errs.items()},
                    ref_max={name: r.float().abs().max().item() if r.numel() else 0.0
                             for name, (_, r) in pairs.items()},
                    zeros_without_wgrads=zeros, two_runs_bit_identical=repeat,
                    dtypes_ok=dtypes_ok, split_tf32_differing_shares=split,
                    split_max_differing=SPLIT_MAX_DIFFERING)
                if bad or not repeat or not zeros or not dtypes_ok or not split_ok:
                    raise SystemExit(f"bf16 K6 disagrees at b={b} n={n} p={p} wgrads={need} "
                                     f"dists={dists_on}")
                worst["knn_edge_aggregate_bwd"] = max(worst["knn_edge_aggregate_bwd"], err)
                del res, rerun, rref
            del out, again, out_eval, idx7, again7, out8, again8, ref, ref8
        del d, keys
        torch.cuda.empty_cache()

    # the timings at B=160: bf16 and FP32 in turns, the plain version, the bound
    times = {}
    b, n, c, k = 160, 150, 32, 20
    d32 = knn_inputs(dev, b, n, c, FE, k, seed=299)
    d = knn_bf16(d32)
    for job, p, emit, dists_on in (("k5_eval", 0.0, False, False), ("k5_train", 0.5, True, False),
                                   ("k5_train_dists", 0.5, True, True)):
        def fwd(x):
            return (x["xs"], x["xf"], x["u1"], x["u2m"], x["w_d"] if dists_on else None,
                    x["hidden"], k, True, dists_on, 0.2, True, p, 5, emit)
        out = kk.knn_fused_layer(*fwd(d))
        times[job] = dict(shape=f"B={b} N={n} C={c} k={k} dropout {p}"
                          + (", idx written" if emit else "") + (", dists" if dists_on else ""),
                          **bf16_turns(kk.knn_fused_layer, fwd(d), fwd(d32),
                                       kk.knn_fused_layer_reference),
                          **bf16_knn_bound(b, n, c, k, "k5", nbytes(
                              d["xs"], d["xf"], d["u1"], d["u2m"], *d["hidden"],
                              d["w_d"] if dists_on else None, *out)))
        del out
    for job, dists_on in (("k7", False), ("k7_dists", True)):
        idx, dists = kk.knn_search(d["xs"], d["xf"], k, True, dists_on)
        times[job] = dict(shape=f"B={b} N={n} C={c} k={k}" + (" with distances" if dists_on
                                                                 else ""),
                          **bf16_turns(kk.knn_search, (d["xs"], d["xf"], k, True, dists_on),
                                       (d32["xs"], d32["xf"], k, True, dists_on),
                                       kk.knn_search_reference, inner=3),
                          **bf16_knn_bound(b, n, c, k, "k7",
                                           nbytes(d["xs"], d["xf"], idx, dists)))
    idx, _ = kk.knn_search(d["xs"], d["xf"], k, True)
    out = kk.knn_edge_aggregate(d["u1"], d["u2m"], idx, None, None, d["hidden"], 0.2, True, 0.5, 5)
    times["k8"] = dict(shape=f"B={b} N={n} k={k} dropout 0.5",
                       **bf16_turns(kk.knn_edge_aggregate,
                                    (d["u1"], d["u2m"], idx, None, None, d["hidden"], 0.2, True,
                                     0.5, 5),
                                    (d32["u1"], d32["u2m"], idx, None, None, d32["hidden"], 0.2,
                                     True, 0.5, 5), kk.knn_edge_aggregate_reference),
                       **bf16_knn_bound(b, n, c, k, "k8", nbytes(d["u1"], d["u2m"], idx,
                                                                 *d["hidden"], out)))
    for need in (True, False):
        def bwd(x):
            return (x["u1"], x["u2m"], idx, None, None, x["hidden"], x["g"], 0.2, True, 0.5, 5,
                    need)
        res = kk.knn_edge_aggregate_bwd(*bwd(d))
        grads = (*res[:3], *(res[5] if need else ()))
        times["k6" if need else "k6_no_wgrads"] = dict(
            shape=f"B={b} N={n} k={k} dropout 0.5, " + ("with" if need else "without")
            + " weight gradients",
            **bf16_turns(kk.knn_edge_aggregate_bwd, bwd(d), bwd(d32),
                         kk.knn_edge_aggregate_bwd_reference),
            **bf16_knn_bound(b, n, c, k, "k6", nbytes(d["u1"], d["u2m"], idx, d["g"],
                                                      *d["hidden"], *grads), need))
        del res, grads
    del d, d32, idx, out
    torch.cuda.empty_cache()
    return worst, identical, times


def bf16_gapt_kernel_checks(gk, dev, from_args_dict):
    """K9 on bf16 inputs at B=1024 and B=4096 (N=30, E=64, H=4, 4 layers): against
    its bf16 plain version at 1e-2, twice bit for bit, equal to the FP32 launch
    on the widened inputs rounded; timed beside the FP32 mode in turns, the
    plain version and the bound (the float32 body's FLOPs, the bf16 bytes)."""
    from mpgan_tpu_torch.models.registry import build_suite

    args = from_args_dict(GAPT)
    g = build_suite(args).generator(prng_key(29, "cpu"), device=dev)
    w32 = g.fused_weights()
    w16 = gk.GaptWeights(*to_bf16(*w32))
    worst, identical, times = 0.0, True, {}
    for b in (1024, 4096):
        x, mask = gapt_kernel_inputs(dev, g, b, True, seed=b + 29)
        x16, m16 = to_bf16(x, mask)
        with torch.no_grad():
            out, again = gk.gapt_g_fused(x16, m16, w16, 4, 0.2), gk.gapt_g_fused(x16, m16, w16,
                                                                                   4, 0.2)
            wide = gk.gapt_g_fused(x16.float(), m16.float(),
                                   gk.GaptWeights(*(t.float() for t in w16)), 4, 0.2)
            ref = gk.gapt_g_fused_reference(x16, m16, w16, 4, 0.2)
            torch.cuda.synchronize()
            err, bad = bf16_err(out, ref, False)
            repeat = torch.equal(out, again) and torch.equal(out, wide.bfloat16())
            identical &= repeat
            # the bf16 GAPT step's D step calls K9 so: one kernel, no cast around it
            call = one_k9_launch(gk, lambda: gk.gapt_g_fused(x16, m16, w16, 4, 0.2))
            one = call["k9_launches"] == 1 and call["only_allocations"]
            log("bf16_gapt_kernel_check", b=b, n=30, max_abs_err=err, out_of_tol=bad,
                tol=BF16_TOL, two_runs_bit_identical_and_equal_to_widened_fp32=repeat,
                output_bf16=out.dtype == torch.bfloat16, a_call=call)
            if bad or not repeat or out.dtype != torch.bfloat16 or not one:
                raise SystemExit(f"bf16 K9 disagrees at B={b}: {bad} beyond {BF16_TOL}, "
                                 f"bit-identical {repeat}, a call {call}")
            worst = max(worst, err)
            times[f"b{b}"] = dict(
                shape=f"B={b} N=30 E=64 H=4 L=4 masked",
                **bf16_turns(gk.gapt_g_fused, (x16, m16, w16, 4, 0.2), (x, mask, w32, 4, 0.2),
                             gk.gapt_g_fused_reference, inner=3),
                **bound(gapt_flops(b, 30, 64, 4, 3), nbytes(x16, m16, out, *w16)))
        del x, mask, x16, m16, out, again, wide, ref
    # the per-jet path (N=300: qkv in device scratch) on bf16 inputs
    g300 = build_suite(from_args_dict({**GAPT, "num_hits": 300})).generator(
        prng_key(300, "cpu"), device=dev)
    x, mask = gapt_kernel_inputs(dev, g300, 8, True, seed=300)
    x16, m16 = to_bf16(x, mask)
    w300 = gk.GaptWeights(*to_bf16(*g300.fused_weights()))
    with torch.no_grad():
        out = gk.gapt_g_fused(x16, m16, w300, 4, 0.2)
        wide = gk.gapt_g_fused(x16.float(), m16.float(),
                               gk.GaptWeights(*(t.float() for t in w300)), 4, 0.2)
        call = one_k9_launch(gk, lambda: gk.gapt_g_fused(x16, m16, w300, 4, 0.2))
        err, bad = bf16_err(out, gk.gapt_g_fused_reference(x16, m16, w300, 4, 0.2), False)
    same = torch.equal(out, wide.bfloat16())
    one = call["k9_launches"] == 1 and call["only_allocations"]
    log("bf16_gapt_kernel_check", b=8, n=300, max_abs_err=err, out_of_tol=bad, tol=BF16_TOL,
        equal_to_widened_fp32=same, a_call=call, per_jet_path=gk.gapt_plan(
            8, 300, 64, 4, torch.cuda.get_device_properties(dev).multi_processor_count).jets == 0)
    if bad or not same or not one:
        raise SystemExit(f"bf16 K9's per-jet path at N=300: {bad} beyond {BF16_TOL}, equal to "
                         f"the widened FP32 launch {same}, a call {call}")
    identical &= same
    worst = max(worst, err)
    del g300, x, mask, x16, m16, w300, out, wide
    torch.cuda.empty_cache()
    return worst, identical, times


def bf16_trace_named(step, path) -> dict:
    """The kernels of BF16_TRACE[path] that a torch.profiler trace of two steps names."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    names = trace_names(prof)
    return {label: [k[:80] for k in names if re.search(pat, k) and (not bf16 or "bfloat16" in k)]
            [:1] for label, pat, bf16 in BF16_TRACE[path]}


def steps_from_one_state(args, dev, data, labels):
    """A D step and a G step, each on its own TrainState made from the same
    seed (weights, optimizer and draws as the loop's first step): the loss parts
    of both, and the G step's state. The G step's losses then come from the same
    D as the D step's, not from D after its first RMSprop update, which is a
    step of 10 lr along the sign of each gradient: where a gradient is near
    zero its bf16 sign may differ, and knn-20's D, so moved, answers a G step
    with other losses (on an H100 at B=128 one D+G step gave D-step losses
    within 0.6% of float32's but the G loss after it 0.133 against 0.556;
    PERF.md, section 6)."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.train_step import d_step, g_step, step_config

    spec, cfg = build_suite(args).noise, step_config(args)
    st_d, st_g = make_state(args, dev), make_state(args, dev)
    parts = d_step(st_d, cfg, spec, data, labels)
    parts.update(g_step(st_g, cfg, spec, data, labels))
    return {k: v.item() for k, v in parts.items()}, st_g


def bf16_knn_gapt_steps(mk, dev, card, from_args_dict, tmp):
    """The knn-20 (routes 4 and 3, B=128) and GAPT (B=512) bf16 D and G steps,
    each from the float32 steps' state and draws (losses within 5%, every
    master tensor float32, only the bf16 kernels launched, in the counts a step
    predicts, a profiler trace of D+G steps naming them); the bf16 epoch on the
    CUDA graph against the eager loop bit for bit; the bf16 and float32 graph
    steps in turns (float32, bf16, bf16, float32) and a profile of each."""
    from mpgan_tpu_torch.data.loader import BatchLoader

    out = {}
    try:
        for path, (pcard, route, b) in BF16_STEP_PATHS.items():
            set_knn_route(route)
            n = pcard["num_hits"]
            data, labels = (t.to(dev) for t in real_batch(b, n))
            res = {}
            for name, extra in (("f32", {}), ("bf16", {"compute_dtype": "bfloat16"})):
                args = from_args_dict({**pcard, **extra})
                mk.reset_launch_counts()
                parts, st = steps_from_one_state(args, dev, data, labels)
                res[name] = (parts, {k: v for k, v in mk.launch_counts.items() if v}, st, args)
            (l32, c32, _, _), (l16, c16, st16, a16) = res["f32"], res["bf16"]
            rel = max(abs(l16[k] - l32[k]) / abs(l32[k]) for k in l32)
            leaves_f32 = all(t.dtype == torch.float32 for t in _leaves(st16))
            named = bf16_trace_named(step_fn(st16, a16, data, labels), path)
            del res, st16
            torch.cuda.empty_cache()
            # the epoch: eager and graph bit for bit, then float32 and bf16 graphs in turns
            a32 = from_args_dict(pcard)
            a16 = from_args_dict({**pcard, "compute_dtype": "bfloat16"})
            a32.batch_size = a16.batch_size = b
            edata, elabels = graph_data(a16, GRAPH_STEPS * b)
            runs = {}
            for name, args, scan in (("bf16_eager", a16, False), ("bf16_graph", a16, True),
                                     ("f32_graph", a32, True)):
                t = graph_trainer(args, dev, tmp, f"{path}_{name}", scan)
                loader = BatchLoader(edata, elabels, batch_size=b, shuffle=True, seed=args.seed)
                mk.reset_launch_counts()
                t.train_epoch(1, loader)
                torch.cuda.synchronize()
                runs[name] = (t, loader, {k: v for k, v in mk.launch_counts.items() if v})
            (te, _, ce), (tg, _, cg) = runs["bf16_eager"], runs["bf16_graph"]
            same, state_rel = state_diff(te.state, tg.state)
            losses_same = all(te.losses[k] == tg.losses[k] for k in ("Dr", "Df", "D", "G"))
            ms = {"f32_graph": [], "bf16_graph": []}
            epoch = 1
            for which in ("f32_graph", "bf16_graph", "bf16_graph", "f32_graph"):
                epoch += 1
                t, loader, _ = runs[which]
                ms[which].append(timed_epoch(t, epoch, loader))
            prof = {}
            for which in ("f32_graph", "bf16_graph"):
                t, loader, _ = runs[which]
                prof[which] = epoch_profile(t, epoch + 1, loader)
            predicted = BF16_STEP_LAUNCHES[path]
            epoch_predicted = {k: v * GRAPH_STEPS for k, v in predicted.items()}
            log("bf16_knn_gapt_step", card=card, path=path, batch=b, losses_f32=l32,
                losses_bf16=l16, max_rel_loss_diff=rel, tol=BF16_STEP_LOSS_TOL,
                master_state_float32=leaves_f32, launches_f32=c32, launches_bf16=c16,
                predicted_bf16=predicted, trace_kernels=named, graph_state_bit_identical=same,
                graph_max_rel_diff=state_rel, graph_losses_equal=losses_same,
                replays=tg.graphs.replays, epoch_launches_eager=ce, epoch_launches_graph=cg,
                wall_ms_f32=ms["f32_graph"], wall_ms_bf16=ms["bf16_graph"],
                profile_f32=prof["f32_graph"], profile_bf16=prof["bf16_graph"])
            if rel > BF16_STEP_LOSS_TOL or not leaves_f32:
                raise SystemExit(f"bf16 {path} step: losses {l16} against float32 {l32}, "
                                 f"master float32 {leaves_f32}")
            if c16 != predicted or any(k.endswith("_bf16") for k in c32):
                raise SystemExit(f"bf16 {path} step launched {c16}, predicted {predicted}; the "
                                 f"float32 step {c32}")
            if not all(named.values()):
                raise SystemExit(f"bf16 {path} step's trace names none of "
                                 f"{[k for k, v in named.items() if not v]}")
            if (not same or not losses_same or ce != cg or ce != epoch_predicted
                    or not tg.graphs.replays):
                raise SystemExit(f"bf16 {path} graph epoch differs from the eager one: state "
                                 f"{same} ({state_rel}), losses {losses_same}, launches {ce} vs "
                                 f"{cg}, predicted {epoch_predicted}")
            out[path] = {"wall_ms_f32": min(ms["f32_graph"]), "wall_ms_bf16": min(ms["bf16_graph"]),
                         "profile_f32": prof["f32_graph"], "profile_bf16": prof["bf16_graph"],
                         "max_rel_loss_diff": rel}
            del runs, te, tg
            torch.cuda.empty_cache()
    finally:
        set_knn_route()
    return out


def bf16_knn_gapt_cli(mk, train_cli, tmp):
    """``cli.train --compute-dtype bfloat16`` on knn-20 (route 4, and route 3 as
    the split route's main path) at its default batch 160 and on GAPT at 512: 2
    epochs, then a resume that restores the state exactly; the launch counts
    are set to 0 before each run and read after: the bf16 launches equal the
    prediction, every bf16 kernel of the path launched, no FP32 training
    kernel did (the evaluation generates in float32)."""
    runs = {
        "knn20": (["--model", "mpgan", "--num-hits", "150", "--no-fully-connected",
                   "--num-knn", "20", "--num-samples", "3200", "--eval-tot-samples", "640",
                   "--w1-num-samples", "320"], None),
        "knn20_route3": (["--model", "mpgan", "--num-hits", "150", "--no-fully-connected",
                          "--num-knn", "20", "--num-samples", "3200", "--eval-tot-samples", "640",
                          "--w1-num-samples", "320"], "3"),
        "gapt": (["--model", "gapt", "--num-samples", "10000", "--eval-tot-samples", "2000",
                  "--w1-num-samples", "1000"], None),
    }
    counts_all = {}
    try:
        for path, (flags, route) in runs.items():
            set_knn_route(route)
            argv = ["--device", "cuda", "--name", f"bf16_{path}", "--jets", "g", "--dir-path",
                    str(tmp), "--save-model-epochs", "1", "--save-epochs", "2",
                    "--compute-dtype", "bfloat16", "--num-epochs", "2", *flags]
            mk.reset_launch_counts()
            t1 = train_cli.main(argv)
            counts = dict(mk.launch_counts)
            before = [t.detach().cpu().clone() for t in _leaves(t1.state)]
            rng_before = t1.state.rng.clone()
            t2 = train_cli.main(argv)  # resume, no epoch to run
            after = [t.detach().cpu() for t in _leaves(t2.state)]
            restored = (t2.start_epoch == 2 and len(before) == len(after)
                        and all(torch.equal(a, c) for a, c in zip(before, after))
                        and torch.equal(t2.state.rng, rng_before))
            batch = t1.args.batch_size
            steps = 2 * (len(t1.train_dataset) // batch)
            eval_batches = -(-min(t1.args.eval_tot_samples, len(t1.valid_dataset)) // batch)
            predicted = {k: v * steps for k, v in BF16_STEP_LAUNCHES[path].items()}
            # the float32 evaluation at epoch 2: G's 2 knn layers a batch, or K9
            predicted.update({"knn20": {"knn_fused_layer": 2 * eval_batches},
                              "knn20_route3": {"knn_search": 2 * eval_batches,
                                               "knn_edge_aggregate": 2 * eval_batches},
                              "gapt": {"gapt_g_fused": eval_batches}}[path])
            launched = {k: v for k, v in counts.items() if v}
            losses = {k: t1.losses[k] for k in ("Dr", "Df", "D", "G")}
            finite = all(np.isfinite(v).all() for v in losses.values())
            npz = np.load(tmp / f"bf16_{path}" / "models" / "state_2.npz")
            ckpt_f32 = all(npz[k].dtype == np.float32 for k in npz.files
                           if npz[k].dtype.kind in "fV")
            log("bf16_main_path_train", path=path, batch=batch, steps=steps,
                eval_batches=eval_batches, resumed_from=t2.start_epoch, state_restored=restored,
                losses=losses, w1m=t1.losses["w1m"], checkpoint_float32=ckpt_f32,
                launches=launched, predicted=predicted)
            if not restored or not finite or len(t1.losses["G"]) != 2 or not ckpt_f32:
                raise SystemExit(f"bf16 {path} train CLI: restored {restored}, losses {losses}, "
                                 f"float32 checkpoint {ckpt_f32}")
            if launched != predicted:
                raise SystemExit(f"bf16 {path} train CLI launched {launched}, predicted "
                                 f"{predicted}")
            counts_all[path] = counts
    finally:
        set_knn_route()
    return counts_all


def bf16_knn_gapt_phase(kk, gk, mk, train_cli, dev, card, from_args_dict, tmp):
    """Phase 29: bf16 training on the knn-20 and GAPT paths."""
    t0 = time.perf_counter()
    worst, identical, times = bf16_knn_kernel_checks(kk, dev)
    worst["gapt_g_fused"], identical["gapt_g_fused"], gtimes = bf16_gapt_kernel_checks(
        gk, dev, from_args_dict)
    times.update(gtimes)
    steps = bf16_knn_gapt_steps(mk, dev, card, from_args_dict, tmp)
    cli = bf16_knn_gapt_cli(mk, train_cli, tmp)
    launches = {kind: sum(c.get(kind, 0) for c in cli.values())
                for kinds in BF16_KNN_KINDS.values() for kind in kinds}
    never = [k for k, v in launches.items() if not v]
    log("bf16_knn_gapt", card=card, seconds=time.perf_counter() - t0, steps=steps,
        kernel_times=times, main_path_launches=launches)
    if never:
        raise SystemExit(f"phase 29's main paths never launched {never}")
    return worst, identical, times, launches, steps


# ---------------------------------------------------------------------------
# 30. multi-device: the mesh (parallel/mesh.py)
# ---------------------------------------------------------------------------

# phase 30 (a)'s mesh-of-one steps against the step without a mesh: card, batch
MESH_STEPS = {"flagship": (FLAGSHIP, 256),
              "flagship_bf16": ({**FLAGSHIP, "compute_dtype": "bfloat16"}, 256),
              "knn20": (KNN150, 128), "gapt": (GAPT, 512)}
MESH_TURNS = ("plain", "mesh", "mesh", "plain")


def step_draws(args, data, seed):
    """A D+G step's draws on ``data``'s device from the key ``PRNGKey(seed)``, as
    a step without a mesh draws them: the same values at every call (the
    dropout keys are keys below a copy of the key)."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training import train_step as tts

    holder = types.SimpleNamespace(rng=prng_key(seed, data.device))
    cfg, spec = tts.step_config(args), build_suite(args).noise
    return (tts.draw_d(holder, cfg, spec, data),
            tts.draw_g(holder, cfg, spec, data.shape[0], data.device))


def drawn_step(state, args, data, labels, draws, mesh):
    """One D step and one G step with the given draws, on ``mesh`` or none: the
    loss parts."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.train_step import d_step, g_step, step_config

    cfg, spec = step_config(args), build_suite(args).noise
    parts = d_step(state, cfg, spec, data, labels, draws=draws[0], mesh=mesh)
    parts.update(g_step(state, cfg, spec, data, labels, draws=draws[1], mesh=mesh))
    return parts


def state_tensors(state):
    return [t for m in (state.g, state.d) for t in (*m.parameters(), *m.buffers())]


def mesh_of_one_steps(mesh, dev, from_args_dict):
    """Phase 30 (a): each MESH_STEPS step on the mesh of one equals the step
    without a mesh, given the same draws, bit for bit; the reduce's bytes a step."""
    res = {}
    for name, (card, batch) in MESH_STEPS.items():
        args = from_args_dict(card)
        data, labels = (t.to(dev) for t in real_batch(batch, card["num_hits"]))
        out = {}
        for which in ("plain", "mesh"):
            st = make_state(args, dev)
            parts = drawn_step(st, args, data, labels, step_draws(args, data, 5),
                               mesh if which == "mesh" else None)
            out[which] = ({k: v.item() for k, v in parts.items()}, state_tensors(st))
        same = out["plain"][0] == out["mesh"][0] and all(
            torch.equal(a, b) for a, b in zip(out["plain"][1], out["mesh"][1]))
        res[name] = {"batch": batch, "bit_identical": same, "losses": out["mesh"][0],
                     "bucket_bytes": mesh.bucket_bytes()}
        if not same:
            raise SystemExit(f"phase 30: the {name} step on a mesh of one differs from the step "
                             "without a mesh")
    return res


def mesh_trainer(args, dev, tmp, name, scan, mesh):
    from mpgan_tpu_torch.training.config import from_args_dict
    from mpgan_tpu_torch.training.loop import Trainer

    a = from_args_dict(args.to_dict(), apply_processing=False)
    a.name, a.dir_path, a.epoch_scan, a.load_model = name, str(tmp), scan, False
    a.override_load_check = True
    return Trainer(a, device=dev, mesh=mesh)


def mesh_graph_epochs(mesh, dev, from_args_dict, tmp, card):
    """Phase 30 (a): a flagship epoch of GRAPH_STEPS batches on the captured graph
    (the NCCL all-reduce inside it) against the eager mesh epoch, bit for bit;
    then the graph step with and without the mesh in turns, and the reduce's
    device time from a profile of a mesh epoch."""
    from torch.profiler import ProfilerActivity, profile

    from mpgan_tpu_torch.data.loader import BatchLoader
    from mpgan_tpu_torch.parallel.mesh import pmean_

    args = from_args_dict(FLAGSHIP)
    args.batch_size = 256
    data, labels = graph_data(args, GRAPH_STEPS * 256)
    runs = {}
    for name, scan, m in (("eager", False, mesh), ("mesh", True, mesh), ("plain", True, None)):
        t = mesh_trainer(args, dev, tmp, f"mesh_epoch_{name}", scan, m)
        loader = BatchLoader(data, labels if t.use_labels else None, batch_size=256,
                             shuffle=True, seed=args.seed)
        t.train_epoch(1, loader)
        runs[name] = (t, loader)
    (te, _), (tg, _) = runs["eager"], runs["mesh"]
    same, rel = state_diff(te.state, tg.state)
    keys = te.d_loss_keys + ["G"]
    losses_same = all(te.losses[k] == tg.losses[k] for k in keys)
    if not same or not losses_same or tg.graphs.captures != 1 or not tg.graphs.replays:
        raise SystemExit(f"phase 30: the captured mesh epoch differs from the eager one (bit "
                         f"for bit {same}, max rel {rel}, losses {losses_same}, captures "
                         f"{tg.graphs.captures})")
    ms = {"plain": [], "mesh": []}
    epoch = 1
    for which in MESH_TURNS:
        epoch += 1
        t, loader = runs[which]
        ms[which].append(timed_epoch(t, epoch, loader))
    t, loader = runs["mesh"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t.train_epoch(epoch + 1, loader)
        torch.cuda.synchronize()
    reduce_ms = busy = 0.0
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0 and ev.self_cpu_time_total == 0:
            busy += dt / 1e3
            if "nccl" in ev.key.lower():
                reduce_ms += dt / 1e3
    steps = len(loader)
    # the reduce alone, as the D step runs it: D's gradients and 3 loss parts
    grads = [q.grad for q in t.state.d.parameters()] + [torch.zeros((), device=dev)] * 3
    pmean_ms = best_ms(lambda: pmean_(grads, mesh, "timing"), inner=10)
    res = {"batch": 256, "steps": steps, "bit_identical": same, "losses_equal": losses_same,
           "pmean_d_ms": pmean_ms,
           "captures": tg.graphs.captures, "replays": tg.graphs.replays,
           "graph_step_ms_mesh": ms["mesh"], "graph_step_ms_plain": ms["plain"],
           "nccl_device_ms_per_step": reduce_ms / steps, "device_ms_per_step": busy / steps,
           "bucket_bytes": mesh.bucket_bytes()}
    log("mesh_graph_epoch", card=card, **res)
    return res


def mesh_cli(mk, train_cli, gen_cli, mesh, tmp, card):
    """Phase 30 (a): ``cli.train --mesh-shape 1`` for 2 epochs and a resume for a
    third (counts set to 0 before, read after: K2 with dropout, K3 with and
    without weight gradients and K4 launched), then ``cli.gen --mesh-shape 1``'s
    50,000 jets against ``--mesh-shape 0``'s from the same seed, bit for bit."""
    from mpgan_tpu_torch.models.mpgan import MPGenerator
    from mpgan_tpu_torch.training.config import build_mpgan_generator, from_args_dict
    from mpgan_tpu_torch.utils.weights import mp_generator_to_reference_sd

    argv = ["--device", "cuda", "--name", "mesh", "--model", "mpgan", "--jets", "g",
            "--dir-path", str(tmp), "--num-samples", "4000", "--eval-tot-samples", "2000",
            "--w1-num-samples", "1000", "--save-model-epochs", "1", "--save-epochs", "2",
            "--mesh-shape", "1"]
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    t1 = train_cli.main(argv + ["--num-epochs", "2"])
    wall = time.perf_counter() - t0
    t2 = train_cli.main(argv + ["--num-epochs", "3"])
    counts = dict(mk.launch_counts)
    losses = {k: t2.losses[k] for k in ("Dr", "Df", "D", "G")}
    finite = all(np.isfinite(v).all() for v in losses.values())
    log("mesh_train_cli", card=card, wall_s_2_epochs=wall, mesh=[t1.mesh.size, t1.mesh.backend],
        resumed_from=t2.start_epoch, epochs=len(t2.losses["G"]), losses=losses,
        w1m=t2.losses["w1m"], captures=t1.graphs.captures + t2.graphs.captures,
        launches={k: v for k, v in counts.items() if v})
    if (t1.mesh.size, t1.mesh.backend) != (mesh.size, mesh.backend) or t2.start_epoch != 2 \
            or not finite or t2.losses["G"][:2] != t1.losses["G"] or not t1.graphs.captures:
        raise SystemExit(f"cli.train --mesh-shape 1: mesh {t1.mesh}, resumed from "
                         f"{t2.start_epoch}, losses {losses}, captures {t1.graphs.captures}")
    for name in ("edge_aggregate_train", "edge_aggregate_bwd", "edge_aggregate_bwd_no_wgrads",
                 "edge_aggregate_fn"):
        if counts[name] == 0:
            raise SystemExit(f"kernel {name} never launched on the mesh's train path")

    args = from_args_dict(FLAGSHIP)
    (tmp / "card.txt").write_text(repr(args.to_dict()))
    g = MPGenerator(build_mpgan_generator(args), prng_key(0, "cpu"))
    torch.save(mp_generator_to_reference_sd(g), tmp / "G.pt")
    jets, walls = {}, {}
    for shape in ("0", "1"):
        out = tmp / f"gen_{shape}.npy"
        t0 = time.perf_counter()
        gen_cli.main(["--g-args", str(tmp / "card.txt"), "--g-state", str(tmp / "G.pt"),
                      "--output-file", str(out), "--device", "cuda", "--seed", "0",
                      "--num-samples", "50000", "--batch-size", "4096", "--mesh-shape", shape])
        walls[shape] = time.perf_counter() - t0
        jets[shape] = np.load(out)
    equal = np.array_equal(jets["0"], jets["1"])
    log("mesh_gen_cli", card=card, jets=list(jets["1"].shape), bit_identical=equal,
        wall_s={f"mesh_shape_{k}": v for k, v in walls.items()})
    if jets["1"].shape != (50000, 30, 3) or not np.isfinite(jets["1"]).all() or not equal:
        raise SystemExit("cli.gen --mesh-shape 1 differs from --mesh-shape 0")
    return counts


def mesh_rank(p):
    """Phase 30 (b), one rank of a gloo mesh of two ranks on one card: the
    flagship D+G step at the global batch ``p["batch"]`` (this rank's half) on
    the kernel path, then the same 2-rank step on the CPU (the kernels' plain
    versions) from the same state, shard and per-rank draws, in KINK_ROUNDS
    rounds (the first as it is, each later one with the receiver rows at the
    kink that the rounds before found on this rank left out, :class:`KinkRows`;
    every rank takes every round, the reduces being collective); its wall time
    on the card; and the 2-rank sampler. Returns what the parent compares."""
    from mpgan_tpu_torch.parallel.mesh import make_mesh
    from mpgan_tpu_torch.training.config import from_args_dict
    from mpgan_tpu_torch.training.sampling import generate_multi_batch
    from mpgan_tpu_torch.utils.weights import jax_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = make_mesh(devices=[dev, dev])
    args = from_args_dict(FLAGSHIP)
    data, labels = real_batch(p["batch"])
    rows = mesh.rows(p["batch"])
    data, labels = data[rows], labels[rows]
    out = {"backend": mesh.backend, "rank": mesh.rank, "rounds": []}
    with KinkRows() as kinks:
        for r in range(KINK_ROUNDS):
            if r:
                kinks.flag()
            got = {"rows_left_out": kinks.rows_left_out()}
            for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
                kinks.begin(side)
                st = make_state(args, device)
                use_kernels(st, True)  # the CPU runs the kernels' plain versions: the same masks
                x, lab = data.to(device), labels.to(device)
                parts = drawn_step(st, args, x, lab, step_draws(args, x, 100 + mesh.rank), mesh)
                params = jax_leaves(st.d, True) + jax_leaves(st.g, True)
                out["d_tensors"] = len(jax_leaves(st.d, True))
                got[side] = {"losses": {k: v.item() for k, v in parts.items()},
                             "grads": [q.grad.detach().cpu() for q in params],
                             "params": [q.detach().cpu() for q in params]}
            out["rounds"].append(got)
        out["receiver_rows"] = sum(rec["u1"].shape[0] * rec["u1"].shape[1]
                                   for rec in kinks.records["card"]
                                   if rec is not None and rec["kind"] != "mlp")
        out["rows_by_call"] = kinks.rows_by_call()
    # the same step part by part, each part started from the card's state on both sides
    out["parts"] = part_by_part(
        dev, args, data, labels, 1, "mesh_two_ranks", mesh=mesh,
        draws=lambda x: step_draws(args, x, 100 + mesh.rank))
    # the step's wall time on the card (gloo stages its reduces through the host)
    st = make_state(args, dev)
    x, lab = data.to(dev), labels.to(dev)
    walls = []
    for i in range(4):
        draws = step_draws(args, x, 200 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drawn_step(st, args, x, lab, draws, mesh)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["step_wall_ms"] = walls[1:]
    g = make_state(args, dev).g
    lab_all = p["sampler_labels"]
    t0 = time.perf_counter()
    jets = generate_multi_batch(g, p["spec"], prng_key(7, dev),
                                len(lab_all), p["sampler_batch"], labels=lab_all, mesh=mesh)
    out["sampler_wall_s"] = time.perf_counter() - t0
    out["jets"] = jets
    return out


# phase 30 (b)'s depth: the global batch of its 2-rank step (held against the CPU, whose
# plain versions take most of the phase's time) and the jets of its 2-rank sampler
# (256 and 8,192 before the 150-particle phase 34 joined the script)
MESH_TWO_RANKS_BATCH = 128
MESH_TWO_RANKS_JETS = 4096


def mesh_two_ranks(dev, from_args_dict, card):
    """Phase 30 (b): two ranks of gloo on one card (``make_mesh(devices=[cuda:0,
    cuda:0])``). The 2-rank step on the card against the 2-rank step on the CPU
    (losses and gradients within phase 8's rtol = atol = 1e-4, gradients of
    max(1, max|ref|), the updated parameters where the gradient is clear of
    zero, 1e-3, within 1e-4 too, RMSprop's first step being about 10 * lr *
    sign(g)), at the first round of :func:`mesh_rank` that holds on every rank
    (the kink's rows left out after the first, logged); the parameters
    bit-identical across the ranks; the 2-rank sampler against one rank's at
    rtol = atol = 1e-4, the mask column equal."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.parallel.mesh import launch
    from mpgan_tpu_torch.training.sampling import generate_multi_batch

    args = from_args_dict(FLAGSHIP)
    spec = build_suite(args).noise
    lab = real_batch(MESH_TWO_RANKS_JETS)[1].numpy()
    p = {"batch": MESH_TWO_RANKS_BATCH, "spec": spec, "sampler_labels": lab,
         "sampler_batch": MESH_TWO_RANKS_JETS // 2}
    t0 = time.perf_counter()
    ranks = launch(mesh_rank, 2, "cuda", p)
    wall = time.perf_counter() - t0
    single = generate_multi_batch(make_state(args, dev).g, spec,
                                  prng_key(7, dev), len(lab), p["sampler_batch"],
                                  labels=lab)
    res = {"seconds": wall, "backend": [r["backend"] for r in ranks],
           "step_wall_ms": [r["step_wall_ms"] for r in ranks],
           "sampler_wall_s": [r["sampler_wall_s"] for r in ranks]}
    def held(rnd, nd):
        """One rank's round: the card against the CPU."""
        c, h = rnd["card"], rnd["cpu"]
        loss_err = max(abs(c["losses"][k] - h["losses"][k]) / max(1.0, abs(h["losses"][k]))
                       for k in h["losses"])
        over = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(c["grads"], h["grads"])]
        param_err = max(((a - b).abs() * (g.abs() > 1e-3)).max().item()
                        for a, b, g in zip(c["params"], h["params"], h["grads"]))
        return {"losses_card": c["losses"], "losses_cpu": h["losses"],
                "max_rel_loss_err": loss_err, "max_grad_err_over_bound_d": max(over[:nd]),
                "max_grad_err_over_bound_g": max(over[nd:]),
                "max_param_err_where_grad_clear": param_err,
                "rows_left_out": rnd["rows_left_out"],
                "tensors_beyond_tol": [i for i, e in enumerate(over) if e > TOL],
                "ok": loss_err <= TOL and max(over) <= TOL and param_err <= TOL}

    rounds = [[held(rnd, r["d_tensors"]) for rnd in r["rounds"]] for r in ranks]
    first = next((i for i in range(KINK_ROUNDS) if all(rr[i]["ok"] for rr in rounds)), None)
    res["round_held"] = first
    bad = []
    for r, rr in zip(ranks, rounds):
        sampler_abs, _, sampler_bad = errors(torch.as_tensor(r["jets"]), torch.as_tensor(single))
        mask_equal = np.array_equal(r["jets"][..., -1], single[..., -1])
        res[f"rank{r['rank']}"] = {
            "rounds": [{k: v for k, v in x.items() if k not in ("losses_card", "losses_cpu")}
                       for x in rr],
            **{k: v for k, v in rr[0 if first is None else first].items()},
            "receiver_rows": r["receiver_rows"], "kink_rows_by_call": r["rows_by_call"],
            "sampler_max_abs_err": sampler_abs, "sampler_out_of_tol": sampler_bad,
            "sampler_mask_column_equal": mask_equal}
        if first is None or sampler_bad or not mask_equal:
            bad.append(r["rank"])
    same = all(torch.equal(a, b) for rnd in range(KINK_ROUNDS) for side in ("card", "cpu")
               for a, b in zip(ranks[0]["rounds"][rnd][side]["params"],
                               ranks[1]["rounds"][rnd][side]["params"]))
    res["params_bit_identical_across_ranks"] = same
    log("mesh_two_ranks", card=card, **res)
    if bad or not same or res["backend"] != ["gloo", "gloo"]:
        raise SystemExit(f"phase 30: the 2-rank gloo step or sampler disagrees (ranks {bad}, "
                         f"parameters equal across ranks {same})")
    # part by part: each part's first round that holds on every rank
    held = [next((i for i in range(KINK_ROUNDS)
                  if all(r["parts"][p]["rounds"][i]["ok"] for r in ranks)), None)
            for p in range(len(ranks[0]["parts"]))]
    missed = [parts_held(f"mesh_two_ranks_rank{r['rank']}", r["parts"], held) for r in ranks]
    if any(missed):
        raise SystemExit(f"phase 30: parts of the 2-rank step started from the card's state "
                         f"disagree with the CPU: {missed}")
    return res


def mesh_phase(mk, train_cli, gen_cli, dev, card, from_args_dict, tmp):
    """Phase 30: the mesh. (a) an NCCL mesh of one rank at full width: the steps
    against no mesh, the captured epoch against the eager one, the CLIs; (b) a
    gloo mesh of two ranks on the card against the same mesh on the CPU."""
    from mpgan_tpu_torch.parallel.mesh import close, make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(1)
    if mesh.backend != "nccl":
        raise SystemExit(f"phase 30: a mesh of one card runs {mesh.backend}, not nccl")
    steps = mesh_of_one_steps(mesh, dev, from_args_dict)
    log("mesh_of_one_steps", card=card, steps=steps)
    epochs = mesh_graph_epochs(mesh, dev, from_args_dict, tmp, card)
    counts = mesh_cli(mk, train_cli, gen_cli, mesh, tmp, card)
    torch.cuda.synchronize()
    close()  # the NCCL world of one ends; phase (b)'s ranks make their own
    log("mesh_of_one_closed", seconds=time.perf_counter() - t0)
    two = mesh_two_ranks(dev, from_args_dict, card)
    log("mesh", card=card, seconds=time.perf_counter() - t0,
        graph_step_ms_mesh=min(epochs["graph_step_ms_mesh"]),
        graph_step_ms_plain=min(epochs["graph_step_ms_plain"]),
        nccl_device_ms_per_step=epochs["nccl_device_ms_per_step"],
        pmean_d_ms=epochs["pmean_d_ms"],
        bucket_bytes=epochs["bucket_bytes"], gloo_two_rank_step_wall_ms=two["step_wall_ms"])
    return counts


# ---------------------------------------------------------------------------
# 31. the steps' random stream on the card (ops/prng.py, csrc/threefry.cu)
# ---------------------------------------------------------------------------

PRNG_PATHS = {"flagship": (FLAGSHIP, 256), "knn20": (KNN150, 128), "gapt": (GAPT, 512)}
PRNG_NORMAL_TOL = 0.0  # normals too: both sides round every step alike (ops/prng.py)
THREEFRY_OPS = 80  # 32-bit operations of one threefry2x32 block (20 rounds, 5 injections)
ERF_INV_OPS = 40  # a normal's further operations (log1p, sqrt, the polynomial)


def threefry_bound(plan) -> dict:
    """Bound of one ``threefry_draws`` launch of ``plan``: every output word
    written once and the plan, key, counter and order row read once, over the
    memory rate; or the threefry blocks its elements and path walks take and the
    normals' erf_inv, over 67 Tops (one 32-bit lane operation a clock a lane),
    whichever is larger."""
    from mpgan_tpu_torch.ops import prng

    moved = plan.words * 4 + plan.table.numel() * 4 + 8 + 8 + 8
    ops = 0
    for r in plan.rows:
        blocks = max(1, -(-r.elements // prng.EPB))
        per = {"edge_seed": 3, "key": 0, "order": 0}.get(r.dist, 1)
        ops += r.elements * per * THREEFRY_OPS + blocks * len(r.path) * THREEFRY_OPS
        if r.dist == "normal":
            ops += r.elements * ERF_INV_OPS
        if r.dist == "order":
            moved += r.elements * 4
    out = bound(0, moved)
    t_ops = ops / PEAK_FP32 * 1e3
    if t_ops > out["bound_ms"]:
        out.update(bound_ms=t_ops, bound_by="operations")
    return out


def threefry_check(plan, key, counters, order=None) -> float:
    """``threefry_draws`` on the card against its plain version at each batch
    counter, advancing the key once and the counter: every draw bit for bit
    (normals within PRNG_NORMAL_TOL, 0); returns the largest normal difference."""
    from mpgan_tpu_torch.ops import prng

    worst = 0.0
    dev = key.device
    for c in counters:
        outs = {}
        for side in ("kernel", "plain"):
            k = key.clone()
            counter = torch.tensor([c], dtype=torch.int32, device=dev)
            out = torch.full((plan.words,), -7, dtype=torch.int32, device=dev)
            fn = prng.threefry_draws if side == "kernel" else prng.threefry_draws_reference
            fn(k, plan, out, counter, order, advance=1, bump=True)
            outs[side] = (out, k, counter)
        torch.cuda.synchronize()
        (ok_, kk_, ck), (op_, kp, cp) = outs["kernel"], outs["plain"]
        if not (torch.equal(kk_, kp) and torch.equal(ck, cp)):
            raise SystemExit(f"threefry_draws: next key or counter differs from the plain "
                             f"version's at counter {c}")
        for r, a, b in zip(plan.rows, plan.views(ok_), plan.views(op_)):
            if r.dist == "normal":
                err = (a - b).abs().max().item() if a.numel() else 0.0
                worst = max(worst, err)
                if not torch.allclose(a, b, rtol=PRNG_NORMAL_TOL, atol=PRNG_NORMAL_TOL):
                    raise SystemExit(f"threefry_draws: normals {r.shape} at path {r.path} "
                                     f"beyond {PRNG_NORMAL_TOL} of the plain version ({err})")
            elif not torch.equal(a.view(torch.int32) if a.dtype == torch.uint32 else a,
                                 b.view(torch.int32) if b.dtype == torch.uint32 else b):
                raise SystemExit(f"threefry_draws: {r.dist} {r.shape} at path {r.path} "
                                 f"differs from the plain version at counter {c}")
    return worst


def threefry_times(plan, key, order=None) -> dict:
    """The kernel's and the plain version's ms for one launch of ``plan``, with its bound."""
    from mpgan_tpu_torch.ops import prng

    dev = key.device
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty(plan.words, dtype=torch.int32, device=dev)
    kernel = lambda: prng.threefry_draws(key, plan, out, counter, order)  # noqa: E731
    plain = lambda: prng.threefry_draws_reference(key, plan, out, counter, order)  # noqa: E731
    ms = {"kernel": float("inf"), "plain": float("inf")}
    for which in ("plain", "kernel", "kernel", "plain"):
        ms[which] = min(ms[which], best_ms(kernel if which == "kernel" else plain,
                                           inner=20 if which == "kernel" else 1))
    return {"ms": ms["kernel"], "plain_ms": ms["plain"], **threefry_bound(plan),
            "rows": len(plan.rows), "words": plan.words, "blocks": plan.blocks}


def prng_plans(mk, dev, card, from_args_dict):
    """Phase 31 (a): each captured step's plan and the sampler's, the kernel
    against its plain version, then timed."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.ops import prng
    from mpgan_tpu_torch.training import train_step as tts
    from mpgan_tpu_torch.training.sampling import noise_spec

    worst, times = 0.0, {}
    for name, (model, b) in PRNG_PATHS.items():
        args = from_args_dict(model)
        args.batch_size = b
        data, labels = graph_data(args, 2 * b)
        st = make_state(args, dev)
        suite = build_suite(args)
        keys = ["Dr", "Df", "D", "G"] + (["gp"] if args.gp else [])
        graphs = tts.StepGraphs(st, tts.step_config(args), suite.noise, keys, dev,
                                post_gen=suite.post_gen)
        order = np.arange(2 * b).reshape(2, b)
        graphs.epoch(tts.step_kinds(2), torch.as_tensor(data, device=dev),
                     None if labels is None else torch.as_tensor(labels, device=dev), order)
        step = graphs.steps["dg"]
        worst = max(worst, threefry_check(step.plan, st.rng, (0, 1), step.order))
        times[name] = threefry_times(step.plan, st.rng, step.order)
        times[name]["key_slots"] = sum(len(sl.log) for sl in step.slots)
        del graphs, step, st
        torch.cuda.empty_cache()
    spec = noise_spec("mpgan", {"latent_node_size": 32}, 30, 0.2)
    plan = prng.Plan(spec.rows(4096, (prng.COUNTER,)), dev)
    key = prng_key(0, dev)
    worst = max(worst, threefry_check(plan, key, (0, 12)))
    times["sampler"] = threefry_times(plan, key)
    log("prng_plans", card=card, max_abs_err_normals=worst, tol=PRNG_NORMAL_TOL, plans=times)
    return worst, times


def keyed_steps_agree(sides) -> tuple[float, list, str | None]:
    """Phase 31 (b)'s steps, card against CPU: the largest relative loss
    difference, each step's largest gradient difference over its scale, and
    what disagrees (None where nothing does): a key, a loss beyond TOL, or the
    first step's gradients beyond TOL (later steps start from parameters that
    RMSprop moved by about lr * sign(g), where a gradient within rounding of
    zero may take either sign on the two devices)."""
    loss_err, grad_ratio = 0.0, []
    for i, ((lc, gc, kc), (lp, gp, kp)) in enumerate(zip(sides["card"], sides["cpu"])):
        loss_err = max([loss_err] + [abs(lc[k] - lp[k]) / max(1.0, abs(lp[k])) for k in lp])
        grad_ratio.append(max(wgrad_err(a, b)[0] / max(1.0, b.abs().max().item())
                              for a, b in zip(gc, gp)))
        if not torch.equal(kc, kp) or loss_err > TOL or (i == 0 and grad_ratio[0] > TOL):
            return loss_err, grad_ratio, (
                f"keyed step {i + 1} on the card disagrees with the CPU (loss {loss_err}, "
                f"gradients {grad_ratio}, keys {kc.tolist()} {kp.tolist()})")
    return loss_err, grad_ratio, None


def prng_steps(mk, dev, card, from_args_dict, tmp):
    """Phase 31 (b-d): keyed steps on the card against the CPU; a captured epoch
    against the eager one, profiled; issue ms, idle share and wall ms of the
    graph steps. Returns the graph steps' figures and the ``threefry_draws``
    launches of the profiled epoch."""
    from torch.profiler import ProfilerActivity, profile

    from mpgan_tpu_torch.data.loader import BatchLoader
    from mpgan_tpu_torch.ops import prng
    from mpgan_tpu_torch.utils.weights import jax_leaves

    # (b) three keyed flagship steps, card against CPU, the key after each; the
    # first step's gradients as phase 8 holds them (where a round misses 1e-4, the
    # next leaves out the rows at LeakyReLU's kink that it found, KinkRows)
    args = from_args_dict({**FLAGSHIP, "disc_dropout": 0.5})
    data, labels = real_batch(16)
    rounds = []
    with KinkRows() as kinks:
        for _ in range(KINK_ROUNDS):
            sides = {}
            for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
                kinks.begin(side)
                st = make_state(args, device)
                use_kernels(st, True)
                step = step_fn(st, args, data.to(device), labels.to(device))
                res = []
                for _ in range(3):
                    parts = {k: v.item() for k, v in step().items()}
                    grads = [p.grad.detach().cpu().clone()
                             for p in jax_leaves(st.d, True) + jax_leaves(st.g, True)]
                    res.append((parts, grads, st.rng.cpu().clone()))
                sides[side] = res
            rounds.append(kinks.rows_left_out())
            loss_err, grad_ratio, fault = keyed_steps_agree(sides)
            if fault is None or kinks.flag() == 0:
                break
    log("prng_keyed_steps", steps=3, batch=16, max_rel_loss_err=loss_err, tol=TOL,
        max_grad_err_over_scale_by_step=grad_ratio, keys_bit_identical=fault is None,
        kink_rows_left_out_by_round=rounds, kink_rows_by_call=kinks.rows_by_call())
    if fault is not None:
        raise SystemExit(f"phase 31: {fault}")
    bad = parts_held("prng_keyed_steps", part_by_part(dev, args, data, labels, 3,
                                                      "prng_keyed_steps"))
    if bad:
        raise SystemExit(f"phase 31: parts of the keyed steps started from the card's state "
                         f"disagree with the CPU: {bad}")

    # (c) the captured 5-batch epoch against the eager one, then a profile of it
    b = 256
    args = from_args_dict(FLAGSHIP)
    args.batch_size = b
    data, labels = graph_data(args, GRAPH_STEPS * b)
    runs = {}
    for scan in (False, True):
        t = graph_trainer(args, dev, tmp, f"prng_{int(scan)}", scan)
        loader = BatchLoader(data, labels, batch_size=b, shuffle=True, seed=args.seed)
        t.train_epoch(1, loader)
        runs[scan] = (t, loader)
    torch.cuda.synchronize()
    same, rel = state_diff(runs[False][0].state, runs[True][0].state)
    if not same:
        raise SystemExit(f"phase 31: the captured epoch differs from the eager one ({rel})")
    t, loader = runs[True]
    mk.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t.train_epoch(2, loader)
        torch.cuda.synchronize()
    draws = prng.launch_counts["threefry_draws"]
    events = prof.events()
    h2d = [e.name for e in events if "HtoD" in e.name or "Host to Device" in e.name]
    rand_ops = [e.name for e in events if e.name.startswith("aten::") and any(
        w in e.name for w in ("rand", "normal_", "uniform_", "bernoulli", "random_",
                              "multinomial"))]
    kernels = sum(1 for e in events if "threefry_draws_kernel" in e.name)
    # the runtime's copy and sync calls the epoch made, by name (the trace's own
    # names for copies and memsets beside them)
    calls = {}
    for e in events:
        if any(w in e.name for w in ("emcpy", "emset", "ynchronize", "GraphLaunch")):
            calls[e.name] = calls.get(e.name, 0) + 1
    log("prng_epoch_profile", card=card, batches=GRAPH_STEPS, bit_identical_to_eager=same,
        host_to_device_copies=len(h2d), copies=sorted(set(h2d)), cpu_random_calls=rand_ops,
        threefry_draws_launches=draws, threefry_kernels_in_trace=kernels,
        replays=t.graphs.replays, copy_sync_and_graph_calls=calls)
    # the runtime's copy calls: the order in, the losses out (the device-side copy
    # records are not always all in the trace)
    if len(h2d) > 1 or calls.get("cudaMemcpyAsync", 0) > 2 or rand_ops \
            or draws != GRAPH_STEPS:
        raise SystemExit(f"phase 31: the captured epoch made {len(h2d)} host-to-device copies "
                         f"and {calls.get('cudaMemcpyAsync', 0)} copy calls (the order's and "
                         f"the losses' only allowed), CPU random calls {rand_ops}, "
                         f"{draws} threefry_draws launches for {GRAPH_STEPS} steps")
    runs = t = None
    torch.cuda.empty_cache()

    # (d) issue ms, idle share and wall ms of the graph steps
    steps = {}
    for name, (model, b) in PRNG_PATHS.items():
        a = from_args_dict(model)
        a.batch_size = b
        data, labels = graph_data(a, GRAPH_STEPS * b)
        t = graph_trainer(a, dev, tmp, f"prng_{name}", True)
        loader = BatchLoader(data, labels if t.use_labels else None, batch_size=b,
                             shuffle=True, seed=a.seed)
        t.train_epoch(1, loader)  # records, warms up, captures
        wall = [timed_epoch(t, 2 + i, loader) for i in range(2)]
        steps[name] = {"batch": b, "wall_ms": min(wall), "issue_ms": issue_epoch(t, 4, loader),
                       **epoch_profile(t, 5, loader)}
        t = None
        torch.cuda.empty_cache()
    log("prng_graph_steps", card=card, steps=steps)
    return steps, draws


def prng_phase(mk, dev, card, from_args_dict, tmp):
    """Phase 31: the steps' random stream on the card."""
    t0 = time.perf_counter()
    worst, times = prng_plans(mk, dev, card, from_args_dict)
    steps, draws = prng_steps(mk, dev, card, from_args_dict, tmp)
    log("prng", card=card, seconds=time.perf_counter() - t0)
    return worst, times, steps, draws


# ---------------------------------------------------------------------------
# 32. models initialised from the threefry key on the card (ops/init.py)
# ---------------------------------------------------------------------------

# TreeGAN at its published widths: the branch tensor of its last depth,
# [16, 64, 128], is the largest single draw of any model
TREEGAN = {"model": "treegan", "model_D": "rgan", "jets": "g", "num_hits": 30}
INIT_MODELS = {"flagship": FLAGSHIP, "knn20": KNN150, "gapt": GAPT, "treegan": TREEGAN}
INIT_DERIVED_TOL = 1e-6  # weight_u (a normalised normal draw) and weight_v (from it)
INIT_SEED = 7


def init_compare(got: dict, want: dict, what: str) -> float:
    """Two state dicts (or FPND trees, flattened): drawn leaves and constants bit
    for bit, the leaves derived from draws within INIT_DERIVED_TOL. Returns the
    largest derived difference."""
    worst = 0.0
    if got.keys() != want.keys():
        raise SystemExit(f"phase 32: {what}: state dict keys differ")
    for name, a in got.items():
        a, b = a.detach().cpu(), want[name].detach().cpu()
        if str(name).endswith(("weight_u", "weight_v")):
            err = (a - b).abs().max().item() if a.numel() else 0.0
            worst = max(worst, err)
            if err > INIT_DERIVED_TOL:
                raise SystemExit(f"phase 32: {what}.{name} on the card {err} from the CPU's")
        elif a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.view(torch.int32) if a.dtype == torch.float32 else a,
                b.view(torch.int32) if b.dtype == torch.float32 else b):
            raise SystemExit(f"phase 32: {what}.{name} drawn on the card differs from the "
                             "CPU's draw")
    return worst


def timed_init(build, reps=3) -> tuple[torch.nn.Module, dict]:
    """``build()`` on the card ``reps`` times: the module, and the wall ms
    (synchronised) of the first build (no draw's plan kept, as in a model's one
    init) and the least of the others (the plans kept by ``prng.draw``), with
    the ``threefry_draws`` launches of one build."""
    from mpgan_tpu_torch.ops import prng

    prng._plan.cache_clear()
    times, module, launches = [], None, 0
    for _ in range(reps):
        module = None
        torch.cuda.synchronize()
        before = prng.launch_counts["threefry_draws"]
        t0 = time.perf_counter()
        module = build()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = prng.launch_counts["threefry_draws"] - before
    return module, {"ms": times[0], "ms_again": min(times[1:], default=None),
                    "launches": launches}


def init_phase(mk, dev, card, from_args_dict, tmp):
    """Phase 32: each model of the main paths, TreeGAN's G and FPND's random
    trunk drawn on the card and on the CPU from one key, every drawn leaf bit for
    bit (the kernel against its plain version), the derived ones within 1e-6;
    a Trainer built on the card from --seed against the CPU's. Returns the
    ``threefry_draws`` launches of the card's builds (counts set to 0 before
    them) and the init's ms and launches per model."""
    from mpgan_tpu_torch.evaluation import fpnd as F
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.ops import prng
    from mpgan_tpu_torch.training import checkpoint as tckpt
    from mpgan_tpu_torch.utils.weights import jax_leaves

    t_phase = time.perf_counter()
    key_cpu = prng.PRNGKey(INIT_SEED)
    key_dev = prng.PRNGKey(INIT_SEED, dev)
    cpu_models, per_model, worst = {}, {}, 0.0
    for name, model in INIT_MODELS.items():
        suite = build_suite(from_args_dict(model))
        sides = [("G", suite.generator)] + ([] if name == "treegan" else
                                           [("D", suite.discriminator)])
        for side, build in sides:
            cpu_models[f"{name}_{side}"] = (build, build(key_cpu))
    mk.reset_launch_counts()
    for what, (build, cpu) in cpu_models.items():
        module, per_model[what] = timed_init(lambda: build(key_dev, device=dev))
        worst = max(worst, init_compare(module.state_dict(), cpu.state_dict(), what))
        per_model[what]["parameters"] = sum(p.numel() for p in module.parameters())
    # FPND's trunk: normals drawn straight into the weights, all bit for bit
    trunk, per_model["fpnd_trunk"] = timed_init(lambda: F.particlenet_init(device=dev))
    leaves = lambda tree: dict(enumerate(_tree_tensors(tree)))  # noqa: E731
    init_compare(leaves(trunk), leaves(F.particlenet_init()), "fpnd_trunk")
    per_model["fpnd_trunk"]["parameters"] = sum(x.numel() for x in _tree_tensors(trunk))

    # the Trainer from --seed: on the card against the CPU, leaf by leaf, its key too
    args = from_args_dict({**FLAGSHIP, "seed": INIT_SEED, "spectral_norm_disc": True})
    t_card, per_model["trainer_flagship_sn"] = timed_init(
        lambda: graph_trainer(args, dev, tmp, "init_card", True), reps=1)
    t_cpu = graph_trainer(args, torch.device("cpu"), tmp, "init_cpu", False)
    u = {t.data_ptr() for m in (t_cpu.state.g, t_cpu.state.d)
         for n, t in m.named_buffers() if n.endswith("weight_u")}
    derived = {i for i, t in enumerate(
        jax_leaves(t_cpu.state.g, True) + jax_leaves(t_cpu.state.g, False)
        + jax_leaves(t_cpu.state.d, True) + jax_leaves(t_cpu.state.d, False))
        if t.data_ptr() in u}
    got, want = tckpt.train_state_leaves(t_card.state), tckpt.train_state_leaves(t_cpu.state)
    trainer_err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if i in derived:
            trainer_err = max(trainer_err, float(np.abs(a - b).max()))
        elif not np.array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                np.asarray(b).reshape(-1).view(np.uint8)):
            raise SystemExit(f"phase 32: Trainer leaf {i} on the card differs from the CPU's")
    if len(got) != len(want) or not derived or trainer_err > INIT_DERIVED_TOL:
        raise SystemExit(f"phase 32: the card's Trainer state against the CPU's: {len(got)} "
                         f"and {len(want)} leaves, u at {trainer_err}")
    draws = prng.launch_counts["threefry_draws"]
    t_card = t_cpu = None
    torch.cuda.empty_cache()
    log("init_on_card", card=card, seed=INIT_SEED, models=per_model,
        max_abs_err_derived=max(worst, trainer_err), tol_derived=INIT_DERIVED_TOL,
        drawn_leaves_bit_identical=True, trainer_leaves=len(got),
        threefry_draws_launches=draws, seconds=time.perf_counter() - t_phase)
    if draws == 0:
        raise SystemExit("phase 32: threefry_draws never launched by the card's init")
    return draws, per_model


# phase 33: the MP layer's configuration lattice on the card
LATTICE_CASES = 48  # tests/test_kernel_fuzz.py's points: its sampler, seeds 4242 + case
LATTICE_WIDE = 8  # points at the published widths, their flags from Random(7000 + i)
LATTICE_PLAN_SMS = 7  # a dense dropout point's second plan: the plans for 7 SMs
LATTICE_ROUTES = {"4": ("4", "1"), "3": ("3", "1")}  # MPGAN_TPU_KNN_KERNEL, _SELECT


def lattice_sample(r) -> dict:
    """``tests/test_kernel_fuzz.py``'s ``_sample`` (a CPU test holds the two equal)."""
    s = {}
    s["fully_connected"] = r.random() < 0.5
    s["pos_diffs"] = r.random() < 0.6
    s["all_ef"] = r.random() < 0.5
    s["delta_r"] = r.random() < 0.6
    s["delta_coords"] = r.random() < 0.35
    s["coords"] = r.choice(["polarrel", "cartesian"])
    s["clabels"] = r.choice([0, 0, 1, 2])
    s["mask_fne_np"] = r.random() < 0.35
    s["sum_agg"] = r.random() < 0.7
    s["self_loops"] = r.random() < 0.7
    s["dropout_p"] = r.choice([0.0, 0.0, 0.3])
    s["spectral_norm"] = r.random() < 0.3
    s["batch_norm"] = r.random() < 0.15
    s["masked"] = r.random() < 0.75
    s["num_knn"] = r.choice([3, 4])
    s["n"] = r.choice([13, 16]) if s["fully_connected"] else r.choice([9, 14])
    s["f"] = r.choice([4, 6])
    s["h1"] = r.choice([8, 16])
    s["h2"] = r.choice([8, 12])
    s["out"] = r.choice([4, 6])
    s["block"] = r.choice([8, 16])
    s["kernel"] = r.choice(["1", "2", "3", "4"])
    s["select"] = r.choice(["0", "1"])
    return s


def lattice_points() -> list[dict]:
    """The 48 points at JAX's shapes (B = 2, its widths), 8 at the published
    widths (fe [96, 160, 192], fn [256, 256], node size 32; dense at N = 30,
    B = 64, knn at N = 150, k = 20, B = 16 under routes 4 and 3), one on the
    K4 route at those widths and two conditioned dense ones with dropout."""
    points = []
    for case in range(LATTICE_CASES):
        s = lattice_sample(random.Random(4242 + case))
        points.append({**s, "case": case, "seed": case, "b": 2, "fe": [s["h1"], s["h2"]],
                       "fn": [s["h2"]]})
    for i in range(LATTICE_WIDE):
        s = lattice_sample(random.Random(7000 + i))
        dense = s["fully_connected"]
        points.append({**s, "case": f"wide{i}", "seed": 7000 + i, "f": 32, "out": 32,
                       "fe": list(FE), "fn": [256, 256], "b": 64 if dense else 16,
                       "n": 30 if dense else 150, "num_knn": s["num_knn"] if dense else 20})
    # the K4 route (eval, no conditioning, no SN or BN) with gradients, which no
    # sampled point takes: a dense published-width layer
    points.append({**points[LATTICE_CASES], "case": "k4", "seed": 7100, "fully_connected": True,
                   "pos_diffs": False, "clabels": 0, "mask_fne_np": False, "dropout_p": 0.0,
                   "spectral_norm": False, "batch_norm": False, "masked": True, "b": 64,
                   "n": 30})
    # K2 and K3 in train mode with dropout on the conditioned first layer (the
    # labels and particle counts folded into u2), which every sampled dense
    # published-width point leaves to the plain path (pos_diffs): wide4 and
    # wide5 without pos_diffs, dropout 0.3; the second with 2 labels, mean
    # aggregation and spectral norm
    wide = points[LATTICE_CASES:LATTICE_CASES + LATTICE_WIDE]
    points.append({**wide[4], "case": "cond1", "seed": 7101, "pos_diffs": False,
                   "mask_fne_np": True, "clabels": 1, "dropout_p": 0.3})
    points.append({**wide[5], "case": "cond2", "seed": 7102, "pos_diffs": False,
                   "mask_fne_np": True, "clabels": 2, "dropout_p": 0.3, "sum_agg": False,
                   "spectral_norm": True})
    return points


def lattice_flags(s) -> str:
    """A point's flags in a few characters."""
    on = [name for name, flag in (("pd", "pos_diffs"), ("ae", "all_ef"), ("dr", "delta_r"),
                                  ("dc", "delta_coords"), ("np", "mask_fne_np"),
                                  ("sum", "sum_agg"), ("sl", "self_loops"),
                                  ("sn", "spectral_norm"), ("bn", "batch_norm"),
                                  ("m", "masked")) if s[flag]]
    knn = "" if s["fully_connected"] else f" knn{s['num_knn']} K{s['kernel']}S{s['select']}"
    return (f"{'dense' if s['fully_connected'] else 'knn'} {' '.join(on)} {s['coords'][:4]} "
            f"cl{s['clabels']} p{s['dropout_p']} b{s['b']} n{s['n']} f{s['f']} "
            f"fe{s['fe']} fn{s['fn']} o{s['out']}{knn}")


def lattice_cfg_args(s, dropout_p) -> tuple[tuple, dict]:
    """``MPLayerConfig.build``'s arguments at point ``s`` (either package's)."""
    return (s["f"], s["fe"], s["fn"], s["out"]), dict(
        linear_args={"dropout_p": dropout_p, "spectral_norm": s["spectral_norm"],
                     "batch_norm": s["batch_norm"]},
        pos_diffs=s["pos_diffs"], all_ef=s["all_ef"], delta_r=s["delta_r"],
        delta_coords=s["delta_coords"], coords=s["coords"], clabels=s["clabels"],
        mask_fne_np=s["mask_fne_np"], fully_connected=s["fully_connected"],
        num_knn=s["num_knn"], self_loops=s["self_loops"], sum_agg=s["sum_agg"])


def lattice_cfg(s, dropout_p):
    from mpgan_tpu_torch.ops import mp

    args, kw = lattice_cfg_args(s, dropout_p)
    return mp.MPLayerConfig.build(*args, **kw)


def lattice_inputs(s, dev) -> dict:
    """The JAX test's inputs (``RandomState(seed)``, x * 0.4, its mask, labels
    and particle counts), its ``train`` rule and its key ``PRNGKey(1000 + seed)``."""
    from mpgan_tpu_torch.ops import prng

    nprng = np.random.RandomState(s["seed"])
    b, n = s["b"], s["n"]
    x = nprng.randn(b, n, s["f"]).astype(np.float32) * 0.4
    mask = None
    if s["masked"]:
        counts = nprng.randint(1, n + 1, size=b)
        mask = (np.arange(n)[None, :] < counts[:, None]).astype(np.float32)[..., None]
    labels = nprng.rand(b, 3).astype(np.float32)
    njp = nprng.randint(1, n + 1, size=b).astype(np.float32) / n
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(x=t(x), mask=t(mask), labels=t(labels), njp=t(njp),
                train=s["dropout_p"] > 0 or s["batch_norm"],
                key=prng.PRNGKey(1000 + s["seed"], dev))


@contextlib.contextmanager
def lattice_env(kernel, select, sms=None):
    """The knn route the layer reads at call time and, with ``sms``, the dense
    kernels planned for that many SMs."""
    from mpgan_tpu_torch.ops import mp_kernels as mk

    set_knn_route(kernel, select)
    count = mk._sm_count
    if sms is not None:
        mk._sm_count = lambda device: sms
    try:
        yield
    finally:
        mk._sm_count = count
        set_knn_route()


@contextlib.contextmanager
def plain_versions():
    """The kernel path through the kernels' plain versions on the card: every
    wrapper takes its CUDA tensors for CPU ones (the same seeds, so the same
    masks)."""
    from mpgan_tpu_torch.ops import knn_kernels as kk
    from mpgan_tpu_torch.ops import mp_kernels as mk

    saved = mk._on_cpu, kk._on_cpu
    mk._on_cpu = kk._on_cpu = lambda *tensors: True
    try:
        yield
    finally:
        mk._on_cpu, kk._on_cpu = saved


def lattice_launched() -> dict:
    """The launches counted since the counts were last set to 0: the kernels'
    and the PRNG's (``threefry_draws``)."""
    from mpgan_tpu_torch.ops import mp_kernels as mk

    return {k: v for counts in mk._COUNTS for k, v in counts.items() if v}


def lattice_layer(cfg, s, dev):
    """The point's layer drawn on ``dev`` from ``PRNGKey(seed)``, and the
    launches its init made."""
    from mpgan_tpu_torch.ops import mp, prng
    from mpgan_tpu_torch.ops import mp_kernels as mk

    mk.reset_launch_counts()
    layer = mp.MPLayer(cfg, prng.PRNGKey(s["seed"], dev))
    return layer, lattice_launched()


def lattice_init_expected(cfg) -> dict:
    """``threefry_draws`` launches of the layer's init: a weight and a bias
    a linear layer, and a spectral-norm layer's ``u``."""
    draws = sum(2 * m.num_layers + sum(m.layer_has_sn(i) for i in range(m.num_layers))
                for m in (cfg.fe, cfg.fn))
    return {"threefry_draws": draws}


@contextlib.contextmanager
def lattice_recording(layer, record):
    """Into ``record`` (unless None), what a run of ``layer`` computes at
    LeakyReLU's kinks: the pre-activations of its fe and fn MLP calls
    (``"fe"``, ``"fn"``: the plain path's edge chain and every node MLP) and
    the inputs of its dense edge-aggregate call (``"dense"``, as
    :class:`KinkRows` records them: the kernel or its plain version)."""
    if record is None:
        yield
        return
    from mpgan_tpu_torch.ops import linear, mp

    forward, dense = linear.MLP.forward, mp.EdgeAggregate
    keep = lambda t: t.detach().float().clone()  # noqa: E731

    def mlp_forward(mlp, x, train=False, rng=None, update_sn=True):
        name = "fe" if mlp is layer.fe else "fn" if mlp is layer.fn else None
        if name is None:
            return forward(mlp, x, train, rng, update_sn)
        with FloatWheres(keep) as wheres:
            out = forward(mlp, x, train, rng, update_sn)
        record[name] = wheres.seen
        return out

    class Dense:
        @staticmethod
        def apply(u1, u2, m, alpha, sum_agg, p, seed, *hidden):
            record["dense"] = dict(kind="dense", u1=keep(u1), u2=keep(u2), m=keep(m),
                                   hidden=[keep(t) for t in hidden], alpha=alpha, p=p,
                                   seed=seed)
            return dense.apply(u1, u2, m, alpha, sum_agg, p, seed, *hidden)

    linear.MLP.forward, mp.EdgeAggregate = mlp_forward, Dense
    try:
        yield
    finally:
        linear.MLP.forward, mp.EdgeAggregate = forward, dense


def lattice_kink_rows(ra, rb):
    """The receiver rows ``[B, N]`` at LeakyReLU's kink between two runs'
    records (:func:`lattice_recording`), as :class:`KinkRows` finds them: a
    node MLP pre-activation the two runs give opposite signs; an edge-chain
    pre-activation the two give opposite signs (a dense call's chain
    recomputed by the kernels' plain versions on its inputs), or that lies
    within KINK_ULPS ulps of its terms' magnitude sum on a recomputed chain,
    where a gradient reaches it. None where the records hold no such rows."""
    rows = None
    for za, zb in zip(ra.get("fn", []), rb.get("fn", [])):
        if za.shape == zb.shape and za.dim() == 3:
            flip = ((za >= 0) != (zb >= 0)).any(-1)
            rows = flip if rows is None else rows | flip
    chains = [KinkRows._chain(r["dense"], None) if "dense" in r else
              (r["fe"], None, None) if "fe" in r else None for r in (ra, rb)]
    if None in chains:
        return rows
    lives = chains[0][2] or chains[1][2]
    for layer_i, (za, zb) in enumerate(zip(chains[0][0], chains[1][0])):
        if za.shape != zb.shape or za.dim() != 4:
            continue
        at = (za >= 0) != (zb >= 0)
        for zs, scales, _ in chains:
            if scales is not None:
                at |= zs[layer_i].abs() <= KINK_ULPS * 2.0**-24 * scales[layer_i]
        if lives is not None:
            at &= lives[layer_i]
        at = at.flatten(2).any(-1)
        rows = at if rows is None else rows | at
    return rows


def lattice_held(layer, d, runs, res, what):
    """Two runs of ``layer`` on ``d`` (``runs``: the kwargs of each
    :func:`lattice_run`, the second the reference), held by
    :func:`lattice_over`: where they miss, held again with the receiver rows
    at LeakyReLU's kink (:func:`lattice_kink_rows`) left out of the loss on
    both sides, their count logged. The first run's result, and each run's
    launches."""
    recs = [{}, {}]
    (out, launched), (ref, ref_launched) = [lattice_run(layer, d, record=rec, **kw)
                                            for rec, kw in zip(recs, runs)]
    res["over"][what], res["at"][what] = lattice_over(out, ref)
    if res["over"][what] > 1.0:
        rows = lattice_kink_rows(*recs)
        if rows is not None and rows.any():
            res.setdefault("kinks", {})[what] = {"over": res["over"][what],
                                                 "rows_left_out": int(rows.sum()),
                                                 "rows": rows.numel()}
            a, b = [lattice_run(layer, d, left_out=rows, **kw)[0] for kw in runs]
            res["over"][what], res["at"][what] = lattice_over(a, b)
    return out, launched, ref_launched


def lattice_run(layer, d, kernels, dtype=torch.float32, left_out=None, record=None,
                versions=False, parts=None):
    """One forward and backward of the loss ``sum(sin(y))`` (without the rows
    ``left_out``) on its own copy of ``layer`` (spectral norm advances ``u``
    in place): the output, the gradients of every parameter in JAX leaf order
    and of ``x``, and the launches (the kernels' and the dropout keys'
    draws); with ``record``, what :func:`lattice_recording` records; with
    ``parts``, what :func:`lattice_x_calls` records; with ``versions``,
    through the kernels' plain versions (:func:`plain_versions`)."""
    from mpgan_tpu_torch.ops import mp
    from mpgan_tpu_torch.ops import mp_kernels as mk
    from mpgan_tpu_torch.ops.keys import Keys
    from mpgan_tpu_torch.utils.weights import _mlp_leaves

    layer = copy.deepcopy(layer).to(dtype)
    x = d["x"].to(dtype, copy=True).requires_grad_()
    mask = None if d["mask"] is None else d["mask"].to(dtype)
    mk.reset_launch_counts()
    with plain_versions() if versions else contextlib.nullcontext():
        with lattice_recording(layer, record), lattice_x_calls(parts):
            y = mp.mp_layer_apply(layer, x, mask=mask, labels=d["labels"],
                                  num_jet_particles=d["njp"], train=d["train"],
                                  rng=Keys(d["key"]), use_kernels=kernels)
            loss = torch.sin(y.float())
            if left_out is not None:
                loss = loss * (~left_out)[..., None]
            loss.sum().backward()
    if x.is_cuda:
        torch.cuda.synchronize()
    launches = lattice_launched()
    leaves = _mlp_leaves(layer.fe, True) + _mlp_leaves(layer.fn, True)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
    return [y.detach()] + grads + [x.grad], launches


def lattice_over(outs, refs, bf16=False, whole=False) -> tuple[float, int]:
    """The largest error over its bound and the tensor it is in (0 the output,
    then the parameters' gradients in JAX leaf order, ``x``'s last). FP32: the
    output and ``x``'s gradient elementwise (1e-4 + 1e-4 * |ref|), each weight
    gradient against 1e-4 * max(1, max|ref|). bf16, phase 28's rules: the
    output elementwise at 1e-2, each gradient against 1e-2 * max(1,
    max|ref|); ``whole`` (knn points, K6's rule, phase 29): every gradient as
    a whole, relative L2 over 3e-2 and the largest error over max(1,
    max|ref|) over 0.1."""
    tol = BF16_TOL if bf16 else TOL
    worst, at = 0.0, 0
    for i, (o, r) in enumerate(zip(outs, refs)):
        o, r = o.float(), r.float()
        if not o.numel():
            continue
        err = (o - r).abs()
        if i and whole:
            rel, share, _ = bf16_whole(o, r)
            over = max(rel / BF16_REL_L2, share / BF16_MAX_SHARE)
        elif i and (bf16 or i < len(outs) - 1):
            over = err.max().item() / (tol * max(1.0, r.abs().max().item()))
        else:
            over = (err / (tol + tol * r.abs())).max().item()
        if over > worst:
            worst, at = over, i
    return worst, at


@contextlib.contextmanager
def lattice_x_calls(record):
    """Into ``record`` (unless None), what a dense run hands to ``x``'s
    gradient through its kernel calls: fe layer 1's weight as the layer used
    it (``w1``, and the node width ``f``), and the inputs and outputs of every
    K2 call (``"k2"``: the forward's on the K2 route, the backward's recompute
    on the K4 route) and every K3 call (``"k3"``), the kernels' or, on the
    plain path or under :func:`plain_versions`, their plain versions'."""
    if record is None:
        yield
        return
    from mpgan_tpu_torch.ops import mp
    from mpgan_tpu_torch.ops import mp_kernels as mk

    decompose, k2, k3 = mp._decompose_first_layer, mk.edge_aggregate, mk.edge_aggregate_bwd
    keep = lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t  # noqa: E731
    record.update(k2=[], k3=[])

    def call(u1, u2, m, hidden, alpha, sum_agg, p, seed, **kw):
        return dict(u1=keep(u1), u2=keep(u2), m=keep(m), hidden=[keep(t) for t in hidden],
                    alpha=alpha, sum_agg=sum_agg, p=p, seed=keep(seed),
                    **{k: keep(v) for k, v in kw.items()})

    def decomposed(cfg, weights, *a, **kw):
        record["w1"], record["f"] = keep(weights[0][0]), cfg.input_node_size
        return decompose(cfg, weights, *a, **kw)

    def forward(u1, u2, m, hidden, alpha, sum_agg, p=0.0, seed=0):
        out = k2(u1, u2, m, hidden, alpha, sum_agg, p, seed)
        record["k2"].append(call(u1, u2, m, hidden, alpha, sum_agg, p, seed, out=out))
        return out

    def backward(u1, u2, m, hidden, g, alpha, sum_agg, p=0.0, seed=0, need_wgrads=True):
        out = k3(u1, u2, m, hidden, g, alpha, sum_agg, p, seed, need_wgrads)
        record["k3"].append(call(u1, u2, m, hidden, alpha, sum_agg, p, seed, g=g,
                                 du1=out[0], du2=out[1]))
        return out

    mp._decompose_first_layer, mk.edge_aggregate, mk.edge_aggregate_bwd = \
        decomposed, forward, backward
    try:
        yield
    finally:
        mp._decompose_first_layer, mk.edge_aggregate, mk.edge_aggregate_bwd = \
            decompose, k2, k3


# jittered float64 models an envelope, fixed (with jittered's draw) before the rule first
# ran on the card
LATTICE_X_SAMPLES = 8
U32 = 2.0**-24  # float32's unit roundoff


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, held in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at ``|t|`` (2^-133, bf16's least subnormal,
    at zero)."""
    _, e = torch.frexp(t)
    return torch.where(t == 0, torch.full_like(t, 2.0**-133),
                       torch.ldexp(torch.ones_like(t), (e - 8).clamp_min(-133)))


def jittered(z, jitter, terms: int, scale):
    """``z``, standing for a float32 sum of ``terms`` terms whose magnitudes
    sum to ``scale()``, moved with the generator ``jitter`` by a draw uniform
    within sqrt(terms) u scale. Its standard deviation, sqrt(terms / 3) u
    scale, bounds that of such a sum whose additions each round by an
    independent error uniform within u of the partial sum (Monte Carlo
    arithmetic: one float32 implementation among those that sum in another
    order). ``z`` itself without ``jitter``."""
    if jitter is None:
        return z
    noise = torch.rand(z.shape, generator=jitter, dtype=z.dtype, device=z.device) * 2 - 1
    return z + noise * (terms**0.5 * U32) * scale().detach()


class Product64(torch.autograd.Function):
    """``a @ w + b`` in float64 for a float32 product: the forward's sums and
    the backward's ``dz w^T`` each moved as :func:`jittered` moves a float32
    sum. ``w`` and ``b`` take no gradient."""

    @staticmethod
    def forward(ctx, a, w, b, jitter):
        ctx.save_for_backward(w)
        ctx.jitter = jitter
        return jittered(a @ w + b, jitter, w.shape[0] + 1, lambda: a.abs() @ w.abs() + b.abs())

    @staticmethod
    def backward(ctx, dz):
        (w,) = ctx.saved_tensors
        return (jittered(dz @ w.t(), ctx.jitter, w.shape[1], lambda: dz.abs() @ w.abs().t()),
                None, None, None)


def edge_model64(c, jitter=None):
    """A float64 model of one K2 or K3 call (``c``, as :func:`lattice_x_calls`
    records it) in the mode its inputs select, rounding what that mode
    rounds and nothing else. bf16 inputs: each product operand of the edge
    chain rounded to bf16 (``mp_pallas._split_mlp_chain``), every sum after
    that in float64 (the aggregate and, by autograd, the backward: ``da`` on
    the bf16 weights' values, landing on the unrounded activations), the
    aggregate, or du1 and du2, rounded to bf16 once. float32 or float64
    inputs: the FP32 mode in float64, nothing rounded. Autograd over its own
    forward, apart from the plain versions' recompute; only K1's dropout
    multipliers come from its plain version. With ``jitter``, every sum moved
    as :func:`jittered` moves it. Returns a K2 call's aggregate, or a K3
    call's (du1, du2) (``c`` holds ``g``), in float64."""
    from mpgan_tpu_torch.ops import mp_kernels as mk

    f64 = torch.float64
    rnd = bf16_round if c["u1"].dtype == torch.bfloat16 else (lambda t: t)
    u1, u2 = (c[k].to(f64).requires_grad_() for k in ("u1", "u2"))
    b, n = u1.shape[:2]
    ids = mk.pair_ids(b, n, u1.device) if c["p"] > 0 else None

    def act(z, salt):
        a = torch.where(z >= 0, z, c["alpha"] * z)
        return a if ids is None else a * mk._dropmul(ids, z.shape[-1], c["p"], c["seed"], salt)

    z0 = jittered(u1[:, :, None, :] + u2[:, None, :, :], jitter, 2,
                  lambda: u1.abs()[:, :, None, :] + u2.abs()[:, None, :, :])
    a = act(z0, 0)
    hidden = [t.to(f64) for t in c["hidden"]]
    for salt in range(1, len(hidden) // 2 + 1):
        op = a + (rnd(a) - a).detach()  # the product takes the bf16 operand, da lands on a
        a = act(Product64.apply(op, hidden[2 * salt - 2], hidden[2 * salt - 1], jitter), salt)
    terms = a * c["m"].to(f64)[:, None, :, :]
    agg = jittered(terms.sum(2), jitter, n, lambda: terms.abs().sum(2))
    agg = agg if c["sum_agg"] else agg / n
    if "g" not in c:
        return rnd(agg.detach())
    du1, du2, dz0 = torch.autograd.grad(agg, [u1, u2, z0], c["g"].to(f64))
    return (rnd(jittered(du1, jitter, n, lambda: dz0.abs().sum(2))),
            rnd(jittered(du2, jitter, n, lambda: dz0.abs().sum(1))))


def lattice_x_call_over(c, w1, f, samples=LATTICE_X_SAMPLES) -> dict:
    """One K2 or K3 call of a dense bf16 run against its float64 model
    (:func:`edge_model64` on the call's own inputs), elementwise, in
    envelopes: each output within one bf16 ulp of the model's plus the
    farthest that ``samples`` jittered models lie from it (``"agg"`` for K2;
    ``"du1"``, ``"du2"`` for K3); and K3's du1 and du2 carried to ``x``
    through fe layer 1's decomposed product in float64
    (``_decompose_first_layer``: ``du1 W1[:, :f] + du2 W1[:, f:2f]``,
    ``"x"``), within one bf16 ulp of each of the model's carried through
    ``|W1|`` (the issue's bound) plus the jittered models' spread there."""
    f64 = torch.float64
    wa, wb = w1.to(f64)[:, :f], w1.to(f64)[:, f:2 * f]
    bwd = "g" in c

    def parts(out):
        if not bwd:
            return {"agg": out.to(f64)}
        du1, du2 = out[0].to(f64), out[1].to(f64)
        return {"du1": du1, "du2": du2, "x": du1 @ wa + du2 @ wb}

    at = parts(edge_model64(c))
    env = {k: bf16_ulp(v) for k, v in at.items() if k != "x"}
    if bwd:
        env["x"] = env["du1"] @ wa.abs() + env["du2"] @ wb.abs()
    spread = {k: torch.zeros_like(v) for k, v in at.items()}
    for i in range(samples):
        jitter = torch.Generator(device=wa.device).manual_seed(i)
        for k, v in parts(edge_model64(c, jitter)).items():
            spread[k] = torch.maximum(spread[k], (v - at[k]).abs())
    side = parts((c["du1"], c["du2"]) if bwd else c["out"])
    return {k: (side[k] - at[k]).abs() / (env[k] + spread[k]) for k in at}


def lattice_x_envelope(out, ref, kernel, plain, samples=LATTICE_X_SAMPLES) -> dict:
    """A dense point's bf16 ``x`` gradient: the kernels' against the bf16
    plain versions' elementwise at 1e-2 * max(1, max|ref|), as every other
    bf16 gradient. Where an element misses, the point holds only if each run
    (``kernel``, ``plain``: its :func:`lattice_x_calls` record) hands ``x``
    what its kernels must: every K3 call, carried to ``x``, within its
    envelope of the float64 model on its own inputs
    (:func:`lattice_x_call_over`'s ``"x"``), and every K2 call of the kernels'
    run within 1e-2 of its tensor's largest of the plain versions' on the
    same inputs (phase 28's bf16 output rule without its floor of 1, which
    holds nothing where an aggregate is small). Those calls are held at
    every element, missed or not: a call outside them is a fault where
    ``x``'s gradient hides it too. Logged: each call's elementwise readings
    against the model (K3's du1, du2, K2's aggregate: the model resolves
    them only to the mode's own flips, ROADMAP Queue 3 item 6), the K2 calls'
    largest difference in bf16 steps, and what the runs' K3 calls do not
    hand on (``rest_over``: fn's gradient of ``x`` and of the aggregate,
    which take other slopes where the runs' bf16 aggregates differ), over
    the 1e-2 bound."""
    o, r = out.double(), ref.double()
    bound = BF16_TOL * max(1.0, r.abs().max().item())
    miss = (o - r).abs() > bound
    res = {"over": (o - r).abs().max().item() / bound, "elements_over": int(miss.sum()),
           "rows_over": int(miss.any(-1).sum()), "rows": miss[..., 0].numel(),
           "samples": samples}
    held, handed = True, {}
    for side, rec in (("kernel", kernel), ("plain", plain)):
        wa, wb = rec["w1"].double()[:, :rec["f"]], rec["w1"].double()[:, rec["f"]:2 * rec["f"]]
        for kind in ("k2", "k3"):
            overs = [lattice_x_call_over(c, rec["w1"], rec["f"], samples) for c in rec[kind]]
            res[f"{side}_{kind}_calls"] = len(overs)
            for what in ("agg",) if kind == "k2" else ("du1", "du2", "x"):
                res[f"{side}_{kind}_{what}_over_envelope"] = max(
                    (v[what].max().item() for v in overs), default=0.0)
        held &= res[f"{side}_k3_x_over_envelope"] <= 1.0
        res[f"{side}_k3_x_over_envelope_at_misses"] = max(
            (v["x"][miss].max().item() for v in overs if miss.any()), default=0.0)
        handed[side] = sum(c["du1"].double() @ wa + c["du2"].double() @ wb for c in rec["k3"])
    res["k2_over"] = res["k2_steps_max"] = 0.0
    for ck, cp in zip(kernel["k2"], plain["k2"], strict=True):
        if not all(torch.equal(ck[k], cp[k]) for k in ("u1", "u2", "m")):
            raise SystemExit("phase 33: the two runs' K2 calls took different inputs")
        a, b = ck["out"].double(), cp["out"].double()
        res["k2_over"] = max(res["k2_over"], (a - b).abs().max().item()
                             / (BF16_TOL * b.abs().max().item()))
        res["k2_steps_max"] = max(res["k2_steps_max"], ((a - b).abs() / bf16_ulp(
            torch.maximum(a.abs(), b.abs()))).max().item())
    held &= res["k2_over"] <= 1.0
    res["rest_over"] = ((o - r) - (handed["kernel"] - handed["plain"])).abs().max().item() / bound
    res["ok"] = held  # held at every element, so at the misses too
    return res


def lattice_expected(cfg, d, route, bf16) -> dict:
    """The launches the point's kernel path must make, forward and backward: one
    of each kernel its gate names, and a ``threefry_draws`` launch for each
    dropout key it draws (in train mode with dropout: the kernels' seed and a
    key for each fn layer; on the plain path a key for each fe and fn layer)."""
    from mpgan_tpu_torch.ops import mp

    fused = mp.fused_eligible(cfg, d["train"])
    names = set()
    if fused and cfg.fully_connected:
        k4 = (not d["train"] and d["x"].shape[1] <= 64 and not cfg.fn.batch_norm
              and not cfg.fn.spectral_norm and cfg.clabels == 0 and not cfg.mask_fne_np)
        k2 = "edge_aggregate_train" if d["train"] and cfg.fe.dropout_p > 0 else "edge_aggregate"
        names = {"edge_aggregate_fn", "edge_aggregate", "edge_aggregate_bwd"} if k4 else \
            {k2, "edge_aggregate_bwd"}
    elif fused:
        kernel, select = route
        if select == "0":
            names = {"knn_edge_aggregate"}
        elif kernel == "4":
            names = {"knn_fused_layer_train"}
        else:
            names = {"knn_search", "knn_edge_aggregate"}
        names.add("knn_edge_aggregate_bwd")
    want = {n + "_bf16" if bf16 else n: 1 for n in names}
    if d["train"] and cfg.fe.dropout_p > 0:
        want["threefry_draws"] = (1 if fused else cfg.fe.num_layers) + cfg.fn.num_layers
    return want


def lattice_point(s, dev) -> dict:
    """Phase 33 at one point: what it ran, the largest error over its bound of
    each comparison, the launches, and the faults found (empty where none)."""
    from mpgan_tpu_torch.ops import mp

    dense = s["fully_connected"]
    routes = [(s["kernel"], s["select"])] if dense or s["b"] == 2 else \
        list(LATTICE_ROUTES.values())
    d = lattice_inputs(s, dev)
    res = {"case": s["case"], "flags": lattice_flags(s), "over": {}, "at": {}, "launches": {},
           "faults": []}

    def fault(what):
        res["faults"].append(what)

    def check_launches(what, got, want):
        res["launches"][what] = got
        if got != want:
            fault(f"{what}: launched {got}, expected {want}")

    cfg0 = lattice_cfg(s, 0.0)
    layer0, launched = lattice_layer(cfg0, s, dev)
    check_launches("init", launched, lattice_init_expected(cfg0))

    with lattice_env(*routes[0]):
        msgs = []
        for kernels in (False, True):
            try:
                lattice_run(layer0, d, kernels)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
    if msgs[0] is not None or msgs[1] is not None:
        res["path"] = "invalid"
        if msgs[0] != msgs[1]:
            fault(f"the paths raise otherwise: {msgs}")
        return res
    res["path"] = "kernel" if mp.fused_eligible(cfg0, d["train"]) else "plain"

    # FP32, dropout off: the kernel path on the card against the plain path; a rerun
    for kernel, select in routes:
        tag = "" if len(routes) == 1 else f"_route{kernel}"
        with lattice_env(kernel, select):
            out, launched, _ = lattice_held(layer0, d, [{"kernels": True}, {"kernels": False}],
                                            res, "fp32" + tag)
            again, _ = lattice_run(layer0, d, True)
        res.setdefault("rerun_bit_identical", True)
        res["rerun_bit_identical"] &= all(torch.equal(a, b) for a, b in zip(out, again))
        check_launches("fp32" + tag, launched, lattice_expected(cfg0, d, (kernel, select),
                                                                 False))

    cfg = lattice_cfg(s, s["dropout_p"])
    layer = layer0
    if s["dropout_p"] > 0:
        # dropout on: the kernels on the card against their plain versions on the
        # card (the same seeds); a rerun; a second dense plan; the other knn route
        layer, launched = lattice_layer(cfg, s, dev)
        check_launches("init_dropout", launched, lattice_init_expected(cfg))
        for kernel, select in routes:
            tag = "" if len(routes) == 1 else f"_route{kernel}"
            with lattice_env(kernel, select):
                out, launched, none = lattice_held(layer, d, [{"kernels": True}, {
                    "kernels": True, "versions": True}], res, "dropout" + tag)
                again, _ = lattice_run(layer, d, True)
            res["rerun_bit_identical"] &= all(torch.equal(a, b) for a, b in zip(out, again))
            check_launches("dropout" + tag, launched,
                           lattice_expected(cfg, d, (kernel, select), False))
            none = {k: v for k, v in none.items() if k != "threefry_draws"}
            if none:
                fault(f"the plain versions launched {sorted(none)}")
        if res["path"] == "kernel" and dense:
            with lattice_env(*routes[0], sms=LATTICE_PLAN_SMS):
                other, _ = lattice_run(layer, d, True)
            res["over"]["dropout_plan_7_sms"], res["at"]["dropout_plan_7_sms"] = \
                lattice_over(other, out)
        elif res["path"] == "kernel":
            outs = {}
            for kernel, select in LATTICE_ROUTES.values():
                with lattice_env(kernel, select):
                    outs[kernel] = lattice_run(layer, d, True)[0]
            res["over"]["dropout_route3_vs_4"], res["at"]["dropout_route3_vs_4"] = \
                lattice_over(outs["3"], outs["4"])

    if res["path"] == "kernel":
        # bf16 (dropout as sampled): the bf16 modes against their plain versions;
        # a dense point's x gradient at 1e-2, each run's K2 and K3 calls held
        # (lattice_x_envelope)
        for kernel, select in routes:
            tag = "" if len(routes) == 1 else f"_route{kernel}"
            parts = [{}, {}] if dense else [None, None]
            with lattice_env(kernel, select):
                out, launched = lattice_run(layer, d, True, torch.bfloat16, parts=parts[0])
                ref, _ = lattice_run(layer, d, True, torch.bfloat16, versions=True,
                                     parts=parts[1])
            held = slice(None, -1) if dense else slice(None)
            res["over"]["bf16" + tag], res["at"]["bf16" + tag] = lattice_over(
                out[held], ref[held], bf16=True, whole=not dense)
            if dense:
                res["bf16_x_grad"] = lattice_x_envelope(out[-1], ref[-1], *parts)
                if not res["bf16_x_grad"]["ok"]:
                    fault(f"bf16 x gradient: {res['bf16_x_grad']}")
            check_launches("bf16" + tag, launched, lattice_expected(cfg, d, (kernel, select),
                                                                    True))
    for what, over in res["over"].items():
        if not over <= 1.0:
            fault(f"{what}: error {over} times its bound")
    if not res.get("rerun_bit_identical", True):
        fault("a rerun of the kernel path differs")
    return res


def lattice_phase(card) -> dict:
    """Phase 33: the MP layer at the JAX package's 48 lattice points and 11 at
    the published widths (:func:`lattice_points`), kernel path against plain
    path (FP32, dropout off), kernels against their plain versions (dropout
    on, bf16), dropout under a second dense plan and across the knn routes,
    reruns bit for bit, and the launches each point's gate names. Every point
    runs; the faults are raised together at the end. Returns the launches of
    the phase by kernel, ``threefry_draws`` among them."""
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    faults, worst, launches, paths = [], {}, {}, {}
    points = lattice_points()
    for s in points:
        t0 = time.perf_counter()
        try:
            res = lattice_point(s, dev)
        except Exception as e:  # a kernel that refuses or fails at the point is a fault too
            res = {"case": s["case"], "flags": lattice_flags(s), "path": "error",
                   "faults": [f"{type(e).__name__}: {e}"]}
        res["seconds"] = round(time.perf_counter() - t0, 3)
        log("lattice", **res)
        faults += [f"point {res['case']}: {f}" for f in res["faults"]]
        paths[res["path"]] = paths.get(res["path"], 0) + 1
        for what, over in res.get("over", {}).items():
            key = what.split("_route")[0]
            worst[key] = max(worst.get(key, 0.0), over)
        for counts in res.get("launches", {}).values():
            for name, c in counts.items():
                launches[name] = launches.get(name, 0) + c
    seconds = time.perf_counter() - t_phase
    log("lattice_summary", card=card, points=len(points), paths=paths,
        worst_over_bound=worst, launches=launches, faults=len(faults), seconds=seconds)
    if faults:
        raise SystemExit("phase 33: " + "; ".join(faults))
    return launches


# ---------------------------------------------------------------------------
# phase 34: the 150-particle dense paths that bench.py times, end to end on the card
# ---------------------------------------------------------------------------
DENSE150 = {**FLAGSHIP, "num_hits": 150}  # bench.py's 150p dense card (flagship widths)
DENSE150_FE = {**DENSE150, "fe": [128, 256]}  # bench.py's headline generator
DENSE150_GEN_BATCH = 512  # bench.py's generation batch
DENSE150_STEP_BATCH = 128  # bench.py's train-step batch
DENSE150_GEN_JETS = 50000
DENSE150_CHECK_JETS = 8  # jets held to the CPU
# the D+G step held to the CPU: 4 jets of 150 particles give each edge-layer call 600
# receiver rows (phase 8's 16 flagship jets give 480), at a quarter of B=16's CPU time (a
# step of the kernels' plain versions takes about 40 s on 8 CPU cores at B=16)
DENSE150_CPU_BATCH = 4
BF16_GEN_LOGGED = 5e-2  # the bf16 generator against the float32 one: share beyond, logged
# D's learning rate in the 150p epochs and train CLI run (the card's is 3e-5): RMSprop's
# first update moves every element by about 10 lr, and D's logits, sums over 150 senders
# twice, saturate sigmoid again after it, scaled or not; G's gradients are then exactly 0
# in bf16 and about 1e-10 in float32 for the rest of the epoch (measured on an H100), so
# that its side of a comparison of two epochs would hold vacuously. At 1e-9 D stays near
# its unsaturated start and both models' parameters move.
DENSE150_LR_DISC = 1e-9
PLAIN_MEMORY_SHARE = 0.8  # of the card's free memory a timed plain-path step may need


def dense_steps_expected(n: int, steps: int, eval_batches: int = 0, bf16: bool = False) -> dict:
    """The dense kernels ``steps`` D+G steps of the MPGAN card at ``n``
    particles launch, and ``eval_batches`` batches of the evaluation's G: per
    step the D step's G (eval) K4 in its 2 layers (N <= 64), else K2; D on
    real and fake K2 with dropout and K3 with weight gradients, 2 layers each;
    the G step's G K2 without dropout (gen_dropout 0) and K3 with weight
    gradients, its D K2 with dropout and K3 without them; an evaluation batch
    2 K4 or 2 K2."""
    tag = "_bf16" if bf16 else ""
    k4 = n <= 64
    counts = {"edge_aggregate" + tag: (2 if k4 else 4) * steps + (0 if k4 else 2 * eval_batches),
              "edge_aggregate_train" + tag: 6 * steps, "edge_aggregate_bwd" + tag: 6 * steps,
              "edge_aggregate_bwd_no_wgrads" + tag: 2 * steps}
    if k4:
        counts["edge_aggregate_fn" + tag] = 2 * steps + 2 * eval_batches
    return counts


def dense150_generator(mk, gen_cli, dev, card, from_args_dict, tmp) -> dict:
    """Phase 34 (1): bench.py's headline generator, the 150-particle ``--fe 128
    256`` card: 50,000 jets through ``cli.gen`` and 2,048 through
    ``generate_multi_batch`` at B=512 (K2 2 a batch, no K4), shape, finiteness
    and mask counts; 8 jets on the card against the same path on the CPU (the
    kernels' plain versions, the same keys) at 1e-4; the sampler's batch
    against the card's plain path at 1e-4, the mask column equal; the captured
    sampler bit for bit the eager one; K2 at the batch against its plain
    version (rerun bit for bit); jets/s of the kernel and plain paths in
    turns, launches a batch and peak memory."""
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.sampling import drop_samplers, generate_multi_batch
    from mpgan_tpu_torch.utils.weights import mp_generator_to_reference_sd

    b, n, fe = DENSE150_GEN_BATCH, 150, DENSE150_FE["fe"]
    args = from_args_dict(DENSE150_FE)
    suite = build_suite(args)
    g_cpu = suite.generator(prng_key(34, "cpu"))
    g = suite.generator(prng_key(34, "cpu"), device=dev)
    if any(tuple(layer.fe.sizes[1:]) != tuple(fe) for layer in g.cfg.layers):
        raise SystemExit(f"phase 34: the --fe 128 256 card built fe {g.cfg.layers[0].fe.sizes}")
    (tmp / "card150.txt").write_text(repr(args.to_dict()))
    torch.save(mp_generator_to_reference_sd(g_cpu), tmp / "G150.pt")
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    gen_cli.main(["--g-args", str(tmp / "card150.txt"), "--g-state", str(tmp / "G150.pt"),
                  "--output-file", str(tmp / "gen150.npy"), "--device", "cuda", "--seed", "0",
                  "--num-samples", str(DENSE150_GEN_JETS), "--batch-size", str(b)])
    cli_wall = time.perf_counter() - t0
    cli_launches = dict(mk.launch_counts)
    jets = np.load(tmp / "gen150.npy")
    ds = JetNetDataset("g", num_particles=n, split="valid")
    lab = ds.jet_data[np.random.default_rng(0).choice(len(ds), size=DENSE150_GEN_JETS)]
    counts = (lab[:, -1].astype(np.float32) * n).astype(np.int32)
    batches = -(-DENSE150_GEN_JETS // b)
    if jets.shape != (DENSE150_GEN_JETS, n, 3) or not np.isfinite(jets).all():
        raise SystemExit(f"phase 34: gen output {jets.shape} is not finite "
                         f"({DENSE150_GEN_JETS}, {n}, 3)")
    if not np.array_equal(np.any(jets != 0, axis=-1).sum(axis=1), counts) \
            or (jets[:, :, 2] < 0).any():
        raise SystemExit("phase 34: gen output: masked particles not zero or negative pT")

    # the sampler at B=512: captured, then eager, bit for bit
    sampled = 4 * b
    runs = {}
    for static in (True, False):
        drop_samplers(g)
        mk.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate_multi_batch(g, suite.noise, prng_key(1, dev), sampled, b,
                                   labels=lab[:sampled], static=static)
        runs[static] = (out, time.perf_counter() - t0, dict(mk.launch_counts))
    (out, wall, launches), (eager, _, eager_launches) = runs[True], runs[False]
    if out.shape != (sampled, n, 4) or not np.isfinite(out).all():
        raise SystemExit(f"phase 34: 150p fe [128, 256] output {out.shape} is not finite")
    if not np.array_equal((out[..., -1] + 0.5).sum(1), counts[:sampled]):
        raise SystemExit("phase 34: 150p fe [128, 256] mask counts disagree with the labels")
    for what, got, want in (("gen", cli_launches, 2 * batches),
                            ("sampler", launches, 2 * (sampled // b)),
                            ("eager sampler", eager_launches, 2 * (sampled // b))):
        if {k: v for k, v in got.items() if v} != {"edge_aggregate": want}:
            raise SystemExit(f"phase 34: the {what} launched {got}, K2 {want} times expected "
                             "and nothing else")
    captured_equal = np.array_equal(out, eager)
    if not captured_equal:
        raise SystemExit("phase 34: the captured 150p sampler differs from the eager one")

    # 8 jets on the card against the CPU (the kernels' plain versions, the same keys)
    few = DENSE150_CHECK_JETS
    g_cpu.cfg = dataclasses.replace(g_cpu.cfg, use_kernels=True)
    y8 = torch.as_tensor(generate_multi_batch(g, suite.noise, prng_key(5, dev), few, few,
                                              labels=lab[:few]))
    y8_cpu = torch.as_tensor(generate_multi_batch(g_cpu, suite.noise, prng_key(5, "cpu"), few,
                                                  few, labels=lab[:few]))
    cpu_err, cpu_rel, cpu_bad = errors(y8, y8_cpu)
    # the sampler's batch against the card's plain path
    noise = torch.randn(b, n, 32, generator=torch.Generator(device=dev).manual_seed(34),
                        device=dev) * 0.2
    labels = torch.as_tensor(lab[:b], device=dev)
    kernel_cfg, plain_cfg = g.cfg, dataclasses.replace(g.cfg, use_kernels=False)

    def run(cfg):
        def f():
            g.cfg = cfg
            with torch.inference_mode():
                return g(noise, labels, update_sn=False)
        return f

    y_k = run(kernel_cfg)()
    y_p = run(plain_cfg)()
    p_err, p_rel, p_bad = errors(y_k, y_p)
    mask_equal = torch.equal(y_k[..., -1], y_p[..., -1])
    del y_k, y_p
    log("dense150_generator_check", card=card, fe=fe, jets_vs_cpu=few,
        max_abs_err_vs_cpu=cpu_err, max_rel_err_vs_cpu=cpu_rel, out_of_tol_vs_cpu=cpu_bad,
        mask_column_equal_vs_cpu=torch.equal(y8[..., -1], y8_cpu[..., -1]),
        jets_vs_plain_path=b, max_abs_err_vs_plain_path=p_err, max_rel_err_vs_plain_path=p_rel,
        out_of_tol_vs_plain_path=p_bad, mask_column_equal_vs_plain_path=mask_equal,
        captured_sampler_bit_identical=captured_equal, tol=TOL)
    if cpu_bad or not torch.equal(y8[..., -1], y8_cpu[..., -1]):
        raise SystemExit("phase 34: the 150p fe [128, 256] generator on the card disagrees "
                         "with the CPU")
    if p_bad or not mask_equal:
        raise SystemExit("phase 34: the 150p fe [128, 256] generator's kernel path disagrees "
                         "with its plain path")

    # K2 alone at the batch's shape, then the generator's rates in turns
    identical, max_err = {"edge_aggregate": True}, {"edge_aggregate": 0.0}
    u1, u2, mask, hidden, _, _ = kernel_inputs(dev, b, n, 3, seed=34, fe=fe)
    k2_ms, k2_plain_ms = main_shape(
        identical, max_err, "edge_aggregate", b, n,
        lambda: mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True),
        lambda: mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, True), inner=1)
    del u1, u2, mask, hidden
    ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            ms[which] = min(ms[which], best_ms(run(kernel_cfg if which == "kernel"
                                                   else plain_cfg)))
    peak_mb = {}
    for which, cfg in (("kernel", kernel_cfg), ("plain", plain_cfg)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run(cfg)()
        torch.cuda.synchronize()
        peak_mb[which] = (torch.cuda.max_memory_allocated() - base) / 2**20
    mk.reset_launch_counts()
    run(kernel_cfg)()
    per_batch = {k: v for k, v in mk.launch_counts.items() if v}
    g.cfg = kernel_cfg
    k2 = {"shape": f"B={b} N={n} fe {fe} eval", "ms": k2_ms, "plain_ms": k2_plain_ms,
          **dense_fwd_bound(b, n, fe=fe), "max_abs_err": max_err["edge_aggregate"],
          "two_runs_bit_identical": identical["edge_aggregate"]}
    log("dense150_generation", card=card, fe=fe, gen_jets=DENSE150_GEN_JETS, gen_wall_s=cli_wall,
        gen_launches={k: v for k, v in cli_launches.items() if v}, sampler_jets=sampled,
        sampler_wall_s=wall, batch=b, kernel_ms=ms["kernel"], plain_ms=ms["plain"],
        kernel_jets_per_s=b / ms["kernel"] * 1e3, plain_jets_per_s=b / ms["plain"] * 1e3,
        launches_per_batch=per_batch, peak_mb=peak_mb, k2=k2)
    drop_samplers(g)
    del g, g_cpu
    torch.cuda.empty_cache()
    return {"launches": {k: cli_launches.get(k, 0) + launches.get(k, 0) + eager_launches.get(k, 0)
                         for k in set(cli_launches) | set(launches)},
            "k2": k2, "jets_per_s": b / ms["kernel"] * 1e3,
            "identical": identical["edge_aggregate"]}


def dense150_plain_step(dev, from_args_dict, card, st_kernel=None) -> dict:
    """The plain path's D+G step at the largest batch up to B=128 whose peak
    memory, scaled from a B=16 step's, fits PLAIN_MEMORY_SHARE of the card's
    free memory (it materialises [B, N, N, H] pair tensors), timed beside the
    kernel path's step at that batch in turns."""
    free = torch.cuda.mem_get_info()[0]
    args = from_args_dict(DENSE150)
    data, labels = (t.to(dev) for t in real_batch(16, 150))
    st = make_state(args, dev)
    use_kernels(st, False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_fn(st, args, data, labels)()
    torch.cuda.synchronize()
    per_jet = (torch.cuda.max_memory_allocated() - base) / 16
    del st
    torch.cuda.empty_cache()
    b = next((b for b in (128, 64, 32, 16) if per_jet * b <= PLAIN_MEMORY_SHARE * free), 16)
    data, labels = (t.to(dev) for t in real_batch(b, 150))
    st = make_state(args, dev)
    step = step_fn(st, args, data, labels)

    def run(flag):
        def f():
            use_kernels(st, flag)
            step()
        return f

    ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            ms[which] = min(ms[which], best_ms(run(which == "kernel"), inner=1))
    res = {"batch": b, "plain_peak_mb_per_jet": per_jet / 2**20,
           "plain_peak_mb_predicted_b128": per_jet * 128 / 2**20, "free_mb": free / 2**20,
           "kernel_ms": ms["kernel"], "plain_ms": ms["plain"]}
    log("dense150_plain_step", card=card, **res)
    del st, step
    torch.cuda.empty_cache()
    return res


def k4_backward_route(mk, dev, card, b=256, n=30) -> dict:
    """K4's backward route (:class:`EdgeAggregateFn`: K2 recomputed, fn in torch,
    K3 with weight gradients) at B=256 N=30: every gradient against the same
    route through the plain versions (1e-4; weight gradients of max(1,
    max|ref|)), then timed beside it, with its bound: the recompute's, K3's
    and fn's forward and backward products over 67 TFLOP/s, or their bytes."""
    u1, u2, mask, hidden, x, fn = kernel_inputs(dev, b, n, 3, seed=256)
    inputs = [t.clone().requires_grad_() for t in (u1, u2, x, *hidden, *fn)]
    g = torch.randn(b, n, 3, generator=torch.Generator(device=dev).manual_seed(3), device=dev)

    def route(versions):
        u1_, u2_, x_, *flat = inputs
        with plain_versions() if versions else contextlib.nullcontext():
            y = mk.EdgeAggregateFn.apply(u1_, u2_, mask, x_, 0.2, True, 0.2, True, len(hidden),
                                         *flat)

        def backward():
            with plain_versions() if versions else contextlib.nullcontext():
                return torch.autograd.grad(y, inputs, g, retain_graph=True)
        return backward

    kernel, plain = route(False), route(True)
    mk.reset_launch_counts()
    out = kernel()
    torch.cuda.synchronize()
    launches = {k: v for k, v in mk.launch_counts.items() if v}
    ref = plain()
    err = [errors(o, r) if i < 3 else wgrad_err(o, r) for i, (o, r) in enumerate(zip(out, ref))]
    bad = sum(e[2] for e in err[:3]) + sum(not ok for _, ok in err[3:])
    ms = {"kernel": float("inf"), "plain": float("inf")}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for which in order:
            ms[which] = min(ms[which], best_ms(kernel if which == "kernel" else plain))
    fn_widths = FN + [3]
    flops = 4 * 2 * b * n * n * macs(FE) + 3 * 2 * b * n * macs(fn_widths)
    floats = (2 * b * n * FE[0] + b * n) * 2 + 2 * b * n * 32 + b * n * 3 \
        + 2 * (macs(FE) + sum(FE[1:]) + macs(fn_widths) + sum(fn_widths[1:]) + 32 * FN[1])
    res = {"shape": f"B={b} N={n}", "ms": ms["kernel"], "plain_ms": ms["plain"],
           **bound(flops, 4 * floats), "launches": launches,
           "max_abs_err": max(e[0] for e in err)}
    log("k4_backward_route", card=card, **res, failures=bad)
    if bad or launches != {"edge_aggregate": 1, "edge_aggregate_bwd": 1}:
        raise SystemExit(f"phase 34: K4's backward route disagrees with its plain versions "
                         f"({bad} tensors) or launched {launches}")
    return res


def dense150_steps(mk, dev, card, from_args_dict, tmp) -> dict:
    """Phase 34 (2, 3): the 150-particle dense D+G step (bench.py's
    ``train_step_ms_150p_dense_b128`` and ``_bf16_b128``). FP32 at
    DENSE150_CPU_BATCH on the card against the CPU as phase 8 holds it (:func:`step_check`, with
    :class:`KinkRows` and part by part); at B=128 the eager step and the
    ``StaticStep`` graphs bit for bit over an epoch, both timed in turns
    (:func:`graph_step_path`); the plain path's step where it fits
    (:func:`dense150_plain_step`); K2 with dropout and K3 at B=128 against
    their plain versions (phase 7's checks) and timed. Every D drawn
    :func:`unsaturated`, the epochs at D's learning rate DENSE150_LR_DISC, each
    epoch moving both models (:func:`params_moved`). bf16 at B=128: the step
    against the float32 one from the same weights and draws, exactly the
    predicted bf16 launches, a trace naming them; the bf16 epoch on the graph
    against the eager one bit for bit, bf16 and float32 graph steps in turns."""
    t0 = time.perf_counter()
    b, n = DENSE150_STEP_BATCH, 150
    with unsaturated():
        step_check(dev, from_args_dict, card=DENSE150, batch=DENSE150_CPU_BATCH,
                   phase="dense150_step_check", parts=True, floor=0.0)
        args = from_args_dict({**DENSE150, "lr_disc": DENSE150_LR_DISC})
        args.batch_size = b
        f32 = graph_step_path(mk, dev, card, "dense150", args, None, tmp)
    want = dense_steps_expected(150, GRAPH_STEPS)
    if f32["launches_graph"] != want:
        raise SystemExit(f"phase 34: the 150p dense epoch launched {f32['launches_graph']}, "
                         f"predicted {want}")
    plain = dense150_plain_step(dev, from_args_dict, card)
    identical = {"edge_aggregate": True, "edge_aggregate_bwd": True}
    err = train_kernel_checks(mk, dev, identical, shapes=((b, n),), sums=(True,))
    ktimes = train_kernel_times(mk, dev, ((b, n),))[n]
    log("dense150_kernel_times", card=card, **ktimes)
    with unsaturated():
        c16 = bf16_step_check(mk, dev, card, from_args_dict, card_d=DENSE150, batch=b)
        bf16 = bf16_graph_and_timing(mk, dev, card, from_args_dict, tmp,
                                     card_d={**DENSE150, "lr_disc": DENSE150_LR_DISC}, b=b)
    log("dense150_steps", card=card, batch=b, seconds=time.perf_counter() - t0,
        graph_wall_ms=min(f32["wall_ms_graph"]), eager_wall_ms=min(f32["wall_ms_eager"]),
        device_ms=f32["profile_graph"]["device_ms"], idle_share=f32["profile_graph"]["idle_share"],
        issue_ms_graph=f32["issue_ms_graph"], peak_mb_graph=f32["peak_mb_graph"],
        plain=plain, bf16_graph_wall_ms=bf16["wall_ms_bf16"],
        bf16_device_ms=bf16["profile_bf16"]["device_ms"],
        bf16_idle_share=bf16["profile_bf16"]["idle_share"])
    launches = {k: f32["launches_eager"].get(k, 0) + f32["launches_graph"].get(k, 0)
                + c16.get(k, 0) for k in set(f32["launches_graph"]) | set(c16)}
    return {"launches": launches, "f32": f32, "plain": plain, "err": err,
            "identical": identical, "times": ktimes, "bf16": bf16}


def dense150_bf16_generator(mk, dev, card, from_args_dict) -> dict:
    """Phase 34 (4): bench.py's ``jets_per_sec_150p_bf16``: the flagship-width
    150-particle G at B=512 in eval mode through ``train_step.bf16_apply``
    (bf16 copies of its parameters and buffers, bf16 noise: the counterpart of
    bench.py's ``_cast_floats``), against the same call through the bf16
    plain versions at rtol = atol = 1e-2 (the mask column equal) and against
    the float32 G on the same noise (the share of values beyond 5e-2
    logged); jets/s beside the float32 G's in turns, one K2 bf16 launch a
    layer."""
    from mpgan_tpu_torch.models.registry import build_suite
    from mpgan_tpu_torch.training.train_step import bf16_apply

    b, n = DENSE150_GEN_BATCH, 150
    g = build_suite(from_args_dict(DENSE150)).generator(prng_key(35, "cpu"), device=dev)
    g.eval()
    noise = torch.randn(b, n, 32, generator=torch.Generator(device=dev).manual_seed(35),
                        device=dev) * 0.2
    labels = torch.as_tensor(
        (np.random.default_rng(35).integers(1, n + 1, size=(b, 1)) / n).astype(np.float32),
        device=dev)
    run16 = lambda: bf16_apply(g, noise, labels, update_sn=False)  # noqa: E731
    run32 = lambda: g(noise, labels, update_sn=False)  # noqa: E731
    with torch.no_grad():
        mk.reset_launch_counts()
        y16 = run16()
        torch.cuda.synchronize()
        launches = {k: v for k, v in mk.launch_counts.items() if v}
        with plain_versions():
            y16p = run16()
        y32 = run32()
        err, bad = bf16_err(y16, y16p, scaled=False)
        mask_equal = torch.equal(y16[..., -1], y16p[..., -1])
        share = ((y16 - y32).abs() > BF16_GEN_LOGGED).float().mean().item()
        ms = {"bf16": float("inf"), "f32": float("inf")}
        for order in (("f32", "bf16"), ("bf16", "f32")):
            for which in order:
                ms[which] = min(ms[which], best_ms(run16 if which == "bf16" else run32))
    res = {"batch": b, "max_abs_err_vs_bf16_plain": err, "out_of_tol_vs_bf16_plain": bad,
           "mask_column_equal": mask_equal, "tol": BF16_TOL,
           "share_beyond_5e-2_vs_float32": share, "bf16_ms": ms["bf16"], "f32_ms": ms["f32"],
           "bf16_jets_per_s": b / ms["bf16"] * 1e3, "f32_jets_per_s": b / ms["f32"] * 1e3,
           "launches": launches}
    log("dense150_bf16_generator", card=card, **res)
    if bad or not mask_equal or launches != {"edge_aggregate_bf16": 2}:
        raise SystemExit(f"phase 34: the bf16 150p generator disagrees with its bf16 plain "
                         f"versions ({bad} values beyond {BF16_TOL}) or launched {launches}")
    return res


def dense150_train_cli(mk, train_cli, tmp) -> dict:
    """Phase 34 (5): ``cli.train --num-hits 150`` (dense, its default batch 32,
    the graph epochs; every D drawn :func:`unsaturated`, its learning rate
    DENSE150_LR_DISC) for 2 epochs with the
    evaluation, a resume that restores the state exactly, a 3rd epoch that
    moves the parameters; counts set to 0 before and read after:
    K2 with and without dropout and K3 with and without weight gradients in
    the counts the steps and the evaluation predict, no K4 and no knn
    kernel."""
    argv = ["--device", "cuda", "--name", "dense150", "--model", "mpgan", "--jets", "g",
            "--num-hits", "150", "--dir-path", str(tmp), "--num-samples", "640",
            "--eval-tot-samples", "640", "--w1-num-samples", "320", "--save-model-epochs", "1",
            "--save-epochs", "2", "--epoch-scan", "--lr-disc", str(DENSE150_LR_DISC)]
    mk.reset_launch_counts()
    with unsaturated():
        t0 = time.perf_counter()
        t1 = train_cli.main(argv + ["--num-epochs", "2"])
        wall = time.perf_counter() - t0
        before = [t.detach().cpu().clone() for t in _leaves(t1.state)]
        rng_before = t1.state.rng.clone()
        t2 = train_cli.main(argv + ["--num-epochs", "2"])  # resume, no epoch to run
        after = [t.detach().cpu() for t in _leaves(t2.state)]
        restored = (t2.start_epoch == 2 and len(before) == len(after)
                    and all(torch.equal(a, c) for a, c in zip(before, after))
                    and torch.equal(t2.state.rng, rng_before))
        resumed = model_params(t2.state)
        t3 = train_cli.main(argv + ["--num-epochs", "3"])
    moved = params_moved(t3.state, resumed, "phase 34's train CLI, epoch 3")
    counts = {k: v for k, v in mk.launch_counts.items() if v}
    batch = t1.args.batch_size
    steps = 3 * (len(t1.train_dataset) // batch)
    eval_batches = -(-min(t1.args.eval_tot_samples, len(t1.valid_dataset)) // batch)
    predicted = dense_steps_expected(150, steps, eval_batches)
    losses = {k: t3.losses[k] for k in ("Dr", "Df", "D", "G")}
    finite = all(np.isfinite(v).all() for v in losses.values()) and \
        all(np.isfinite(np.asarray(t3.losses[k])).all() for k in ("w1p", "w1m"))
    files = sorted(f.name for f in (tmp / "dense150" / "models").iterdir())
    log("dense150_train_cli", wall_s_2_epochs=wall, batch=batch, steps=steps,
        eval_batches=eval_batches, checkpoints=files, resumed_from=t2.start_epoch,
        state_restored=restored, epoch3_params_moved=moved, epochs=len(t3.losses["G"]),
        losses=losses, w1m=t3.losses["w1m"], replays=t3.graphs.replays, launches=counts,
        predicted=predicted)
    if batch != 32 or not all(c.fully_connected for c in t1.state.g.cfg.layers):
        raise SystemExit("phase 34: the train CLI did not build the dense 150p model at batch 32")
    if files != ["state_1.npz", "state_2.npz", "state_3.npz"] or not restored:
        raise SystemExit(f"phase 34: train CLI checkpoints {files}, state restored: {restored}")
    if not finite or len(t3.losses["G"]) != 3 or t3.losses["G"][:2] != t1.losses["G"] \
            or not t3.graphs.replays:
        raise SystemExit(f"phase 34: train CLI losses not finite or not resumed, or no graph "
                         f"replayed: {losses}")
    if counts != predicted:
        raise SystemExit(f"phase 34: the 150p dense train CLI launched {counts}, predicted "
                         f"{predicted}")
    return counts


def dense150_phase(mk, train_cli, gen_cli, dev, card, from_args_dict, tmp) -> dict:
    """Phase 34: the 150-particle dense paths bench.py times, each driven with
    the counts set to 0 just before it and read just after; returns their
    figures, the launches by kernel among them."""
    t0 = time.perf_counter()
    gen = dense150_generator(mk, gen_cli, dev, card, from_args_dict, tmp)
    steps = dense150_steps(mk, dev, card, from_args_dict, tmp)
    bf16_gen = dense150_bf16_generator(mk, dev, card, from_args_dict)
    cli = dense150_train_cli(mk, train_cli, tmp)
    k4_bwd = k4_backward_route(mk, dev, card)
    launches = {}
    for counts in (gen["launches"], steps["launches"], bf16_gen["launches"], cli,
                   k4_bwd["launches"]):
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
    log("dense150", card=card, seconds=time.perf_counter() - t0, launches=launches,
        jets_per_s_fe128_256=gen["jets_per_s"], jets_per_s_bf16=bf16_gen["bf16_jets_per_s"],
        step_ms_b128=min(steps["f32"]["wall_ms_graph"]),
        step_ms_bf16_b128=steps["bf16"]["wall_ms_bf16"])
    return {"launches": launches, "gen": gen, "steps": steps, "bf16_gen": bf16_gen,
            "k4_bwd": k4_bwd}


def _tree_tensors(tree) -> list:
    """An FPND trunk's tensors in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tree_tensors(item)]
    return [tree]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    # the port itself; a directory without the checkout fails here
    from mpgan_tpu_torch.cli import gen
    from mpgan_tpu_torch.cli import train as train_cli
    from mpgan_tpu_torch.data.jetnet import JetNetDataset
    from mpgan_tpu_torch.models.mpgan import MPGenerator
    from mpgan_tpu_torch.ops import _build
    from mpgan_tpu_torch.ops import gapt_kernels as gk
    from mpgan_tpu_torch.ops import knn_kernels as kk
    from mpgan_tpu_torch.ops import mp_kernels as mk
    from mpgan_tpu_torch.ops import prng
    from mpgan_tpu_torch.training.config import build_mpgan_generator, from_args_dict
    from mpgan_tpu_torch.training.sampling import generate_multi_batch, noise_spec
    from mpgan_tpu_torch.utils.weights import mp_generator_to_reference_sd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    # 1. card and toolchain
    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log("toolchain", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_version, python=sys.version.split()[0])

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    ptxas = [line.strip() for line in _build.build_info.get("log", "").splitlines()
             if "registers" in line or "spill" in line]
    log("build", seconds=time.perf_counter() - t0, cached=_build.build_info.get("cached"),
        library=_build.build_info.get("path"), ptxas=ptxas)

    # 3. kernels against their plain versions, each launched twice
    max_err = {"edge_aggregate": 0.0, "edge_aggregate_fn": 0.0, "edge_aggregate_fe128_256": 0.0}
    # bit-identity of every rerun of a kernel in this run (a mismatch also stops it)
    identical = {"edge_aggregate": True, "edge_aggregate_fn": True, "edge_aggregate_bwd": True,
                 "knn_fused_layer": True, "knn_edge_aggregate": True}
    shapes = [(b, n, fn_out, FE) for b, n in ((256, 30), (16, 150)) for fn_out in (32, 3)]
    shapes.append((16, 150, 3, [128, 256]))  # the 150-particle --fe 128 256 chain
    for b, n, fn_out, fe in shapes:
        for sum_agg in (True, False):
            u1, u2, mask, hidden, x, fn = kernel_inputs(dev, b, n, fn_out, seed=n + fn_out, fe=fe)
            k2 = lambda: mk.edge_aggregate(u1, u2, mask, hidden, 0.2, sum_agg)  # noqa: E731
            k4 = lambda: mk.edge_aggregate_fn(u1, u2, mask, hidden, x, fn, 0.2,  # noqa: E731
                                              sum_agg, 0.2, True)
            checks = {"edge_aggregate": (k2(), k2(), mk.edge_aggregate_reference(
                u1, u2, mask, hidden, 0.2, sum_agg))}
            if fe == FE:
                checks["edge_aggregate_fn"] = (k4(), k4(), mk.edge_aggregate_fn_reference(
                    u1, u2, mask, hidden, x, fn, 0.2, sum_agg, 0.2, True))
            torch.cuda.synchronize()
            for name, (out, again, ref) in checks.items():
                abs_err, rel_err, bad = errors(out, ref)
                repeat = torch.equal(out, again)
                identical[name] &= repeat
                log("kernel_check", kernel=name, fe=fe, b=b, n=n, sum_agg=sum_agg, fn_out=fn_out,
                    max_abs_err=abs_err, max_rel_err=rel_err, out_of_tol=bad,
                    two_runs_bit_identical=repeat)
                if bad or not repeat:
                    raise SystemExit(f"{name} disagrees with its plain version or itself at "
                                     f"b={b} n={n} fe={fe} sum={sum_agg}: {bad} elements beyond "
                                     f"rtol=atol={TOL}, bit-identical rerun {repeat}")
                key = "edge_aggregate_fe128_256" if fe != FE else name
                max_err[key] = max(max_err[key], abs_err)

    # 4. main path: 50,000 flagship jets through the gen CLI
    mk.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        args = from_args_dict(FLAGSHIP)
        (tmp / "card.txt").write_text(repr(args.to_dict()))
        g30 = MPGenerator(build_mpgan_generator(args), prng_key(0, "cpu"))
        torch.save(mp_generator_to_reference_sd(g30), tmp / "G.pt")
        out_file = tmp / "gen.npy"
        t0 = time.perf_counter()
        gen.main(["--g-args", str(tmp / "card.txt"), "--g-state", str(tmp / "G.pt"),
                  "--output-file", str(out_file), "--device", "cuda", "--seed", "0",
                  "--num-samples", "50000", "--batch-size", "4096"])
        wall = time.perf_counter() - t0
        jets = np.load(out_file)
    ds = JetNetDataset("g", num_particles=30, split="valid")
    labels = ds.jet_data[np.random.default_rng(0).choice(len(ds), size=50000)]
    counts = (labels[:, -1].astype(np.float32) * 30).astype(np.int32)
    real = np.any(jets != 0, axis=-1).sum(axis=1)
    if jets.shape != (50000, 30, 3) or not np.isfinite(jets).all():
        raise SystemExit(f"gen output {jets.shape} is not finite (50000, 30, 3)")
    if not np.array_equal(real, counts) or (jets[:, :, 2] < 0).any():
        raise SystemExit("gen output: masked particles not zero or negative pT")
    log("main_path_30p", jets=list(jets.shape), wall_s=wall, launches=dict(mk.launch_counts))

    # 5. 150-particle dense generation
    args150 = from_args_dict({**FLAGSHIP, "num_hits": 150})
    cfg150 = build_mpgan_generator(args150)
    g150 = MPGenerator(cfg150, prng_key(1, "cpu"), device=dev)
    spec150 = noise_spec("mpgan", {"latent_node_size": 32}, 150, args150.sd)
    ds150 = JetNetDataset("g", num_particles=150, split="valid", synthetic_num_jets=10000)
    lab150 = ds150.jet_data[np.random.default_rng(1).choice(len(ds150), size=2048)]
    t0 = time.perf_counter()
    out150 = generate_multi_batch(g150, spec150, prng_key(1, dev),
                                  2048, 512, labels=lab150)
    wall150 = time.perf_counter() - t0
    launches = dict(mk.launch_counts)
    mask150 = out150[..., -1] + 0.5
    if out150.shape != (2048, 150, 4) or not np.isfinite(out150).all():
        raise SystemExit(f"150p output {out150.shape} is not finite (2048, 150, 4)")
    if not np.array_equal(mask150.sum(1), (lab150[:, 0] * 150).astype(np.int32)):
        raise SystemExit("150p mask counts disagree with the labels")
    gen_draws = prng.launch_counts["threefry_draws"]
    log("main_path_150p", jets=list(out150.shape), wall_s=wall150, launches=launches,
        threefry_draws=gen_draws)
    for name in ("edge_aggregate", "edge_aggregate_fn"):
        if launches[name] == 0:
            raise SystemExit(f"kernel {name} never launched on the generation path")
    if gen_draws == 0:
        raise SystemExit("kernel threefry_draws never launched on the generation path")

    # 6. kernel path against plain path at the sampler's batch, then timings (kernel and
    # plain in turns)
    timings = {}
    for n, b, g in ((30, 4096, g30.to(dev)), (150, 512, g150)):
        noise = torch.randn(b, n, 32, generator=torch.Generator(device=dev).manual_seed(2),
                            device=dev) * 0.2
        lab = torch.as_tensor(
            (np.random.default_rng(2).integers(1, n + 1, size=(b, 1)) / n).astype(np.float32),
            device=dev,
        )
        kernel_cfg = g.cfg
        plain_cfg = dataclasses.replace(kernel_cfg, use_kernels=False)
        with torch.inference_mode():
            y_k = g(noise, lab)
            g.cfg = plain_cfg
            y_p = g(noise, lab)
            g.cfg = kernel_cfg
        abs_err, rel_err, bad = errors(y_k, y_p)
        mask_equal = torch.equal(y_k[..., -1], y_p[..., -1])
        log("generator_check", n=n, batch=b, max_abs_err=abs_err, max_rel_err=rel_err,
            out_of_tol=bad, mask_column_equal=mask_equal)
        if bad or not mask_equal:
            raise SystemExit(f"{n}p generator at B={b}: kernel path disagrees with plain path")
        del y_k, y_p

        def run(cfg):
            def f():
                g.cfg = cfg
                with torch.inference_mode():
                    g(noise, lab)
            return f

        ms = {"kernel": float("inf"), "plain": float("inf")}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for which in order:
                ms[which] = min(ms[which], best_ms(run(kernel_cfg if which == "kernel"
                                                       else plain_cfg)))
        g.cfg = kernel_cfg
        timings[n] = ms
        mk.reset_launch_counts()
        run(kernel_cfg)()
        log("generation_rate", card=card, n=n, batch=b,
            kernel_ms=ms["kernel"], plain_ms=ms["plain"],
            kernel_jets_per_s=b / ms["kernel"] * 1e3, plain_jets_per_s=b / ms["plain"] * 1e3,
            launches_per_batch={k: v for k, v in mk.launch_counts.items() if v})

    # K4 and K2 at the main path's shapes: against their plain versions, twice bit for
    # bit, then timed
    u1, u2, mask, hidden, x, fn = kernel_inputs(dev, 4096, 30, 3, seed=7)
    k4 = main_shape(
        identical, max_err, "edge_aggregate_fn", 4096, 30,
        lambda: mk.edge_aggregate_fn(u1, u2, mask, hidden, x, fn, 0.2, True, 0.2, True),
        lambda: mk.edge_aggregate_fn_reference(u1, u2, mask, hidden, x, fn, 0.2, True, 0.2, True),
        inner=3)
    del u1, u2, mask, hidden, x, fn
    torch.cuda.empty_cache()
    u1, u2, mask, hidden, _, _ = kernel_inputs(dev, 512, 150, 3, seed=8)
    k2 = main_shape(
        identical, max_err, "edge_aggregate", 512, 150,
        lambda: mk.edge_aggregate(u1, u2, mask, hidden, 0.2, True),
        lambda: mk.edge_aggregate_reference(u1, u2, mask, hidden, 0.2, True), inner=1)
    del u1, u2, mask, hidden
    torch.cuda.empty_cache()
    log("kernel_times", card=card,
        edge_aggregate={"shape": "B=512 N=150", "ms": k2[0], "plain_ms": k2[1]},
        edge_aggregate_fn={"shape": "B=4096 N=30", "ms": k4[0], "plain_ms": k4[1]})

    # 7-10. training
    train_err = train_kernel_checks(mk, dev, identical)
    step_check(dev, from_args_dict, parts=True)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = main_train_path(mk, train_cli, gen, pathlib.Path(tmp))
    step_ms, ttimes = train_timings(mk, dev, from_args_dict, card)

    # 11-15. the 150-particle knn-20 path
    knn_err = knn_kernel_checks(kk, mk, dev)
    knn_err["knn_fused_layer"] = max(knn_err["knn_fused_layer"],
                                     knn_main_shape_checks(kk, dev, identical))
    knn_gen_launches = knn_generation(mk, gen, dev, card)
    step_check(dev, from_args_dict, card=KNN150, batch=8, phase="knn_step_check",
               cpu_plain_kernels=False, loss_tol=NEAR_TIE_LOSS_TOL, grad_tol=NEAR_TIE_GRAD_TOL,
               knn=kk, parts=True)
    with tempfile.TemporaryDirectory() as tmp:
        knn_train_launches = knn_train_path(mk, train_cli, pathlib.Path(tmp))
    knn_step_ms, ktimes = knn_timings(kk, dev, from_args_dict, card)

    # 16-20. GAPT
    gapt_err, identical["gapt_g_fused"] = gapt_kernel_checks(gk, dev, from_args_dict)
    gapt_gen_launches = gapt_generation(mk, gen, dev, card, from_args_dict)
    step_check(dev, from_args_dict, card=GAPT, batch=16, phase="gapt_step_check")
    with tempfile.TemporaryDirectory() as tmp:
        gapt_train_launches = gapt_train_path(mk, train_cli, pathlib.Path(tmp))
    gapt_rates, gtimes, gapt_step_ms = gapt_timings(gk, dev, from_args_dict, card)

    # 21. the split knn route
    split_err = knn_split_checks(kk, dev)
    split_launches, stimes = knn_split_route(kk, mk, dev, from_args_dict, card)

    # 22. evaluation at the loop's size
    with tempfile.TemporaryDirectory() as tmp:
        eval_launches = evaluation(mk, dev, card, pathlib.Path(tmp))

    # 23. the model zoo
    with tempfile.TemporaryDirectory() as tmp:
        zoo_launches, zoo = model_zoo(mk, train_cli, gen, dev, card, from_args_dict,
                                      pathlib.Path(tmp))

    # 24. FPND at the loop's size
    fpnd_launches = fpnd_phase(mk, dev, card, from_args_dict)
    # 25. the flagship train CLI with every flag of this slice
    with tempfile.TemporaryDirectory() as tmp:
        all_launches = train_cli_all_flags(mk, train_cli, dev, card, from_args_dict,
                                           pathlib.Path(tmp))
    # 26. train_mnist
    with tempfile.TemporaryDirectory() as tmp:
        mnist_launches, mnist_err, mnist_times, mnist_runs = mnist_phase(
            mk, dev, card, identical, pathlib.Path(tmp))
    later = [zoo_launches, all_launches, mnist_launches]  # phases 23, 25, 26 (30 below)
    # 27. the static-buffer steps and the samplers as CUDA graphs
    with tempfile.TemporaryDirectory() as tmp:
        graph_phase(mk, train_cli, dev, card, from_args_dict, pathlib.Path(tmp))
    # 28. bf16 training
    with tempfile.TemporaryDirectory() as tmp:
        bf16_worst, bf16_identical, bf16_times, bf16_launches, bf16_steps = bf16_phase(
            mk, train_cli, dev, card, from_args_dict, pathlib.Path(tmp))
    # 29. bf16 training on the knn-20 and GAPT paths
    with tempfile.TemporaryDirectory() as tmp:
        kb_worst, kb_identical, kb_times, kb_launches, kb_steps = bf16_knn_gapt_phase(
            kk, gk, mk, train_cli, dev, card, from_args_dict, pathlib.Path(tmp))
    # 30. the mesh
    with tempfile.TemporaryDirectory() as tmp:
        mesh_launches = mesh_phase(mk, train_cli, gen, dev, card, from_args_dict,
                                   pathlib.Path(tmp))
    later.append(mesh_launches)
    # 31. the steps' random stream on the card
    with tempfile.TemporaryDirectory() as tmp:
        prng_err, prng_times, prng_steps_, epoch_draws = prng_phase(
            mk, dev, card, from_args_dict, pathlib.Path(tmp))
    # 32. the models' initial weights drawn from the key on the card
    with tempfile.TemporaryDirectory() as tmp:
        init_draws, init_models = init_phase(mk, dev, card, from_args_dict, pathlib.Path(tmp))
    # 33. the MP layer's configuration lattice
    lattice_launches = lattice_phase(card)
    # 34. the 150-particle dense paths bench.py times
    with tempfile.TemporaryDirectory() as tmp:
        dense150 = dense150_phase(mk, train_cli, gen, dev, card, from_args_dict,
                                  pathlib.Path(tmp))
    identical["edge_aggregate"] &= dense150["gen"]["identical"] and \
        dense150["steps"]["identical"]["edge_aggregate"]
    identical["edge_aggregate_bwd"] &= dense150["steps"]["identical"]["edge_aggregate_bwd"]
    d150_times = dense150["steps"]["times"]

    def bf16_row(name, jobs):
        """The bf16 mode inside a kernel's row: its launches in phase 28, worst
        error, reruns, and per timed job its ms, FP32-mode ms, plain ms and bound."""
        kinds = {"edge_aggregate": ("edge_aggregate_bf16", "edge_aggregate_train_bf16"),
                 "edge_aggregate_fn": ("edge_aggregate_fn_bf16",),
                 "edge_aggregate_bwd": ("edge_aggregate_bwd_bf16",
                                        "edge_aggregate_bwd_no_wgrads_bf16")}[name]
        return {"source": BF16_SOURCES[name], "launches": sum(bf16_launches[k] for k in kinds),
                "max_abs_err": bf16_worst[name], "tol": BF16_TOL,
                "two_runs_bit_identical": bf16_identical[name],
                **{job: bf16_times[job] for job in jobs}}

    def bf16_knn_row(name, jobs):
        """The bf16 mode inside a K5-K9 row: its launches on phase 29's main
        paths, worst error, reruns, and per timed job its ms, FP32-mode ms,
        plain ms and bound."""
        return {"source": BF16_KNN_SOURCES[name],
                "launches": sum(kb_launches[k] for k in BF16_KNN_KINDS[name]),
                "max_abs_err": kb_worst[name], "tol": BF16_TOL,
                "two_runs_bit_identical": kb_identical[name],
                **{job: kb_times[job] for job in jobs}}

    def bf16_knn_launches(name):
        return sum(kb_launches[k] for k in BF16_KNN_KINDS[name])

    fwd_src = "mpgan_tpu_torch/csrc/edge_aggregate.cu"
    kernels = [
        {"name": "edge_aggregate", "route": "cuda", "source": fwd_src,
         "replaces": REPLACES["edge_aggregate"], "includes": K1,
         "launches": launches["edge_aggregate"] + train_launches["edge_aggregate"]
         + train_launches["edge_aggregate_train"] + eval_launches["edge_aggregate"]
         + sum(c["edge_aggregate"] + c["edge_aggregate_train"] for c in later)
         + bf16_launches["edge_aggregate_bf16"] + bf16_launches["edge_aggregate_train_bf16"],
         "max_abs_err": max(max_err["edge_aggregate"], train_err["edge_aggregate"],
                            mnist_err["edge_aggregate"]),
         "max_abs_err_fe128_256": max_err["edge_aggregate_fe128_256"],
         "two_runs_bit_identical": identical["edge_aggregate"],
         "ms": k2[0], "plain_ms": k2[1], **dense_fwd_bound(512, 150), "shape": "B=512 N=150 eval",
         "train_ms": ttimes[30]["train_fwd"]["ms"],
         "train_plain_ms": ttimes[30]["train_fwd"]["plain_ms"],
         "train_shape": "B=256 N=30 dropout 0.5",
         "train_bound_ms": ttimes[30]["train_fwd"]["bound_ms"],
         "mnist": {f"n{n}": {k: v[k] for k in ("eval", "train_fwd")}
                   for n, v in mnist_times.items()},
         "bf16": bf16_row("edge_aggregate", ("k2_train_n30", "k2_eval_n30", "k2_train_n150",
                                             "k2_eval_n150"))},
        {"name": "edge_aggregate_fn", "route": "cuda", "source": fwd_src,
         "replaces": REPLACES["edge_aggregate_fn"],
         "launches": launches["edge_aggregate_fn"] + train_launches["edge_aggregate_fn"]
         + eval_launches["edge_aggregate_fn"] + fpnd_launches
         + sum(c["edge_aggregate_fn"] for c in later) + bf16_launches["edge_aggregate_fn_bf16"],
         "max_abs_err": max_err["edge_aggregate_fn"],
         "two_runs_bit_identical": identical["edge_aggregate_fn"],
         "ms": k4[0], "plain_ms": k4[1],
         **dense_fwd_bound(4096, 30, 3), "shape": "B=4096 N=30",
         "bf16": bf16_row("edge_aggregate_fn", ("k4_n30",))},
        {"name": "edge_aggregate_bwd", "route": "cuda",
         "source": "mpgan_tpu_torch/csrc/edge_aggregate_bwd.cu",
         "replaces": REPLACES["edge_aggregate_bwd"], "includes": K1,
         "launches": train_launches["edge_aggregate_bwd"]
         + train_launches["edge_aggregate_bwd_no_wgrads"]
         + sum(c["edge_aggregate_bwd"] + c["edge_aggregate_bwd_no_wgrads"] for c in later)
         + bf16_launches["edge_aggregate_bwd_bf16"]
         + bf16_launches["edge_aggregate_bwd_no_wgrads_bf16"],
         "max_abs_err": max(train_err["edge_aggregate_bwd"], mnist_err["edge_aggregate_bwd"]),
         "two_runs_bit_identical": identical["edge_aggregate_bwd"],
         **{k: v for k, v in ttimes[30]["bwd"].items() if k != "shape"},
         "shape": "B=256 N=30 dropout 0.5 with weight gradients",
         "ms_no_wgrads": ttimes[30]["bwd_no_wgrads"]["ms"],
         "plain_ms_no_wgrads": ttimes[30]["bwd_no_wgrads"]["plain_ms"],
         "bound_ms_no_wgrads": ttimes[30]["bwd_no_wgrads"]["bound_ms"],
         "shape_150": "B=32 N=150 dropout 0.5",
         "ms_150": ttimes[150]["bwd"]["ms"], "plain_ms_150": ttimes[150]["bwd"]["plain_ms"],
         "bound_ms_150": ttimes[150]["bwd"]["bound_ms"],
         "ms_150_no_wgrads": ttimes[150]["bwd_no_wgrads"]["ms"],
         "plain_ms_150_no_wgrads": ttimes[150]["bwd_no_wgrads"]["plain_ms"],
         "bound_ms_150_no_wgrads": ttimes[150]["bwd_no_wgrads"]["bound_ms"],
         "mnist": {f"n{n}": {k: v[k] for k in ("bwd", "bwd_no_wgrads")}
                   for n, v in mnist_times.items()},
         "bf16": bf16_row("edge_aggregate_bwd", ("k3_n30", "k3_no_wgrads_n30", "k3_n150",
                                                 "k3_no_wgrads_n150"))},
        {"name": "knn_fused_layer", "route": "cuda",
         "source": "mpgan_tpu_torch/csrc/knn_fused.cu", "replaces": REPLACES["knn_fused_layer"],
         "includes": K1,
         "launches": knn_gen_launches["knn_fused_layer"] + knn_train_launches["knn_fused_layer"]
         + knn_train_launches["knn_fused_layer_train"] + bf16_knn_launches("knn_fused_layer"),
         "max_abs_err": knn_err["knn_fused_layer"],
         "two_runs_bit_identical": identical["knn_fused_layer"], **ktimes["eval"],
         "train_ms": ktimes["train"]["ms"], "train_plain_ms": ktimes["train"]["plain_ms"],
         "train_shape": ktimes["train"]["shape"], "train_bound_ms": ktimes["train"]["bound_ms"],
         "bf16": bf16_knn_row("knn_fused_layer", ("k5_eval", "k5_train", "k5_train_dists"))},
        {"name": "knn_edge_aggregate_bwd", "route": "cuda",
         "source": "mpgan_tpu_torch/csrc/knn_edge_bwd.cu",
         "replaces": REPLACES["knn_edge_aggregate_bwd"], "includes": K1,
         "launches": knn_train_launches["knn_edge_aggregate_bwd"]
         + knn_train_launches["knn_edge_aggregate_bwd_no_wgrads"]
         + split_launches["knn_edge_aggregate_bwd"]
         + split_launches["knn_edge_aggregate_bwd_no_wgrads"]
         + bf16_knn_launches("knn_edge_aggregate_bwd"),
         "max_abs_err": knn_err["knn_edge_aggregate_bwd"], **ktimes["bwd"],
         "ms_no_wgrads": ktimes["bwd_no_wgrads"]["ms"],
         "plain_ms_no_wgrads": ktimes["bwd_no_wgrads"]["plain_ms"],
         "bound_ms_no_wgrads": ktimes["bwd_no_wgrads"]["bound_ms"],
         "bf16": bf16_knn_row("knn_edge_aggregate_bwd", ("k6", "k6_no_wgrads"))},
        {"name": "knn_search", "route": "cuda", "source": "mpgan_tpu_torch/csrc/knn_search.cu",
         "replaces": REPLACES["knn_search"],
         "launches": split_launches["knn_search"] + bf16_knn_launches("knn_search"),
         "max_abs_err": split_err["knn_search"], **stimes["search_eval"],
         "train_ms": stimes["search_train"]["ms"],
         "train_plain_ms": stimes["search_train"]["plain_ms"],
         "train_shape": stimes["search_train"]["shape"],
         "train_bound_ms": stimes["search_train"]["bound_ms"],
         "dists_ms": stimes["search_dists"]["ms"],
         "dists_plain_ms": stimes["search_dists"]["plain_ms"],
         "dists_shape": stimes["search_dists"]["shape"],
         "dists_bound_ms": stimes["search_dists"]["bound_ms"],
         "bf16": bf16_knn_row("knn_search", ("k7", "k7_dists"))},
        {"name": "knn_edge_aggregate", "route": "cuda",
         "source": "mpgan_tpu_torch/csrc/knn_edge_aggregate.cu",
         "replaces": REPLACES["knn_edge_aggregate"], "includes": K1,
         "launches": split_launches["knn_edge_aggregate"]
         + bf16_knn_launches("knn_edge_aggregate"),
         "max_abs_err": split_err["knn_edge_aggregate"],
         "bit_identical_to_knn_fused_layer": identical["knn_edge_aggregate"],
         **stimes["aggregate_eval"],
         "train_ms": stimes["aggregate_train"]["ms"],
         "train_plain_ms": stimes["aggregate_train"]["plain_ms"],
         "train_shape": stimes["aggregate_train"]["shape"],
         "train_bound_ms": stimes["aggregate_train"]["bound_ms"],
         "bf16": bf16_knn_row("knn_edge_aggregate", ("k8",))},
        {"name": "gapt_g_fused", "route": "cuda", "source": "mpgan_tpu_torch/csrc/gapt_fused.cu",
         "replaces": REPLACES["gapt_g_fused"],
         "launches": gapt_gen_launches + gapt_train_launches + bf16_knn_launches("gapt_g_fused"),
         "max_abs_err": gapt_err,
         "two_runs_bit_identical": identical["gapt_g_fused"],
         **{k: v for k, v in gtimes[1024].items() if not k.startswith("sdpa")},
         "ms_b4096": gtimes[4096]["ms"], "plain_ms_b4096": gtimes[4096]["plain_ms"],
         "bound_ms_b4096": gtimes[4096]["bound_ms"],
         "ms_n150": gtimes[150]["ms"], "plain_ms_n150": gtimes[150]["plain_ms"],
         "bound_ms_n150": gtimes[150]["bound_ms"], "shape_n150": gtimes[150]["shape"],
         "bf16": bf16_knn_row("gapt_g_fused", ("b1024", "b4096"))},
        {"name": "threefry_draws", "route": "cuda", "source": "mpgan_tpu_torch/csrc/threefry.cu",
         "replaces": "mpgan_tpu/training/train_step.py:182 (jax.random inside the jitted "
                     "step, :261, and in the models' init functions; no pallas_call)",
         # phases 4-5 (the sampler, 50,000 + 2,048 jets), phase 31's captured epoch
         # and phase 32's builds of the models on the card
         "launches": gen_draws + epoch_draws + init_draws, "max_abs_err": prng_err,
         **{k: v for k, v in prng_times["flagship"].items()},
         "shape": "the flagship D+G step's plan, B=256",
         **{f"{name}_{k}": v for name in ("knn20", "gapt", "sampler")
            for k, v in prng_times[name].items() if k in ("ms", "plain_ms", "bound_ms",
                                                           "bound_by", "words")},
         "graph_steps": prng_steps_,
         "init": {m: {k: v[k] for k in ("ms", "launches")} for m, v in init_models.items()}},
    ]
    for row in kernels:  # phase 33's launches of each kernel, its bf16 mode's included
        row["lattice_launches"] = sum(
            c for name, c in lattice_launches.items()
            if re.sub(r"_train|_no_wgrads|_bf16", "", name) == row["name"])
        # phase 34's main paths, its bf16 mode's included
        row["dense150_launches"] = sum(
            c for name, c in dense150["launches"].items()
            if re.sub(r"_train|_no_wgrads|_bf16", "", name) == row["name"])
        row["launches"] += row["dense150_launches"]
    k2_row, k4_row, k3_row = kernels[:3]
    k2_row["max_abs_err"] = max(k2_row["max_abs_err"], dense150["gen"]["k2"]["max_abs_err"],
                                dense150["steps"]["err"]["edge_aggregate"])
    k2_row["dense150"] = {"eval_fe128_256": {k: v for k, v in dense150["gen"]["k2"].items()
                                             if k not in ("max_abs_err",
                                                          "two_runs_bit_identical")},
                          "train": d150_times["train_fwd"]}
    k3_row["max_abs_err"] = max(k3_row["max_abs_err"],
                                dense150["steps"]["err"]["edge_aggregate_bwd"])
    k3_row["dense150"] = {"bwd": d150_times["bwd"], "bwd_no_wgrads": d150_times["bwd_no_wgrads"]}
    k4_row["backward_route"] = {k: v for k, v in dense150["k4_bwd"].items()
                                if k not in ("launches", "max_abs_err")}
    log("knn_train_step", batch=128, kernel_ms=knn_step_ms["kernel"],
        plain_ms=knn_step_ms["plain"])
    log("train_step", kernel_ms=step_ms["kernel"], plain_ms=step_ms["plain"])
    log("bf16_train_step", card=card, batch=256, graph_wall_ms_f32=bf16_steps["wall_ms_f32"],
        graph_wall_ms_bf16=bf16_steps["wall_ms_bf16"],
        device_ms_f32=bf16_steps["profile_f32"]["device_ms"],
        device_ms_bf16=bf16_steps["profile_bf16"]["device_ms"],
        idle_f32=bf16_steps["profile_f32"]["idle_share"],
        idle_bf16=bf16_steps["profile_bf16"]["idle_share"])
    for path, st in kb_steps.items():
        log("bf16_train_step", card=card, path=path, graph_wall_ms_f32=st["wall_ms_f32"],
            graph_wall_ms_bf16=st["wall_ms_bf16"], device_ms_f32=st["profile_f32"]["device_ms"],
            device_ms_bf16=st["profile_bf16"]["device_ms"],
            idle_f32=st["profile_f32"]["idle_share"], idle_bf16=st["profile_bf16"]["idle_share"])
    log("zoo", card=card, step_ms={k: v["step_ms"] for k, v in zoo.items()},
        jets_per_s={k: v["jets_per_s"] for k, v in zoo.items()},
        zoo_launches={k: v for k, v in zoo_launches.items() if v})
    log("train_mnist_step", card=card,
        step_ms={n: r["step_ms"] for n, r in mnist_runs.items()},
        epoch_wall_s={n: r["wall_s"] for n, r in mnist_runs.items()})
    log("gapt_train_step", batch=512, kernel_ms=gapt_step_ms["kernel"],
        plain_ms=gapt_step_ms["plain"],
        jets_per_s_b1024=1024 / gapt_rates[1024]["kernel"] * 1e3,
        jets_per_s_b4096=4096 / gapt_rates[4096]["kernel"] * 1e3)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
