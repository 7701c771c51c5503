"""Drive the PyTorch port (mmlspark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100
and the CUDA toolkit.  Phases, each of which fails the run (non-zero
exit, no result line) if anything in it fails:

1. device: a CUDA card must be present; its name and power limit are
   read with nvidia-smi.
2. build: every kernel of `mmlspark_tpu_torch/csrc/` is compiled (one
   nvcc per source, all at once, beside the nvJPEG decoder with its C2
   kernel, `mmlspark_tpu_torch/native/`) into `mmlspark_tpu_torch/csrc/
   build/` (and `native/build/`);
   each one's register and spill report is printed, and for the TMA /
   wgmma kernels of B4, B5 and B6 (bf16, D <= 128) their registers at
   launch, spills (the run fails on any) and shared memory a block; the
   run also fails on a spill in B7/B8's or B1's source.
3. kernel check: each kernel's wrapper runs on the card at the shapes the
   main paths give it (plus ragged ones; B1 on both its routes, with its
   route, rows a tile and shared memory printed, also at ragged store
   edges, at plans its rule sends to the pixel route and at two composed
   chains; B4 also at the batcher's admission prefill buckets, 8x1024 and
   1x16; B7/B8 also with f32 pools, a GQA pool and D 32) and is held
   against its plain PyTorch version on the same inputs; kernel, plain
   and library times (CUDA events) are printed beside the least time the
   card could take and the achieved TFLOP/s (B1, B2, B3, B4 and B6 from
   calls queued behind a spin: the device alone, with the back-to-back
   time beside it).
4. ResNet path: `ImageFeaturizer.transform` with the zoo's random-init
   ResNet-50 at 224x224, batch 64, on a table of 192 uint8 BGR images in
   the three sizes of the JAX package's benchmark (256x256, 224x224,
   320x240).  The kernels' launch counters are zeroed just before and
   read just after; the pooled features are checked for shape and
   finiteness, against the same transform with the preprocess forced
   through the plain version on the card, and against an f32 run of the
   port on the CPU (on weights with random BatchNorms, so that every
   residual branch counts) for a few images.  Then images/s as a range
   over repeated runs with the feed's time split, and one chunk's device
   time from a CUDA-graph replay beside its eager stream span.
4b. JPEG path: the port's JPEG decoder (libjpeg where its headers exist,
   else nvJPEG from the CUDA toolkit; the run fails without one) holds
   each committed fixture of tests/jpeg_fixtures/ (bench.py's recipe:
   uniform noise, quality 85; and progressive and restart-interval
   streams, of which nvJPEG refuses a progressive one with restarts
   (fault C3) and an arithmetic-coded one to PIL, held to the same
   limits, and frames other than 8-bit SOF0/1/2 rewritten from a
   fixture, which it refuses; a decoder failure,
   `DecoderError`, fails the run) against
   its libjpeg digest — byte-exact on
   libjpeg; on nvJPEG, whose planes C2 upsamples and converts with
   libjpeg's arithmetic, within a sample mean abs difference of 0.089
   levels and 0.0077 a channel (its max difference and share of
   differing values printed); the run fails on another backend.  Then
   `ImageFeaturizer.transform` with phase 4's ResNet-50 over a bytes
   column of 192 JPEGs, 64 per size (phase 4's three shape groups): B1
   launches once per chunk, C2 once per JPEG, nothing else; the features
   are (192,
   2048), finite, within 1e-3 relative L2 of phase 4's uint8 path on the
   same decoded pixels and within 3e-2 of an f32 CPU run of the port on
   12 rows; images/s over 3 runs, bytes and uint8 in turns, with the
   feed's stall_decode_s / transfer_s / compute_s.
5. ViT path: the same transform and table with the zoo's random-init
   ViT-B/16 (seed 0): B4 launches 12 times per chunk, B1 once; the
   features are checked against the same transform with attention forced
   through the plain version on the card and against an f32 CPU run of
   the port on a few images; images/s and one chunk's device time.
6. LM path: greedy `generate` on a random-init GPT-small TransformerLM
   (vocab 8192, embed 768, 12 layers, 12 heads, max_len 1024, bf16),
   batch 8, a 1000-token prompt, 24 new tokens: B4 launches exactly 12
   times (the prefill) and never in the decode steps; the prefill logits
   are checked against a plain-attention prefill on the card and against
   an f32 CPU prefill of a 128-token prompt; prefill ms and decode
   tokens/s.
7. decode serving: `ContinuousBatcher(paged=True)` (64-row pages).
   (a) f32 at GPT-small width with 2 layers, 4 slots, 8 requests of
   16..900-token prompts and 32 new tokens plus 2 over a registered
   256-token prefix, with plain and int8 pools, and the same requests over
   HTTP (`read_stream().continuous_server().generate_stream()`, 4
   concurrent clients): every stream equals `generate()` on the card (a
   mismatch passes only as a tie: top-2 logit gap under 1e-4).  With
   int8 pools the two shared-prefix requests are held against
   `generate`'s machinery with the prefix prefilled alone and the suffix
   fed one step at a time: their suffix attends over the quantized
   prefix rows, where `generate`'s single prefill does not quantize
   (tests/test_torch_batcher.py holds these streams against the JAX
   package's own paged int8 batcher on the CPU).
   (b) the serving configuration: the GPT-small LM of phase 6 (bf16),
   8 slots, the default 129-page pool, 16 requests of 16..900-token
   prompts and 64 new tokens, with bf16 pools (B7) and int8 pools (B8):
   the paged kernel launches exactly 12 times per tick, B4 12 times per
   admission prefill, B1 never; B4's output on every admission prefill
   against its plain version on that launch's own q/k/v; stream lengths,
   first tokens against the prefill's argmax, and teacher-forced
   agreement; B7/B8 against their plain versions on one tick's live
   pools (their recorded times queued behind a spin, beside the
   back-to-back time and the times at chunks of half and twice the
   rule's rows on the same inputs);
   tokens/s, ms per tick and the kernels' share over 3 rounds each.
   Streams are read with a deadline, so a dead batcher loop fails the run
   instead of hanging it.
8. training (the flash backward, B5/B6, is checked in phase 3 against its
   plain version and, through `fused_attention`'s autograd, against
   autograd through `full_attention`, at the LM train layer, a ViT-B/16
   chunk, a ragged f32, a D 32 and a D 128 shape; kernel, plain and SDPA
   backward times beside the bound):
   (a) GPT-small LM training at `bench.py` `_measure_transformer`'s shape
   (vocab 8192, embed 768, 12 layers, 12 heads, max_len 1024, bf16
   compute over f32 state, Adam 3e-4, batch 16, seq 1024): one warm-up
   and 8 timed steps of `make_lm_train_epoch` on one repeated batch; B4,
   B5 and B6 launch exactly 12 times a step; every loss finite and the
   last below the first; every parameter's first-step gradient against
   the same step through `full_attention`; a 2-layer f32 step on the card
   against the same step on the CPU; ms a step, tokens/s, the profiler's
   kernel ms a step with the B4/B5/B6 shares, peak memory, FLOPs a step
   and MFU.
   (b) ResNet-18 CIFAR training at `_measure_train`'s shape (bf16, SGD
   0.1 / 0.9, batch 256, 40 steps of `make_train_epoch` on device data
   from a seed): samples/s; finite losses; no ported kernel launches.
   (c) `DeepVisionClassifier(resnet18).fit` on 2,048 uint8 32x32 images
   of 10 classes learnable from their colours, batch 256, 2 epochs, then
   `DeepVisionModel.transform`: B1 launches once a step and once a
   scoring chunk, exactly; the loss falls; accuracy on the table.
10. image stages and compressed wire (after phase 8, before the record),
   on phase 4's table:
   (a) `Pipeline([ImageTransformer().resize(256, 256).center_crop(224,
   224).blur(2.0, 2.0).flip(), UnrollImage(output_col="features",
   mean/std ImageNet BGR), TorchModel(zoo ResNet-50, fetch_node="pool",
   batch_size=64)])` — example 19's chain at the featurizer's size, the
   ImageNet eval crop: B1 launches exactly 3 times (one per input shape
   group), B2 once (one 224x224 group), nothing else; the kernel rows
   against the `fuse=False` composition on the card within 1 LSB (the
   share of differing pixel values printed); the UnrollImage vectors
   within 1e-6 of B2's plain version; the pooled features finite, (192,
   2048), and within 3e-2 relative L2 of an f32 CPU run of the whole
   pipeline on 4 images (random-BatchNorm weights, as phase 4); images/s
   over 3 runs and the B1 / B2 / rest shares of the profiler's kernel time.
   (b) B2 against its plain version at (192, 224, 224, 3) f32 (timed,
   beside its bound and a stock-op composition) and at a ragged (5, 37,
   53, 1) and (3, 24, 24, 3) with a length-1 mean.
   (c) `DeviceFeed.put_group([rle_encode(c)])` over `tools/feed_bench.py`'s
   default chunks (16 chunks of 16 images, side 224, flat gray 8-pixel
   blocks, seed 0): B3 launches exactly 16 times, every decoded chunk
   equals its raw chunk byte for byte and its f32 mean the plain `put`
   path's; the wire ratio and the host's encode time.  B3 exact to the
   byte on phase 4's 64 uniform-random 224x224 images as one chunk (the
   worst case) and on the JAX package's codec test cases; timed at a
   feed_bench chunk and at the worst case beside its bound (the bytes of
   the runs the chunk needs and of the output) and
   `torch.repeat_interleave`.
11. resumable training and C2 (after phase 10; cuDNN's deterministic
   algorithms from here, cuBLAS's `:4096:8` workspace set at the top):
   (a) ResNet-18 CIFAR (bf16, SGD 0.1 / 0.9, batch 256, 40 steps over 2
   epochs of 5,120 images) through `fit_epochs_resumable` with a
   checkpoint every 10 steps, killed by `fault_point("training.step")`
   at step 25 and resumed: every number of the state equal to the
   uninterrupted run's, bit for bit; a guard drill (`training.loss_nan`
   at step 5: quarantined, rolled back to the floor checkpoint, a finite
   final loss, `quarantine.json` holding the step); the checkpoint's
   bytes and save / restore / verify seconds.
   (b) `DeepVisionClassifier(resnet18, 224x224, batch 64)` on a bytes
   column of the six bench fixtures repeated to 256 rows: 2 epochs, then
   1 and 2 on one `checkpoint_dir`, the resumed fit equal to the
   uninterrupted one bit for bit; B1 once a step and C2 once a row,
   exactly.
   (c) C2 against its plain version, byte for byte, on every colour
   fixture's nvJPEG planes and against the decoder's own pixels; timed
   at one image of each size.
12. persistence and int8 weights (after phase 11, under its cuDNN
   settings):
   (a) each stage saved to a directory under build/, the executor caches
   cleared (they key on `bundle_id`, which a saved bundle keeps),
   loaded, and transformed on the card: phase 4's ResNet-50 `TorchModel`
   over the uint8 table, the ResNet-50 `ImageFeaturizer` over phase 4b's
   JPEG bytes, phase 10's fitted `PipelineModel` and phase 11 (b)'s
   fitted `DeepVisionModel` over its bytes column; each output equal to
   the unsaved stage's bit for bit, with B1, B2 and C2's launches exact;
   the save and load seconds and bytes on disk.
   (b) `ImageFeaturizer` over ViT-B/16 with `quant=True` (bf16 outside
   the int8 layers) on phase 4's table: B1 and B4 as phase 5, four int8
   GEMMs a block a chunk; features correlated > 0.98 with the bf16 ViT's
   on the same weights (tests/test_quant.py's bound) and within 1e-2
   relative L2 of an f32 CPU run of the same quant bundle on 6 images;
   images/s, bf16 and int8 in turns.  Phase 6's GPT-small with
   `quant=True`, prequantized: `generate` (B4 once a layer, 49 int8 GEMMs
   a forward), prefill logits within 5e-2 of an f32 CPU run, eager
   decode tokens/s beside bf16's in turns; then 8 requests through a
   paged `ContinuousBatcher`: every stream finishes, B7 once a layer a
   tick and the int8 GEMMs exact.  `torch._int_mm` timed at the ViT's
   qkv shape (12544 x 768 x 2304) beside a bf16 `torch.matmul`.
13. generation and serving, the rest (after phase 12; its seconds on a
   line of their own):
   (a) the Switch MoE GPT-small (8 experts, capacity 1.25, every block):
   a 2-layer f32 MoE step on the card against the CPU's (phase 8's
   limits); 1 + 3 steps of `make_lm_train_epoch` (bf16 over f32 masters,
   the router kept f32, Adam, batch 16 x 1024): B4/B5/B6 12 a step, the
   warm-up loss its cross-entropy plus 0.01 x the aux term, ms a step,
   tokens/s and MFU on the dense count; the trained model through
   `generate` (batch 8, prompt 1000; B4 12) and a paged batcher (8
   requests; B7 12 a tick, exactly); at EXACT_LM width with capacity
   8.0, f32 `generate` against the naive recompute and the paged
   batcher's streams against `generate()` (ties under TIE_GAP).
   (b) beam search: `num_beams=1` equals `generate()` at EXACT_LM in f32;
   GPT-small bf16, batch 8, prompt 1000, 16 new, 4 beams: B4 12 and no
   paged kernel, each row's summed log-probability (one f32 forward) at
   least greedy's, eos tails frozen, output tokens/s.
   (c) speculative decoding: f32 at EXACT_LM, `speculative_generate` with
   a 1-layer draft and with the target as its own draft
   (ceil((n-1)/(gamma+1)) rounds), and a paged speculative batcher over
   phase 7 (a)'s requests and prefix: every stream `generate()`'s, no
   paged kernel in its ticks, B4 once a layer an admission prefill of
   the target and of the draft; then `tools/mfu_sweep.py`'s
   8_streams_spec (the bf16 GPT-small, its int8 prequantized self-draft,
   gamma 4, 8 slots, paged) on phase 7 (b)'s 16 requests: lengths, first
   tokens, teacher-forced agreement, ticks and tokens a verify, and
   tokens/s and ms a tick beside the plain paged batcher in turns.
   (d) distillation: a 2-layer GPT-small-width student from the bf16
   GPT-small teacher (batch 8 x 1024, 1 + 4 steps): B4 14, B5/B6 2 a step
   (no teacher backward), losses falling, ms a step; the student as the
   draft of an f32 `speculative_generate` at EXACT_LM.
14. the fleet above one server (after phase 13; its seconds on a line of
   their own):
   (a) phase 7 (a)'s f32 requests through a `FleetGateway` over
   `read_stream().distributed_server(replicas=2, registry_url=)` found
   by `sync_registry()`: every stream `generate()`'s (ties aside); then
   the GPT-small LM of phase 6 (bf16) so, 8 slots, 64-row pages: the
   card's bytes grown by starting two replicas at most the one-replica
   query's (one model, one batcher, one set of pools), phase 7 (b)'s 16
   requests posted concurrently through the gateway, every answer 200
   with 64 tokens, B4 once a layer an admission prefill forward and B7
   once a layer a tick, exactly; each stream read as it arrives (more
   than one read a stream through the two hops); the gateway's ms a
   request (its span less the replica's child span); tokens/s through
   the gateway and straight to one replica in turns.
   (c) `/fleet/metrics.json`'s serving and batcher counters and
   histograms against each source's own `/metrics.json`, exactly; a
   client `X-Trace-Id` stitched by `/trace/<id>` into a gateway span
   over a replica child; `/fleet/alerts`' SLO states.
   (b) a rollout between two queries over the same bundle with int8
   pools: v1 behind `distributed_server(replicas=2)`, v2 one replica,
   both under a gateway of their own (fresh per-version latency
   windows); `RolloutController` (canary weight 0.25) promotes v2 on
   `ROLLOUT_METRICS` while clients keep posting, and v1's replicas are
   drained and retired: every answer 200 with 64 tokens, B8 once a layer
   a tick of either version, exactly.
   (d) the featurizer pipeline of tests/test_serving_model.py (base64
   JPEG -> ImageFeaturizer(ResNet-50, 224x224) -> reply) behind
   `DistributedServingServer(replicas=2)` and a gateway, the client a
   Table of the six bench fixtures repeated to 64 rows through
   `SimpleHTTPTransformer(concurrency=8)`: features within 2e-2
   relative L2 of the featurizer run directly on the card, B1 once a
   fixture size a server batch and C2 once a row, exactly; images/s
   through the fleet and direct in turns.
15. the GBDT engine (after phase 14; its seconds on a line of their
   own; no kernel of its own: stock PyTorch scatter-adds, cumsums and
   gathers, as the JAX package's GBDT has no Pallas kernel):
   (a) a HIGGS-shaped table (1,000,000 x 28 f64 from a seed; the label a
   fixed nonlinear rule plus noise) through `GBDTClassifier` at
   LightGBM's defaults for 10 iterations on the card: the root histogram
   against the plain function on the CPU within 1e-4 of the node's mass
   (two card builds compared bit for bit, printed); the first 2
   iterations' trees against a CPU fit of the same data (every split
   call's histogram within 1e-4 of the node's mass, a differing split a
   tie within 1e-5 of the scores its gain sums, reported and steered);
   held-out AUC after 2 iterations within 2e-3 of the CPU fit's;
   `raw_scores_jit` on the card within 1e-4 of `_raw_scores`; the model
   string round trip with identical scores; a second card fit's trees
   against the first's (printed).  Printed: ms an iteration, builds a
   tree, ms a build (CUDA events), rows/s and peak device memory.
   (b) examples/02_hashed_text_gbdt.py's reviews at 50,000 rows through
   `VowpalWabbitFeaturizer(num_bits=18)` into `GBDTClassifier`'s CSR
   path (bins capped by `effective_sparse_max_bin`), 12 iterations:
   train AUC above 0.9, peak device memory below N x 2^18 bytes, the
   root COO histogram against its plain function on the CPU; ms an
   iteration.
16. the classic-ML slice (after phase 15; its seconds on a line of their
   own; no kernel: host numpy featurization and stages, as in the JAX
   package, and the linear learners' plain PyTorch products on the card):
   the host library (`native/src/host.cpp`, g++) builds and its
   `murmur3_batch` equals the Python `murmurhash3_32` over 1M strings
   (both timed); (a) an Adult-shaped table (UCI Adult's 32,561 / 16,281
   split, six numeric columns, eight categoricals with Adult's level
   counts, a string label) through `TrainClassifier()` at its defaults
   on the card, held against the CPU fit (weights within 1e-4 of max |w|,
   scores within 5e-2, the same predictions where the CPU's top
   probability is at least 0.55; the CPU fit's weights scored on the card
   within 1e-3), and a control fit with TF32 on and the learners'
   full-f32 guard bypassed outside the weight limit; scored with `ComputeModelStatistics`, saved, loaded and
   scored again bit for bit; (b) example 21's flight delays at On-Time
   Performance widths, 200,000 rows: the numeric columns through a CSV
   that `read_csv` parses on the host library (equal to np.loadtxt's),
   `CleanMissingData` -> `TrainRegressor()` with the ridge solved in f64
   on the card, weights within 1e-4 of max |w| and predictions within
   1e-8 of max |prediction| of the CPU fit's; (c) example 23's book
   reviews, 20,000, `TextFeaturizer(num_features=4096)` ->
   `LogisticRegression` on the card, held-out accuracy above 0.85.
   Printed for each: the fit's wall time split into host featurization
   and device learner, ms an Adam step (CUDA events) or the ridge's ms,
   rows/s and peak device memory.
17. the rest of classic ML (after phase 16; each part's seconds on a line
   of its own): (a) `ImageFeaturizer` over VGG-16 at 224x224 and 1000
   classes (138M parameters, bf16) on 64 uint8 rows, B1 once a chunk
   exactly, features within 2e-2 of the plain-preprocess run and 3e-2 of
   an f32 CPU run; three `DeepVisionClassifier(vgg16)` steps at batch 32
   and the CIFAR ConvNet on 4,096 CIFAR-shaped rows at SGD 0.005 (the
   net has no BatchNorm and diverges at the default 0.05), accuracy on
   the rows above 0.5 (B1 once a step and a scoring chunk); (b) `SequenceTagger` at its defaults on a
   CoNLL-2003-shaped corpus (14,041 sentences, ~204k tokens, 9 tags),
   and a card fit against a CPU fit of one epoch from one initial state
   (every param within 1e-3 of its tensor's largest); (c) example 23's
   recipe 2: `Word2Vec` at the reference's defaults on phase 16 (c)'s
   reviews into `LogisticRegression`, held-out accuracy above 0.85, ms a
   step; (d) example 20's rows at num_bits 18 (hashed with array
   operations, equal to `VowpalWabbitFeaturizer`'s on the first 20,000)
   through `VowpalWabbitClassifier`: 1,000,000 rows, K1 once a pass,
   K1's pass timed, its floor on a chain of one-slot rows; the first
   20,000 rows against the plain loop on the card (weights within 1e-5
   of max |w|) and two launches bit for bit; a contextual-bandit log of
   100,000 events (K1 once); (e) `KNN(k=5)` over 1,000,000 x 128
   SIFT1M-shaped keys with 10,000 queries, 500 of them against an f64
   top-k on the CPU (a rank may move only within a 1e-5 near-tie), and
   `ConditionalKNN` on example 18; (f) `SAR` (jaccard, support 4) on a
   MovieLens-1M-shaped log, top 10 for every user, against the CPU's fit;
   (g) `IsolationForest` (100 trees x 256) on a 284,807 x 30 table of the
   credit-card-fraud set's shape, scores within 1e-6 of the CPU's;
   (h) example 17's grid (`LogisticRegression`, `GBDTClassifier`, 3-fold
   CV) on a table of the breast-cancer set's shape.  K1 against its plain
   loop is also checked here, and its record is in the kernel list.
18. the explainers, CyberML and the service layer (after phase 17; each
   part's seconds on a line of its own; B1 the only kernel on the path,
   the WLS, lasso and ALS arithmetic stock PyTorch in full f32):
   (a) `ImageLIME` and `ImageSHAP` over `ImageFeaturizer(ResNet-50,
   cut_output_layers=0)` (224x224, 1000 classes, bf16) in a
   `PipelineModel` with a `LambdaTransformer` scoring each image's
   top-class probability, on 4 uint8 images at the defaults (cell size
   16: 196 superpixels from `SuperpixelTransformer`, modifier 130,
   sampling fraction 0.7) and 512 samples an image: 2,048 masked images an
   explainer, B1 once a chunk exactly; the logits and scores within 2e-2
   relative L2 of the same samples through the plain preprocess; LIME's
   f32 WLS on the card against the f64 host solve of the same design and
   targets (coefficients in units of each column's spread and fitted
   values within 1e-3); SHAP's additivity within the bound its 1e6 anchor
   weight gives; SLIC, masking, the model's images/s and the solve's ms.
   (b) example 14's `TabularSHAP` over `GBDTClassifier` (60 iterations, 15
   leaves) on the breast-cancer set's shape, 64 rows x 256 samples,
   additivity against f(background mean) within the anchor bound; then
   `TabularLIME` over phase 16 (a)'s Adult model on its six numeric
   columns, 64 rows x 512 samples, the card's solve against the host's.
   (c) `TextLIME` / `TextSHAP` over phase 16 (c)'s `TextFeaturizer(4096)`
   -> `LogisticRegression` on 32 held-out reviews x 256 samples: the
   solve against the host, additivity, the top token a sentiment word.
   (d) `AccessAnomaly` at its defaults on 4 tenants of 20,000 users x
   8,000 resources x 400,000 distinct accesses (95% within example 12's
   three departments, made with array operations): cross-department
   probes above the most accessed in-department pairs; tenant 0's card fit
   against its CPU fit from the same initial factors (1e-3) and two card
   fits (1e-6 of max |score|, whether bit for bit printed); ms a sweep and
   `ComplementAccessTransformer` on one tenant, timed.
   (e) example 11's pipeline (OCR -> Lambda -> `TextSentiment` ->
   `SimpleHTTPTransformer`) against a mock of the wire protocol on
   127.0.0.1, `write_to_power_bi` to a local server, and
   `generate_wrappers` + `generate_tests` over the 161 stages, the
   generated smoke tests run by pytest in a subprocess that cannot import
   JAX or the JAX package.
19. device telemetry and the model side of distributed (after phase 18,
   in a world-1 nccl group): (a) the compile sentry, the memory gauges,
   the Chrome trace and /metrics over phase 4's featurizer; (b) the
   ring's blocks (B4 + the logsumexp merge) and (c) Ulysses against
   `full_attention`; (d) the 3D trainer's step at GPT-small on
   `MeshPlan(1, 1, 1)` against a single-device step; (e) format-2
   checkpoints; (f) the elastic runtime at world 1.
20. the data side of distributed (after phase 19; its seconds on a line
   of their own; (b)-(e) in a new world-1 nccl group; the bit-for-bit
   checks rely on cuDNN's deterministic algorithms from phase 11 and
   cuBLAS's fixed workspace set at the script's top; a `feed.degraded`
   or `feed.shard_degraded` outside (b)'s injected faults fails the run):
   (a) phase 4's ResNet-50 featurizer over its 192 uint8 images with the
   feed's coalescing at 4 and at 1 chunk a copy (`load_tuned` from a
   temporary file), in turns: features bit for bit, groups and images/s,
   `FeedTelemetry.summarize`; (b) `ShardEngine.put_sharded` on a world-1
   batch sharding of (64, 224, 224, 3) uint8 and f32, read back byte for
   byte, `DTensor.from_local` without a copy (`data_ptr`), one pinned
   staging bucket over 20 fenced puts (GB/s), then
   tools/torch_chaos_soak.py's flow soak with its h2d leg on the card:
   the `feed.shard_put` ladder exhausts, the feed degrades stickily to
   coalesced, every item arrives in order; (c) `ImageFeaturizer(ResNet-50,
   bf16)` through the meshed TorchModel (the mesh `host_local_feed`
   builds), B1 once a chunk, features against the same rows on the
   single-device path and within 2e-2 of the plain-preprocess run,
   images/s in turns; (d) phase 15's HIGGS-shaped fit under
   `data_parallel` on the world-1 mesh (trees equal to phase 15's serial
   card fit, by the tie rule where not bit for bit; ms an iteration and
   the all-reduces' share), `voting_parallel` (top_k 20: every split
   inside its tree's vote, held-out AUC), and example 02's reviews under
   `data_parallel`; (e) phase 17 (d)'s 1,000,000 VW rows through
   `VowpalWabbitClassifier(use_all_reduce=True)`: K1 once a pass, weights
   against `use_all_reduce=False`, the all-reduce's ms a pass.
9. record: a `{"kernels": [...]}` JSON line (the eight TPU kernels, C2
   and K1), the nvidia-smi line, and last the `{"ok": true, "device":
   ...}` line.

Imports nothing of JAX or of the JAX package, and no PIL itself (phase
11 (b) resizes through the port, which uses PIL as the JAX package
does): the images, tokens and weights are made from seeds, the JPEGs
are the committed fixtures.
"""
import contextlib
import json
import re
import math
import os
import shutil
import subprocess
import sys
import time

# phase 11 compares training runs bit for bit: cuBLAS takes a fixed
# workspace (its deterministic setting) before torch initialises it
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

ROOT = os.path.dirname(os.path.abspath(__file__))

# the H100 SXM's published peaks (NVIDIA's data sheet) for the bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

ATOL = 1e-3              # resize kernel vs plain version, normalized units
PLAIN_FEATURES_RTOL = 2e-2   # relative L2, bf16 forward on both sides
CPU_FEATURES_RTOL = 3e-2     # relative L2, bf16 card vs f32 CPU
# attention kernel vs plain version: f32 inputs at f32 rounding; bf16
# inputs round the probabilities to bf16 before PV (unnormalized in the
# kernel, normalized in the plain version), so ~2^-8 relative per term
ATTN_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_ATOL = 1e-4
# the transformer paths, relative L2: kernel vs plain attention, both
# bf16 (only the attention's rounding differs); bf16 on the card vs f32
# on the CPU (bf16 keeps 8 mantissa bits; 12 blocks of bf16 matmuls,
# LayerNorms and residual adds)
VIT_PLAIN_RTOL = 2e-2
VIT_CPU_RTOL = 5e-2
LM_PLAIN_RTOL = 2e-2
LM_CPU_RTOL = 5e-2

# the flash backward (B5/B6) vs its plain version: f32 inputs at f32
# rounding; bf16 inputs round p and ds to bf16 at the same points on both
# sides, but the kernel's p differs in its last f32 bits (exp2, another
# summation order), which can move an element's rounding by one bf16 step
BWD_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
# ... and each output within this relative L2 of the plain version's: the
# max-abs limit is set by the few large entries near the first keys, so a
# kernel off by ~10% on later tiles would pass it alone (observed rel_l2
# ~5e-5 at the LM shape)
BWD_RTOL = 1e-3
# fused_attention's gradients against autograd through full_attention:
# f32 within the JAX package's off-TPU GRAD_TOL; bf16 as relative L2, the
# forwards differing by B4's bf16 rounding of P (unnormalised against
# normalised), under the JAX package's on-chip bf16 GRAD_TOL, 7.5e-2
AUTOGRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the LM train step: every parameter's first-step gradient through the
# kernels against the one through full_attention, relative L2 (bf16 both)
TRAIN_GRAD_RTOL = 5e-2
# a 2-layer f32 LM step on the card against the same step on the CPU
TRAIN_CPU_LOSS_RTOL = 1e-5
TRAIN_CPU_GRAD_RTOL = 1e-4

TIMED_RUNS = 5

# the JPEG path (phase 4b): its features against phase 4's uint8 path on
# the same decoded pixels (the same forward, so only cuDNN's choice of
# algorithm between two calls can differ); nvJPEG against the libjpeg
# digests: with the C2 kernel upsampling and converting nvJPEG's planes by
# libjpeg's arithmetic, only nvJPEG's IDCT differs from libjpeg's, which
# on the fixtures' uniform noise gave a mean absolute difference of
# 0.030-0.059 levels on the digests' pixel sample (max 3) and at most
# 0.0051 a channel on an H100 machine; the limits are 1.5x the worst of
# those (nvJPEG's own chroma path gave 13.1-13.5 and 0.46-0.50)
JPEG_UINT8_RTOL = 1e-3
NVJPEG_SAMPLE_MEAN_ABS = 0.089
NVJPEG_CHANNEL_MEAN = 0.0077

IMG = 224
BATCH = 64
N_IMAGES = 192
SIZES = [(256, 256), (224, 224), (320, 240)]
MEAN_BGR = (103.53, 116.28, 123.675)
STD_BGR = (57.375, 57.12, 58.395)

# GPT-small at bench.py's `_measure_transformer` width (bench.py:538-540)
LM = dict(vocab_size=8192, embed_dim=768, num_layers=12, num_heads=12,
          max_len=1024)
LM_BATCH, LM_PROMPT, LM_NEW = 8, 1000, 24
LM_CPU_PROMPT = 128

# decode serving (phase 7): the paged page size of the JAX package's
# serving default, and the f32 exactness configuration (GPT-small width,
# 2 layers) beside the bf16 serving one (chip_smoke's LM at 12 layers)
PAGE = 64
PAGED_ATOL = 1e-4        # B7/B8 vs plain: both f32 from the same stored values
TIE_GAP = 1e-4           # a token mismatch is a tie only below this top-2 gap
EXACT_LM = dict(LM, num_layers=2)
EXACT_SLOTS, EXACT_REQUESTS, EXACT_NEW, PREFIX_LEN = 4, 8, 32, 256
SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW = 8, 16, 64
STREAM_WAIT_S = 300      # no token for this long fails the run, never hangs it
# the paged kernels' names in a profile: B7's and B8's split and merge
PAGED_KERNEL_NAMES = ("paged_split_kernel", "paged_merge_kernel")

# training (phase 8): bench.py `_measure_transformer` (bench.py:515-549)
# and `_measure_train` (bench.py:129-169)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 16, 1024, 8, 3e-4
CIFAR_BATCH, CIFAR_STEPS = 256, 40
DV_ROWS, DV_CLASSES, DV_BATCH, DV_EPOCHS = 2048, 10, 256, 2
# resumable training (phase 11): the CIFAR configuration through
# fit_epochs_resumable, checkpoints every 10 steps, killed at step 25;
# DeepVisionClassifier at 224x224 on a bytes column of the JPEG fixtures
RESUME_EVERY, RESUME_KILL_AT, RESUME_NAN_AT = 10, 25, 5
DVJ_ROWS, DVJ_BATCH = 256, 64


# image stages and the compressed wire (phase 10): UnrollImage's B2
# against its plain version at the JAX package's own limit (both round
# the same two f32 ops); `tools/feed_bench.py`'s default chunks
UNROLL_ATOL = 1e-6
RLE_CHUNKS, RLE_CHUNK, RLE_SIDE = 16, 16, 224
# timing of B2/B3 (queued_ms): ~10 ms of spin at the H100's ~1.98 GHz
# boost clock, and the idle lead of phase 10's profiled run
SPIN_CYCLES = 20_000_000
PROFILE_LEAD_S = 0.5

# persistence and int8 weights (phase 12): the int8 ViT (bf16 + int8 on
# the card) against an f32 CPU run of the same quant bundle, relative L2;
# its features against the unquantized ViT's, the JAX package's own bound
# (tests/test_quant.py:43-57); the batcher's requests; the GEMM timed
INT8_VIT_CPU_RTOL = 1e-2   # 5.728e-03 on an H100 80GB HBM3, 700.00 W
INT8_CORR = 0.98
INT8_SERVE_REQUESTS, INT8_SERVE_NEW = 8, 32
INT8_GEMM_SHAPE = (BATCH * 196, 768, 2304)

# generation and serving, the rest (phase 13): the Switch MoE at
# Switch-Base-8's expert count and capacity factor in every block; its
# f32 exactness at drop-free capacity; beam search; speculative decoding
# (tools/mfu_sweep.py's 8_streams_spec: gamma 4); distillation
MOE_LM = dict(LM, moe_experts=8, moe_capacity=1.25)
EXACT_MOE_LM = dict(EXACT_LM, moe_experts=8, moe_capacity=8.0)
MOE_TRAIN_STEPS, MOE_SERVE_REQUESTS, MOE_SERVE_NEW, MOE_EXACT_NEW = 3, 8, 32, 16
BEAM_NEW, BEAM_K = 16, 4
SPEC_GAMMA = 4
DISTILL_LAYERS, DISTILL_BATCH, DISTILL_STEPS = 2, 8, 4

# the fleet (phase 14): two replicas behind a gateway; a canary at a
# quarter of the traffic, promoted once 6 canary requests are in band;
# the HTTP client stage's table (the six bench fixtures repeated to 64
# rows, 8 requests in flight) and its features against the direct run
FLEET_REPLICAS = 2
CANARY_WEIGHT, CANARY_MIN = 0.25, 6
# phase 14 (b)'s clients post in rounds of this many requests: with 4 a
# round, a third of the rounds sent the canary none, so about 40% of the
# base's requests ran while the canary's batcher was idle, up to twice as
# fast as any canary request; with 8 (the slot count) a tenth do
ROLLOUT_CLIENTS = SERVE_SLOTS
FLEET_ROWS, FLEET_CONCURRENCY = 64, 8
FLEET_FEATURES_RTOL = 2e-2   # relative L2, bf16 forward on both sides

# the GBDT (phase 15): a HIGGS-shaped table (the UCI HIGGS set's 28
# columns, which LightGBM's own experiments train on) at 1M rows, at
# LightGBM's defaults (31 leaves, max_bin 255, min_data_in_leaf 20, lr
# 0.1); the first iterations against a CPU fit of the same data by the
# tie rule of tests/torch_gbdt_compare.py (every histogram within 1e-4 of
# the node's mass, a differing split a tie within 1e-5 of the scores its
# gain sums); example 02's reviews at 50,000 rows on the CSR path
GBDT_ROWS, GBDT_HOLD, GBDT_FEATURES = 1_000_000, 100_000, 28
GBDT_ITERS, GBDT_CPU_ITERS = 10, 2
GBDT_TEXT_ROWS, GBDT_TEXT_ITERS = 50_000, 12
GBDT_TOL, GBDT_AUC_GAP = 1e-4, 2e-3

# the classic-ML slice (phase 16): MMLSpark's TrainClassifier sample, UCI
# Adult (its 32,561 / 16,281 split, six numeric columns, eight
# categoricals with Adult's level counts, "?" included: 108 features);
# example 21's flight delays at On-Time Performance widths (14 carriers,
# ~300 origin and ~300 destination airports, hashed at 256 dimensions
# each), cut to 200,000 rows for the phase's time; example 23's book
# reviews (hashed TF-IDF at 4,096 dimensions, a 75/25 split)
ADULT_TRAIN, ADULT_TEST = 32_561, 16_281
ADULT_LEVELS = (("workclass", 9, True), ("education", 16, False),
                ("marital-status", 7, False), ("occupation", 15, True),
                ("relationship", 6, False), ("race", 5, False),
                ("sex", 2, False), ("native-country", 42, True))
FLIGHT_ROWS, FLIGHT_CARRIERS, FLIGHT_AIRPORTS = 200_000, 14, 300
REVIEW_ROWS, REVIEW_TRAIN, REVIEW_FEATURES = 20_000, 15_000, 4096
REVIEW_STEPS, REVIEW_ACC = 150, 0.85
MURMUR_STRINGS = 1_000_000
# the card's fit against the CPU's (f32 Adam: its scale-free step turns
# rounding in a near-zero gradient into a step of up to lr, and Adult's
# raw columns, fnlwgt near 1e5, give logits in the thousands): weights
# within this of max |w|, scores within this, and the same predictions
# where the CPU's top probability is at least LR_FAR; the same weights on
# both devices within LR_SAME_ATOL (f32 products in another order);
# the f64 ridge: weights within this of max |w| (the one-hot and hashed
# blocks each sum to the intercept, a null space the 1e-6 ridge alone
# pins) and predictions within this of max |prediction|.  The weight
# limits are those of tests/test_torch_cuda.py's card fits; phase 16 (a)
# also fits with TF32 on and the learners' full-f32 guard bypassed, a
# control that must miss LR_W_RTOL
LR_W_RTOL, LR_SCORE_ATOL, LR_FAR, LR_SAME_ATOL = 1e-4, 5e-2, 0.55, 1e-3
RIDGE_W_RTOL, RIDGE_PRED_RTOL = 1e-4, 1e-8

# the rest of classic ML (phase 17), at published widths on data made from
# seeds: (a) VGG-16 at ImageNet's 224x224 and 1000 classes (138M
# parameters), a few DeepVisionClassifier steps at batch 32 (lr 1e-3: the
# net has no BatchNorm), and the CIFAR ConvNet on CIFAR-shaped rows; (b)
# SequenceTagger at its defaults on a CoNLL-2003-shaped corpus (14,041
# training and 3,250 held-out sentences, 23,623 words, 9 tags), its card
# fit against a CPU fit of one epoch on a prefix from one initial state
# (params within TAGGER_TOL of each tensor's largest); (c) Word2Vec at the
# reference's defaults on phase 16 (c)'s reviews (example 23's recipe 2,
# the example's accuracy limit); (d) example 20's rows at num_bits 18:
# 1,000,000 for K1's time and a 20,000-row prefix against its plain loop
# (weights within K1_W_RTOL of max |w|), and a contextual-bandit log of
# 100,000 events; (e) KNN over SIFT1M's shape, 500 queries against an f64
# top-k on the CPU (a rank may move only within a KNN_TIE_RTOL near-tie);
# (f) SAR on MovieLens-1M's shape; (g) IsolationForest on the
# credit-card-fraud set's shape; (h) example 17's grid on a table of the
# breast-cancer set's shape
VGG_ROWS, VGG_BATCH, VGG_CPU_ROWS = 64, 32, 4
VGG_TRAIN_ROWS, VGG_CLASSES, VGG_LR = 96, 10, 1e-3
CIFAR_ROWS, CIFAR_CLASSES, CIFAR_BATCH = 4096, 10, 64
# the ConvNet has no BatchNorm: at the classifier's default SGD 0.05 its
# loss went to NaN within one epoch of these rows, on the card as in the
# JAX package on the CPU; at 0.005 it fits them
CIFAR_LR, CIFAR_ACC = 0.005, 0.5
CONLL_TRAIN, CONLL_TEST, CONLL_VOCAB = 14_041, 3_250, 23_623
CONLL_CPU_ROWS, TAGGER_TOL = 2_000, 1e-3
W2V_ACC = 0.85
VW_ROWS, VW_PREFIX, VW_BITS, VW_PASSES, CB_EVENTS = (1_000_000, 20_000, 18,
                                                     2, 100_000)
K1_W_RTOL = 1e-5
KNN_KEYS, KNN_DIM, KNN_QUERIES, KNN_K, KNN_CHECK = (1_000_000, 128, 10_000,
                                                    5, 500)
KNN_TIE_RTOL = 1e-5
ML_USERS, ML_ITEMS, ML_EVENTS, SAR_K = 6_040, 3_706, 1_000_209, 10
IFOREST_ROWS, IFOREST_COLS, IFOREST_FRAUD = 284_807, 30, 492
IFOREST_CPU_ROWS = 20_000
BREAST_ROWS, BREAST_COLS = 569, 30

# the explainers, CyberML and the service layer (phase 18): (a) ImageLIME
# and ImageSHAP over ResNet-50 at 224x224 and 1000 classes on 4 uint8
# images at the defaults (cell size 16: 196 superpixels; modifier 130;
# sampling fraction 0.7) with 512 samples an image, so that the design is
# over-determined (s ~ 2.6 d), at the featurizer's batch of 64; (b)
# example 14's TabularSHAP over GBDTClassifier on the breast-cancer set's
# shape (64 rows, 256 samples) and TabularLIME over phase 16 (a)'s Adult
# model on its six numeric columns (64 rows, 512 samples); (c) TextLIME /
# TextSHAP over phase 16 (c)'s review model (32 reviews, 256 samples); (d)
# AccessAnomaly at its defaults on 4 tenants of 20,000 users x 8,000
# resources x 400,000 distinct accesses, 95% within the user's department
# (example 12's three)
EXPLAIN_IMAGES, EXPLAIN_SAMPLES, EXPLAIN_BATCH = 4, 512, 64
EXPLAIN_ROWS, TAB_SHAP_SAMPLES, TAB_LIME_SAMPLES = 64, 256, 512
TEXT_ROWS, TEXT_SAMPLES = 32, 256
# a LIME solve on the card (f32) against the host's f64 solve of the same
# design and targets: coefficients in units of each design column's
# spread within this of the largest, fitted values within this of the
# targets' range
SOLVE_RTOL = 1e-3
SHAP_ANCHOR = 1e6  # explainers/base.shapley_kernel_weights' anchor weight
AA_TENANTS, AA_USERS, AA_RES, AA_PAIRS, AA_DEPTS = (4, 20_000, 8_000,
                                                    400_000, 3)
# a tenant's card fit against its CPU fit from the same initial factors
# (scores, absolute), and two card fits (of max |score|)
AA_CPU_ATOL, AA_REPEAT_RTOL = 1e-3, 1e-6

# phase 19: the device its distributed paths run on (nccl for cuda), the
# featurizer's new chunk (P19_FEW images), the ring's blocks and the
# bf16 tolerance of tests/test_sequence_parallel.py, Ulysses' shape, and
# the 3D step's tokens [A, M, mb, S] at GPT-small's width (bf16, SGD),
# held against one single-device step over the same 16 rows: the loss
# (relative) and the parameter updates (relative L2; TRAIN_GRAD_RTOL)
P19_DEVICE = "cuda"
P19_FEW = 10
RING_SHAPE, RING_BLOCKS, RING_ATOL = (1, 8192, 12, 64), 8, 0.02
ULY_SHAPE = (2, 2048, 12, 64)
P3D_A, P3D_M, P3D_MB, P3D_SEQ, P3D_STEPS, P3D_LR = 2, 2, 4, 1024, 3, 0.1
P3D_LOSS_RTOL, P3D_UPDATE_RTOL = 1e-2, 5e-2

# every kernel's wrapper counter, by the name the record line gives it
KERNELS = ("affine_resample", "flash_attention_fwd", "paged_decode_attention",
           "paged_decode_attention_int8", "flash_attention_bwd_dkdv",
           "flash_attention_bwd_dq", "fused_normalize_unroll", "rle_decode",
           "ycc_to_bgr", "online_pass")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)


def zero_launches() -> None:
    """Set every kernel's launch count to 0 (C2's counter lives in the
    decoder library)."""
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.ops import attention_kernels as A
    from mmlspark_tpu_torch.ops import image_kernels as K
    from mmlspark_tpu_torch.ops import online_pass as OP
    from mmlspark_tpu_torch.ops import paged_attention as PA
    from mmlspark_tpu_torch.ops import wire_codec as W

    K.LAUNCHES = A.LAUNCHES = PA.LAUNCHES = PA.LAUNCHES_INT8 = 0
    A.LAUNCHES_BWD_DKDV = A.LAUNCHES_BWD_DQ = 0
    K.LAUNCHES_UNROLL = W.LAUNCHES = OP.LAUNCHES = 0
    native.reset_ycc_launches()


def read_launches() -> dict:
    """{kernel name: launches since zero_launches()}."""
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.ops import attention_kernels as A
    from mmlspark_tpu_torch.ops import image_kernels as K
    from mmlspark_tpu_torch.ops import online_pass as OP
    from mmlspark_tpu_torch.ops import paged_attention as PA
    from mmlspark_tpu_torch.ops import wire_codec as W

    return dict(zip(KERNELS, (K.LAUNCHES, A.LAUNCHES, PA.LAUNCHES,
                              PA.LAUNCHES_INT8, A.LAUNCHES_BWD_DKDV,
                              A.LAUNCHES_BWD_DQ, K.LAUNCHES_UNROLL,
                              W.LAUNCHES, native.ycc_launches(),
                              OP.LAUNCHES)))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events around the run, after a warm-up)."""
    import torch

    for _ in range(3):
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


def resample_bound(plan, batch) -> tuple:
    """(bound_ms, bound_by) of one affine resample: the bytes it must move
    at the HBM rate (the batch read once, the f32 output written once, and
    of the weights only the non-zero taps and their ranges), against the
    f32 operations these taps need at the f32 peak."""
    import numpy as np

    ny = (plan.y_rng[:, 1] - plan.y_rng[:, 0]).astype(np.float64)
    nx = (plan.x_rng[:, 1] - plan.x_rng[:, 0]).astype(np.float64)
    b, ci, co = batch.shape[0], plan.c_in, plan.c_out
    flops = b * (ny.sum() * nx.sum() * 2 * ci        # width taps
                 + ny.sum() * plan.w_out * 2 * ci    # height taps
                 + plan.h_out * plan.w_out * co * (2 * ci + 2))  # mix + norm
    taps = (ny.sum() + nx.sum()) * 4 + plan.y_rng.nbytes + plan.x_rng.nbytes
    epilogue = plan.cmix.nbytes + plan.mean_eff.nbytes + plan.inv_eff.nbytes
    nbytes = (batch.numel() * batch.element_size() + taps + epilogue
              + b * plan.h_out * plan.w_out * co * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_resample(K, shape, dtype, seed, out_hw=(IMG, IMG), plan=None,
                   timed=True):
    """B1 on both routes against its plain version at one shape: the
    rule's route (`plan.tiling`) through the wrapper, and the pixel route
    on the same inputs; resized to out_hw and normalised with the
    ImageNet BGR mean/std, or by `plan`.  With `timed`, the kernel's time
    queued behind a spin (the record), back to back, and the pixel
    route's, beside the plain version, the library call and the bound."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == "uint8":
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                          generator=gen)
    else:
        x = torch.rand(shape, device="cuda", generator=gen) * 255.0
    c = shape[3]
    mean, std = (MEAN_BGR * 2)[:c], (STD_BGR * 2)[:c]  # an RGBA's 4th too
    resize = plan is None
    if resize:
        plan = K.resize_plan(shape[1], shape[2], c, *out_hw, mean, std)
    ty, span = plan.tiling(x.dtype, shape[0])
    route = f"tile TY {ty} span {span}" if ty else "pixel"
    if ty:
        smem = plan.tile_smem(span, x.element_size(), ty)
        c_smem = K._kernel_lib().mmk_affine_resample_smem(
            plan.w_in, plan.c_in, x.element_size(), plan.w_out, plan.c_out,
            ty, plan.k_h, span)
        if c_smem != smem or smem > K.TILE_SMEM:
            fail(f"resample {shape}: the tile route's shared memory is "
                 f"{c_smem} B in the kernel, {smem} B by the plan's rule "
                 f"(limit {K.TILE_SMEM})")
        route += f" smem {smem} B"
    got = K.affine_resample(x, plan)
    pixel = K._launch(x, plan, 0, 0)
    ref = K.affine_resample_plain(x, plan)
    torch.cuda.synchronize()
    label = (f"affine_resample {dtype}{list(shape)} -> "
             f"{plan.h_out}x{plan.w_out}x{plan.c_out}")
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{label}: bad output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    pixel_err = float((pixel - ref).abs().max())
    if max(err, pixel_err) > ATOL:
        fail(f"{label}: kernel disagrees with plain version (max abs err "
             f"{err:.3e}, pixel route {pixel_err:.3e} > {ATOL})")
    if not timed:
        log(f"[kernel] {label} ({route}): max_abs_err={err:.3e}, pixel "
            f"route {pixel_err:.3e} (limit {ATOL})")
        return {"err": max(err, pixel_err)}
    mean_t = torch.tensor(mean, device="cuda").view(1, c, 1, 1)
    inv_t = 1.0 / torch.tensor(std, device="cuda").view(1, c, 1, 1)

    def library():
        y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=out_hw,
                          mode="bilinear", align_corners=False, antialias=True)
        return (y - mean_t) * inv_t

    lib_err = float((library().permute(0, 2, 3, 1) - ref).abs().max())

    def call():
        return K.affine_resample(x, plan)

    b2b_ms = cuda_ms(call, 20)
    kernel_ms = queued_ms(call)
    pixel_ms = queued_ms(lambda: K._launch(x, plan, 0, 0))
    plain_ms = cuda_ms(lambda: K.affine_resample_plain(x, plan), 5)
    library_ms = cuda_ms(library, 20)
    bound_ms, bound_by = resample_bound(plan, x)
    log(f"[kernel] {label} ({route}): max_abs_err={err:.3e}, pixel route "
        f"{pixel_err:.3e} (limit {ATOL}) kernel_ms={kernel_ms:.4f} (queued "
        f"behind a spin; back-to-back calls {b2b_ms:.4f}; the pixel route "
        f"queued {pixel_ms:.4f}) plain_ms={plain_ms:.4f} library_ms="
        f"{library_ms:.4f} (library agrees: {lib_err <= ATOL}, max_abs_err="
        f"{lib_err:.3e}) bound_ms={bound_ms:.4f} ({bound_by}) "
        f"roofline_share={bound_ms / kernel_ms:.3f}")
    return {"err": max(err, pixel_err), "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms if lib_err <= ATOL else None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def attention_bound(shape, dtype: str, causal: bool) -> tuple:
    """(bound_ms, bound_by) of one flash-attention forward: q, k and v
    read once in their dtype plus O (f32) and the logsumexp written once,
    at the HBM rate, against 4*B*H*S*S*D operations (times (S+1)/(2S)
    under the causal mask: the visible half) at the peak rate of the
    inputs' type (bf16 tensor cores, or f32 outside them)."""
    b, s, h, d = shape
    item = 2 if dtype == "bfloat16" else 4
    nbytes = 3 * b * s * h * d * item + b * s * h * d * 4 + b * h * s * 4
    ops = 4.0 * b * h * s * s * d * ((s + 1) / (2 * s) if causal else 1.0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_attention(A, shape, dtype: str, causal: bool, seed: int):
    """Kernel vs plain (and SDPA as the library yardstick) at one shape."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(
        getattr(torch, dtype)) for _ in range(3))
    out, lse = A.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"attention {shape}: bad output {tuple(out.shape)}")
    err = float((out - ref).abs().max())
    lse_err = float((lse - ref_lse).abs().max())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    lib_err = float((library().transpose(1, 2).float() - ref).abs().max())
    # the kernel's time is the device's, from calls queued behind a spin:
    # at ~0.06 ms a call the wrapper's host work (checks, allocations,
    # three tensor maps) can outlast the kernel in back-to-back calls,
    # whose time is logged beside it
    b2b_ms = cuda_ms(lambda: A.flash_attention_fwd(q, k, v, causal), 20)
    kernel_ms = queued_ms(lambda: A.flash_attention_fwd(q, k, v, causal))
    plain_ms = cuda_ms(lambda: A.flash_attention_fwd_plain(q, k, v, causal), 5)
    library_ms = cuda_ms(library, 20)
    bound_ms, bound_by = attention_bound(shape, dtype, causal)
    b, s, h, d = shape
    tflops = (4.0 * b * h * s * s * d * ((s + 1) / (2 * s) if causal else 1.0)
              / (kernel_ms * 1e-3) / 1e12)
    log(f"[kernel] flash_attention_fwd {dtype}{list(shape)} "
        f"causal={causal}: max_abs_err={err:.3e} (limit {ATTN_ATOL[dtype]}) "
        f"lse_err={lse_err:.3e} (limit {LSE_ATOL}) kernel_ms={kernel_ms:.4f} "
        f"(queued behind a spin; back-to-back calls {b2b_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (SDPA, "
        f"max_abs_err vs plain {lib_err:.3e}) bound_ms={bound_ms:.4f} "
        f"({bound_by}) roofline_share={bound_ms / kernel_ms:.3f} "
        f"achieved {tflops:.1f} TFLOP/s")
    if err > ATTN_ATOL[dtype] or lse_err > LSE_ATOL:
        fail(f"attention {shape}: kernel disagrees with plain version "
             f"(max abs err {err:.3e}, lse {lse_err:.3e})")
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def attention_bwd_bound(shape, dtype: str, causal: bool, which: str
                        ) -> tuple:
    """(bound_ms, bound_by) of one flash-backward kernel: q, k, v and dO
    read once in their dtype, lse and delta (f32) read once, and its f32
    outputs (B5: dK and dV; B6: dQ) written once, at the HBM rate, against
    its operations on the visible (query, key) pairs — B5 8*D a pair (QK,
    dO V, P dO, dS Q), B6 6*D (QK, dO V, dS K) — at the peak rate of the
    inputs' type."""
    b, s, h, d = shape
    item = 2 if dtype == "bfloat16" else 4
    n_out = 2 if which == "dkdv" else 1
    nbytes = (4 * b * s * h * d * item + 2 * b * h * s * 4
              + n_out * b * s * h * d * 4)
    pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
    ops = (8.0 if which == "dkdv" else 6.0) * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_attention_bwd(A, shape, dtype: str, causal: bool, seed: int,
                        timed: bool = False):
    """B5 and B6 against their plain versions on one shape's q, k, v, dO
    and the forward's lse and delta; `fused_attention`'s autograd
    gradients against autograd through `full_attention`; with `timed`,
    kernel, plain and SDPA-backward times (CUDA events) and the bounds.
    Returns {"dkdv": row, "dq": row}."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.parallel.ring_attention import full_attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(tdt)
                   for _ in range(4))
    b, s, h, d = shape
    out, lse = A.flash_attention_fwd(q, k, v, causal)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), out).reshape(
        b * h, s).contiguous()
    got = A.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal) + (
        A.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),)
    ref = A.flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal) + (
        A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal),)
    torch.cuda.synchronize()
    errs, rels = {}, {}
    for name, g, r in zip(("dk", "dv", "dq"), got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"attention backward {shape}: bad {name} {tuple(g.shape)}")
        errs[name] = float((g - r).abs().max())
        # relative L2 over a norm of at least 1: a gradient that is ~0
        # (dK and dQ at S = 1) is held in absolute terms
        rels[name] = float((g - r).norm() / r.norm().clamp(min=1.0))
    del got, ref
    # autograd: fused_attention (B4 forward, B5/B6 backward) against
    # autograd through the dense full_attention, same inputs and dO
    grads = []
    for fn in (A.fused_attention, full_attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, causal), leaves,
                                         do.float()))
    if dtype == "float32":
        ag_err = max(float((x - y).abs().max()) for x, y in zip(*grads))
    else:
        ag_err = max(float((x.float() - y.float()).norm() / y.float().norm())
                     for x, y in zip(*grads))
    del grads
    kind = "max_abs" if dtype == "float32" else "rel_l2"
    err = max(errs.values())
    log(f"[kernel] flash_attention_bwd {dtype}{list(shape)} causal={causal}: "
        f"B5 dk max_abs_err={errs['dk']:.3e} dv={errs['dv']:.3e}, B6 dq "
        f"max_abs_err={errs['dq']:.3e} (limit {BWD_ATOL[dtype]}); rel_l2 "
        f"dk={rels['dk']:.3e} dv={rels['dv']:.3e} dq={rels['dq']:.3e} "
        f"(limit {BWD_RTOL}); "
        f"fused_attention grads vs autograd through full_attention "
        f"{kind}={ag_err:.3e} (limit {AUTOGRAD_TOL[dtype]})")
    if err > BWD_ATOL[dtype] or max(rels.values()) > BWD_RTOL:
        fail(f"attention backward {shape}: kernels disagree with the plain "
             f"versions (max abs {errs}, rel_l2 {rels})")
    if ag_err > AUTOGRAD_TOL[dtype]:
        fail(f"attention backward {shape}: fused_attention's gradients "
             f"disagree with full_attention's ({kind} {ag_err:.3e})")
    rows = {"dkdv": {"err": max(errs["dk"], errs["dv"])},
            "dq": {"err": errs["dq"]}}
    if not timed:
        return rows
    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    g_lib = do.transpose(1, 2)

    def library():
        # dQ, dK and dV together: the work of B5 and B6
        return torch.autograd.grad(lib_out, (qt, kt, vt), g_lib,
                                   retain_graph=True)

    library_ms = cuda_ms(library, 20)
    kernels = {
        "dkdv": (lambda: A.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                    causal),
                 lambda: A.flash_attention_bwd_dkdv_plain(q, k, v, do, lse,
                                                          delta, causal)),
        "dq": (lambda: A.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                causal),
               lambda: A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                      causal))}
    for which, (kern, plain) in kernels.items():
        # B6 on the device alone (queued behind a spin), as B4; B5 back to
        # back, as in its earlier records
        b2b_ms = cuda_ms(kern, 20)
        kernel_ms = queued_ms(kern) if which == "dq" else b2b_ms
        plain_ms = cuda_ms(plain, 5)
        bound_ms, bound_by = attention_bwd_bound(shape, dtype, causal, which)
        rows[which].update(ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
        tflops = ((8.0 if which == "dkdv" else 6.0) * d * pairs
                  / (kernel_ms * 1e-3) / 1e12)
        timing = ("queued behind a spin; back-to-back calls "
                  f"{b2b_ms:.4f}" if which == "dq" else "back-to-back calls")
        log(f"[kernel] flash_attention_bwd_{which} {dtype}{list(shape)} "
            f"causal={causal}: kernel_ms={kernel_ms:.4f} ({timing}) plain_ms="
            f"{plain_ms:.4f} library_ms={library_ms:.4f} (the backward of "
            f"SDPA: dQ, dK and dV together) bound_ms={bound_ms:.4f} "
            f"({bound_by}) roofline_share={bound_ms / kernel_ms:.3f} "
            f"achieved {tflops:.1f} TFLOP/s")
    del lib_out, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def graph_ms(forward, x, iters: int) -> tuple:
    """Device time of one forward(x), from replays of a CUDA graph of it
    (no host dispatch between kernels), and the largest gap between the
    graph's output and an eager call's, relative to the output's scale."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            forward(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = forward(x)
    ms = cuda_ms(graph.replay, iters)
    eager = forward(x)
    torch.cuda.synchronize()
    gap = float((out - eager).abs().max() / eager.abs().max())
    return ms, gap


def profiled_kernel_ms(fn, names):
    """(compute-kernel ms, {name: ms of the kernels whose name holds it},
    wall ms) of one fn() under torch.profiler: the device time of every
    kernel (copies and memsets left out: they run on the feed's side
    stream and overlap), or None if the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    total_us = 0.0
    by_name = {n: 0.0 for n in names}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or \
                ev.key.startswith(("Memcpy", "Memset")):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        total_us += us
        for n in names:
            if n in ev.key:
                by_name[n] += us
    if total_us <= 0:
        return None
    return total_us / 1e3, {n: us / 1e3 for n, us in by_name.items()}, wall_ms


def device_events_us(prof, names, copies: bool):
    """(device us, {name: (us, count) of the kernels whose name holds
    it}) summed over a profile's raw device events; copies and memsets
    only with `copies`."""
    from torch.autograd import DeviceType

    total_us = 0.0
    by_name = {n: [0.0, 0] for n in names}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or (
                not copies and ev.name.startswith(("Memcpy", "Memset"))):
            continue
        us = ev.time_range.elapsed_us()
        total_us += us
        for n in names:
            if n in ev.name:
                by_name[n][0] += us
                by_name[n][1] += 1
    return total_us, by_name


def queued_ms(fn, iters: int = 20) -> float:
    """Device time of one fn() call: CUDA events around `iters` calls that
    the host enqueues while a spin kernel (~10 ms) holds the card, so the
    card runs them back to back.  Plain back-to-back events (cuda_ms) also
    count the host's launch cost when a call's host work outlasts its
    kernels — a microsecond kernel behind a Python wrapper."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_end = torch.cuda.Event(enable_timing=True)
    spin_start = torch.cuda.Event(enable_timing=True)
    spin_start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    spin_end.record()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = spin_start.elapsed_time(spin_end)
    if host_ms >= spin_ms:
        log(f"[timing] the host took {host_ms:.3f} ms to enqueue {iters} "
            f"calls, past the {spin_ms:.3f} ms spin: the time below "
            f"includes host gaps")
    return start.elapsed_time(end) / iters


def rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def timed_transforms(featurizer, table, label, card, n_runs=TIMED_RUNS):
    """images/s on the host's clock, as a range over repeated runs (a run
    is tens of ms on a shared host), with the feed's split of the median;
    returns the median wall in seconds."""
    import torch
    from mmlspark_tpu_torch.io.feed import FEED_TELEMETRY

    runs = []
    for _ in range(n_runs):
        torch.cuda.synchronize()
        before = FEED_TELEMETRY.snapshot()
        t0 = time.perf_counter()
        featurizer.transform(table)
        runs.append((time.perf_counter() - t0, FEED_TELEMETRY.delta(before)))
    runs.sort(key=lambda r: r[0])
    walls = [r[0] for r in runs]
    med_wall, med_feed = runs[len(runs) // 2]
    log(f"[{label}] ImageFeaturizer pool {IMG}x{IMG} batch {BATCH}, "
        f"{N_IMAGES} images, {n_runs} runs: images/s min "
        f"{N_IMAGES / walls[-1]:.0f}, median {N_IMAGES / med_wall:.0f}, "
        f"max {N_IMAGES / walls[0]:.0f} (walls {walls[0]:.4f}-{walls[-1]:.4f}"
        f" s) on {card}")
    log(f"[{label}] median run's feed: " + " ".join(
        f"{k}={med_feed[k]:.4f}" for k in (
            "wall_s", "stall_decode_s", "transfer_s", "compute_s",
            "stall_drain_s")))
    return med_wall


def chunk_device_time(featurizer, bundle, label, n_chunks, med_wall):
    """One chunk's device work (B1 at identity size + the backbone's bf16
    forward): from a CUDA-graph replay, which has no dispatch gaps, and
    the eager stream span, which includes them."""
    import torch

    _module, forward = featurizer._model_for(bundle, "image")._executor(
        bundle, "pool", torch.device("cuda"))
    x224 = torch.randint(0, 256, (BATCH, IMG, IMG, 3), dtype=torch.uint8,
                         device="cuda")
    span_ms = cuda_ms(lambda: forward(x224), 10)
    dev_ms, gap = graph_ms(forward, x224, 20)
    log(f"[{label}] one chunk (B1 + {bundle.builder} bf16, batch {BATCH}): "
        f"device time {dev_ms:.3f} ms (CUDA-graph replay; graph vs eager "
        f"output gap {gap:.1e}) = {BATCH / dev_ms * 1e3:.0f} images/s; eager "
        f"stream span incl. dispatch gaps {span_ms:.3f} ms; x{n_chunks} "
        f"chunks of device time = {n_chunks * dev_ms / (med_wall * 1e3):.3f}"
        f" of the median run's wall")
    if gap > 1e-2:
        fail(f"the CUDA graph's output differs from the eager forward's "
             f"(relative gap {gap:.1e})")


def profile_run(fn, label, names, med_wall_s):
    busy = profiled_kernel_ms(fn, names)
    if busy is None:
        log(f"[{label}] profiled run: the profiler saw no device time "
            "(device busy share not measured)")
        return
    total_ms, by_name, wall_ms = busy
    shares = " ".join(f"{n} {ms:.4f} ms ({ms / total_ms:.4f})"
                      for n, ms in by_name.items())
    log(f"[{label}] profiled run: compute kernels {total_ms:.3f} ms on the "
        f"device, of which {shares}; the profiled run's wall {wall_ms:.3f}"
        f" ms; kernels / median unprofiled wall = "
        f"{total_ms / (med_wall_s * 1e3):.3f}")


def plain_preprocess(K):
    """The featurizers' preprocess (224x224, ImageNet BGR mean and std)
    with B1's plain version, on the card."""
    from mmlspark_tpu_torch.models.torch_model import ImagePreprocess

    class PlainPreprocess(ImagePreprocess):
        @property
        def key(self):
            return ("plain",) + super().key

        def __call__(self, batch):
            batch = self.fix_channels(batch)
            mean, std = self.mean_std(batch.shape[-1])
            plan = K.resize_plan(*batch.shape[1:], self.height, self.width,
                                 tuple(mean), tuple(std))
            return K.affine_resample_plain(batch, plan)

    return PlainPreprocess(IMG, IMG, MEAN_BGR, STD_BGR)


def resnet_path(K, A, images, table, repo, n_chunks, card):
    """Phase 4; returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                                  init_state_dict)
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet

    t0 = time.perf_counter()
    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    log(f"[resnet] zoo resnet50 ready in {time.perf_counter() - t0:.2f} s")
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH)

    zero_launches()
    t0 = time.perf_counter()
    out = featurizer.transform(table)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    feats = out["features"]
    log(f"[resnet] first transform {first_s:.3f} s; launches {launches} "
        f"(chunks={n_chunks})")
    if launches != dict(NO_LAUNCHES, affine_resample=n_chunks):
        fail(f"the ResNet path launched the kernels {launches} times, "
             f"expected affine_resample once per chunk ({n_chunks})")
    if feats.shape != (N_IMAGES, 2048) or not np.isfinite(feats).all():
        fail(f"features: shape {feats.shape}, finite={np.isfinite(feats).all()}")
    if not (out["id"] == np.arange(N_IMAGES)).all():
        fail("row order changed")

    plain_model = featurizer._model_for(bundle, "image")
    plain_model.set(preprocess=plain_preprocess(K))
    plain_feats = plain_model.transform(table)["features"]
    err_plain = rel_l2(feats, plain_feats)
    log(f"[resnet] features vs plain-preprocess run: rel_l2={err_plain:.3e} "
        f"(bound {PLAIN_FEATURES_RTOL})")
    if err_plain > PLAIN_FEATURES_RTOL:
        fail("features disagree with the plain-preprocess run")

    # The card's bf16 forward against an f32 CPU run of the port, on
    # weights whose BatchNorms are all random: under the zoo's flax-style
    # init every residual branch is 0, and only the stem and the
    # projection convs would be checked.
    few = [i for s in range(len(SIZES)) for i in range(s, 12, len(SIZES))]
    few_table = Table({"image": [images[i] for i in few]})
    check_state = init_state_dict(get_builder("resnet50")(num_classes=1000),
                                  seed=1, random_bn=True)
    side_feats = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        check_bundle = TorchBundle("resnet50", {"num_classes": 1000},
                                   state_dict=check_state,
                                   input_shape=(IMG, IMG, 3), dtype=dtype)
        side_feats[dev] = ImageFeaturizer(
            bundle=check_bundle, batch_size=BATCH,
            device=dev).transform(few_table)["features"]
    err_cpu = rel_l2(side_feats["cuda"], side_feats["cpu"])
    log(f"[resnet] features (random-BatchNorm ResNet-50, bf16 on the card) "
        f"vs an f32 CPU run of {len(few)} images: rel_l2={err_cpu:.3e} "
        f"(bound {CPU_FEATURES_RTOL})")
    if err_cpu > CPU_FEATURES_RTOL:
        fail("features disagree with the f32 CPU run")

    med_wall = timed_transforms(featurizer, table, "resnet", card)
    chunk_device_time(featurizer, bundle, "resnet", n_chunks, med_wall)
    profile_run(lambda: featurizer.transform(table), "resnet",
                ["affine_resample"], med_wall)
    del featurizer, plain_model
    torch.cuda.empty_cache()
    return launches


def jpeg_fixtures():
    """({file name: bytes}, digests) of tests/jpeg_fixtures/: JPEGs made by
    bench.py's recipe (uniform noise, quality 85) and the libjpeg digests
    of their pixels (make_jpeg_fixtures.py)."""
    d = os.path.join(ROOT, "tests", "jpeg_fixtures")
    with open(os.path.join(d, "digests.json")) as f:
        digests = json.load(f)
    blobs = {}
    for name in digests["fixtures"]:
        with open(os.path.join(d, name), "rb") as f:
            blobs[name] = f.read()
    return blobs, digests


def check_jpeg_decoder(native, blobs, digests):
    """Every fixture's pixels against its libjpeg digest: byte-exact on
    the libjpeg backend, within the stated difference on nvJPEG; returns
    {size: [decoded arrays of the bench fixtures of that size]}."""
    import base64
    import hashlib

    import numpy as np

    backend = native.jpeg_backend()
    stride = digests["sample_stride"]
    by_size = {}
    worst = {"max": 0, "mean": 0.0, "channel": 0.0}
    for name, want in sorted(digests["fixtures"].items()):
        t0 = time.perf_counter()
        # a DecoderError (the decoder failing, not refusing) ends the run
        got = native.decode_jpeg_bgr(blobs[name])
        dt_ms = (time.perf_counter() - t0) * 1e3
        if want is None:  # CMYK: the decoder refuses it (PIL decodes it)
            if got is not None:
                fail(f"jpeg {name}: decoded a stream libjpeg refuses")
            log(f"[jpeg] {name}: refused, as libjpeg refuses it")
            continue
        route = backend
        if got is None and backend == "nvjpeg" and \
                name.startswith(("progressive_restart_", "arith_")):
            # nvJPEG refuses a progressive stream with restart markers
            # (fault C3) and an arithmetic-coded one (SOF9), which go to
            # PIL, as io.image.decode_image sends them
            from mmlspark_tpu_torch.io.image import (decode_image,
                                                     image_row_to_array)

            got, route = image_row_to_array(decode_image(blobs[name])), "PIL"
        if got is None or list(got.shape) != want["shape"]:
            fail(f"jpeg {name}: decoded {None if got is None else got.shape}"
                 f", digest {want['shape']}")
        exact = hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
        sample = np.frombuffer(base64.b64decode(want["sample"]), np.uint8)
        diff = np.abs(got[::stride, ::stride].astype(np.int16).ravel()
                      - sample.astype(np.int16))
        channel = ((got.reshape(-1, got.shape[2]).sum(0, np.int64)
                    - np.array(want["channel_sums"])) / got[..., 0].size)
        log(f"[jpeg] {name} {tuple(got.shape)} by {route} in {dt_ms:.2f} ms"
            f": sha256 equals libjpeg's: {exact}; on the every-{stride}th-"
            f"pixel sample max abs diff {int(diff.max())}, share differing "
            f"{float(np.mean(diff > 0)):.4f}, mean abs diff "
            f"{float(diff.mean()):.4f} (limit {NVJPEG_SAMPLE_MEAN_ABS}); "
            f"channel mean diff {np.round(channel, 4).tolist()} (limit "
            f"{NVJPEG_CHANNEL_MEAN})")
        worst = {"max": max(worst["max"], int(diff.max())),
                 "mean": max(worst["mean"], float(diff.mean())),
                 "channel": max(worst["channel"],
                                float(np.abs(channel).max()))}
        if route == "libjpeg" and not exact:
            fail(f"jpeg {name}: libjpeg pixels differ from the digest")
        if diff.mean() > NVJPEG_SAMPLE_MEAN_ABS or \
                np.abs(channel).max() > NVJPEG_CHANNEL_MEAN:
            fail(f"jpeg {name}: the decoder is past its stated difference")
        if name.startswith("bench_"):
            by_size.setdefault(tuple(want["shape"][:2]), []).append(got)
    log(f"[jpeg] worst over the fixtures by {backend}: max abs diff "
        f"{worst['max']}, sample mean abs diff {worst['mean']:.4f}, channel "
        f"mean diff {worst['channel']:.4f}")
    return by_size


def check_refused_frames(native, blobs):
    """The nvJPEG route takes only 8-bit SOF0 / SOF1 / SOF2 frames: a
    baseline fixture with its SOF marker rewritten to a lossless,
    hierarchical or arithmetic-coded frame, or its precision byte to 12
    or 16, is refused (None) and never raises `DecoderError`, and
    `safe_read` hands it to PIL; rewritten to SOF1 (the same Huffman
    data) it decodes to the baseline's pixels."""
    import numpy as np
    from mmlspark_tpu_torch.io.image import safe_read

    blob = blobs["bench_1_224x224.jpg"]
    sof = blob.find(b"\xff\xc0")
    base = native.decode_jpeg_bgr(blob)
    seen = {}
    for marker in (0xC1, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
                   0xCE, 0xCF):
        bad = bytearray(blob)
        bad[sof + 1] = marker
        got = native.decode_jpeg_bgr(bytes(bad))
        pil = safe_read(bytes(bad))
        seen[f"SOF {marker:02X}"] = ("decoded" if got is not None
                                     else "refused") + (
            ", PIL None" if pil is None else ", PIL pixels")
        if marker == 0xC1:
            # extended sequential, 8-bit Huffman: kept; nvJPEG may still
            # refuse it itself, and then PIL decodes it
            if got is not None and not np.array_equal(got, base):
                fail("a SOF1 stream does not decode to its baseline pixels")
        elif got is not None:
            fail(f"nvJPEG decoded a SOF {marker:02X} frame instead of "
                 "refusing it")
    for precision in (12, 16):
        bad = bytearray(blob)
        bad[sof + 4] = precision
        got = native.decode_jpeg_bgr(bytes(bad))
        pil = safe_read(bytes(bad))
        seen[f"precision {precision}"] = ("decoded" if got is not None
                                          else "refused") + (
            ", PIL None" if pil is None else ", PIL pixels")
        if got is not None:
            fail(f"nvJPEG decoded a {precision}-bit frame instead of "
                 "refusing it")
    log(f"[jpeg] rewritten frames of bench_1_224x224.jpg on nvJPEG: {seen}")


def jpeg_path(repo, n_chunks, card):
    """Phase 4b; returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table, native
    from mmlspark_tpu_torch.io.pipeline import PIPELINE_TELEMETRY
    from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                                  init_state_dict)
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet

    t0 = time.perf_counter()
    if not native.jpeg_available():
        fail(f"no JPEG decoder on the card's machine: {native.build_error()}")
    if native.jpeg_backend() != "nvjpeg":
        fail(f"the decoder built on {native.jpeg_backend()}: the C2 kernel "
             "is the nvJPEG backend's")
    log(f"[jpeg] decoder: {native.jpeg_backend()}, ready in "
        f"{time.perf_counter() - t0:.2f} s")
    blobs, digests = jpeg_fixtures()
    decoded = check_jpeg_decoder(native, blobs, digests)
    check_refused_frames(native, blobs)
    by_size = {hw: [n for n in sorted(blobs) if n.startswith("bench_") and
                    n.endswith(f"_{hw[0]}x{hw[1]}.jpg")] for hw in SIZES}
    # phase 4's three shape groups, 64 rows each, the two fixtures of a
    # size in turns; beside it the same decoded pixels as uint8 arrays
    column = [blobs[by_size[SIZES[i % 3]][(i // 3) % 2]]
              for i in range(N_IMAGES)]
    pixels = [decoded[SIZES[i % 3]][(i // 3) % 2] for i in range(N_IMAGES)]
    table = Table({"image": column, "id": np.arange(N_IMAGES)})
    pixel_table = Table({"image": pixels, "id": np.arange(N_IMAGES)})

    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH)
    zero_launches()
    t0 = time.perf_counter()
    out = featurizer.transform(table)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    feats = out["features"]
    log(f"[jpeg] bytes column of {N_IMAGES} JPEGs: transform {first_s:.3f} "
        f"s; launches {launches} (chunks={n_chunks})")
    if launches != dict(NO_LAUNCHES, affine_resample=n_chunks,
                        ycc_to_bgr=N_IMAGES):
        fail(f"the JPEG path launched the kernels {launches} times, "
             f"expected affine_resample once per chunk ({n_chunks}) and "
             f"ycc_to_bgr once per JPEG ({N_IMAGES})")
    if feats.shape != (N_IMAGES, 2048) or not np.isfinite(feats).all():
        fail(f"JPEG features: shape {feats.shape}, "
             f"finite={np.isfinite(feats).all()}")
    if not (out["id"] == np.arange(N_IMAGES)).all():
        fail("the JPEG path changed the row order")
    uint8_feats = featurizer.transform(pixel_table)["features"]
    err_uint8 = rel_l2(feats, uint8_feats)
    log(f"[jpeg] features vs phase 4's uint8 path on the same decoded "
        f"pixels: rel_l2={err_uint8:.3e} (bound {JPEG_UINT8_RTOL})")
    if err_uint8 > JPEG_UINT8_RTOL:
        fail("the JPEG path disagrees with the uint8 path on its pixels")

    # bf16 on the card against an f32 CPU run of the port (both decode
    # with the same decoder), random-BatchNorm weights as in phase 4
    few = [i for s in range(len(SIZES)) for i in range(s, 12, len(SIZES))]
    few_table = Table({"image": [column[i] for i in few]})
    check_state = init_state_dict(get_builder("resnet50")(num_classes=1000),
                                  seed=1, random_bn=True)
    side = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        check_bundle = TorchBundle("resnet50", {"num_classes": 1000},
                                   state_dict=check_state,
                                   input_shape=(IMG, IMG, 3), dtype=dtype)
        side[dev] = ImageFeaturizer(bundle=check_bundle, batch_size=BATCH,
                                    device=dev).transform(few_table)["features"]
    err_cpu = rel_l2(side["cuda"], side["cpu"])
    log(f"[jpeg] features (random-BatchNorm ResNet-50, bf16 on the card) vs "
        f"an f32 CPU run of {len(few)} JPEGs: rel_l2={err_cpu:.3e} (bound "
        f"{CPU_FEATURES_RTOL})")
    if err_cpu > CPU_FEATURES_RTOL:
        fail("JPEG features disagree with the f32 CPU run")

    # images/s, the JPEG bytes and phase 4's uint8 path on the same
    # pixels in turns, with the decode workers' busy time
    before = PIPELINE_TELEMETRY.snapshot()
    walls = {}
    for label, t in (("jpeg bytes", table), ("jpeg uint8", pixel_table),
                     ("jpeg bytes", table), ("jpeg uint8", pixel_table)):
        walls.setdefault(label, []).append(
            timed_transforms(featurizer, t, label, card, n_runs=3))
    busy = PIPELINE_TELEMETRY.delta(before).get("assemble", {})
    log(f"[jpeg] median walls: bytes {walls['jpeg bytes']} s, uint8 "
        f"{walls['jpeg uint8']} s; the assembly workers (decode for the "
        f"bytes, stacking for uint8) busy {busy.get('busy_s', 0.0):.4f} s "
        f"over {busy.get('items', 0.0):.0f} chunks in the 12 runs")
    del featurizer
    torch.cuda.empty_cache()
    return launches


def vit_path(K, A, images, table, repo, n_chunks, card):
    """Phase 5; returns {kernel: launches}."""
    import functools

    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet
    from mmlspark_tpu_torch.parallel.ring_attention import full_attention

    t0 = time.perf_counter()
    bundle = get_or_create_resnet("vit_base", (IMG, IMG, 3), 1000, repo=repo)
    log(f"[vit] zoo vit_base ready in {time.perf_counter() - t0:.2f} s")
    if bundle.layer_names[1] != "pool" or "encoded" not in bundle.layer_names:
        fail(f"vit_base bundle taps {bundle.layer_names}")
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH)
    layers = 12

    zero_launches()
    t0 = time.perf_counter()
    out = featurizer.transform(table)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    feats = out["features"]
    log(f"[vit] first transform {first_s:.3f} s; launches {launches} "
        f"(chunks={n_chunks}, layers={layers})")
    want = dict(NO_LAUNCHES, affine_resample=n_chunks,
                flash_attention_fwd=layers * n_chunks)
    if launches != want:
        fail(f"the ViT path launched the kernels {launches} times, "
             f"expected {want}")
    if feats.shape != (N_IMAGES, 768) or not np.isfinite(feats).all():
        fail(f"ViT features: shape {feats.shape}, "
             f"finite={np.isfinite(feats).all()}")
    if not (out["id"] == np.arange(N_IMAGES)).all():
        fail("ViT path changed the row order")

    # the same transform, attention through the plain version on the card
    plain_attn = functools.partial(full_attention, causal=False)
    plain_bundle = TorchBundle(
        "vit_base", dict(bundle.builder_kwargs, attn_fn=plain_attn),
        state_dict=bundle.state_dict, input_shape=(IMG, IMG, 3))
    A.LAUNCHES = 0
    plain_feats = ImageFeaturizer(bundle=plain_bundle, batch_size=BATCH
                                  ).transform(table)["features"]
    if A.LAUNCHES:
        fail("the plain-attention ViT launched the attention kernel")
    err_plain = rel_l2(feats, plain_feats)
    log(f"[vit] features vs plain-attention run on the card: "
        f"rel_l2={err_plain:.3e} (bound {VIT_PLAIN_RTOL})")
    if err_plain > VIT_PLAIN_RTOL:
        fail("ViT features disagree with the plain-attention run")

    few = [i for s in range(len(SIZES)) for i in range(s, 6, len(SIZES))]
    few_table = Table({"image": [images[i] for i in few]})
    cpu_bundle = TorchBundle("vit_base", bundle.builder_kwargs,
                             state_dict=bundle.state_dict,
                             input_shape=(IMG, IMG, 3), dtype="float32")
    cpu_feats = ImageFeaturizer(bundle=cpu_bundle, batch_size=BATCH,
                                device="cpu").transform(few_table)["features"]
    err_cpu = rel_l2(feats[few], cpu_feats)
    log(f"[vit] features (bf16 on the card) vs an f32 CPU run of "
        f"{len(few)} images: rel_l2={err_cpu:.3e} (bound {VIT_CPU_RTOL})")
    if err_cpu > VIT_CPU_RTOL:
        fail("ViT features disagree with the f32 CPU run")

    med_wall = timed_transforms(featurizer, table, "vit", card)
    chunk_device_time(featurizer, bundle, "vit", n_chunks, med_wall)
    profile_run(lambda: featurizer.transform(table), "vit",
                ["affine_resample", "flash_fwd"], med_wall)
    del featurizer, plain_bundle
    torch.cuda.empty_cache()
    return launches


def lm_path(K, A, card):
    """Phase 6; returns {kernel: launches}."""
    import functools

    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.parallel.ring_attention import full_attention

    t0 = time.perf_counter()
    bundle = TorchBundle("transformer_lm", LM, input_shape=(LM_PROMPT,),
                         seed=0)
    log(f"[lm] random-init TransformerLM {LM} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    prompt = np.random.default_rng(0).integers(
        0, LM["vocab_size"], (LM_BATCH, LM_PROMPT)).astype(np.int32)

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = G.generate(bundle, prompt, LM_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[lm] first generate (batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_NEW} new tokens) {first_s:.3f} s; launches {launches}")
    want = dict(NO_LAUNCHES, flash_attention_fwd=LM["num_layers"])
    if launches != want:
        fail(f"the LM path launched the kernels {launches} times, expected "
             f"{want} (the prefill once per layer; no decode step)")
    toks = out.cpu().numpy()
    if toks.shape != (LM_BATCH, LM_PROMPT + LM_NEW) or \
            not (toks[:, :LM_PROMPT] == prompt).all() or \
            toks.min() < 0 or toks.max() >= LM["vocab_size"]:
        fail(f"generate returned {toks.shape}, or tokens outside the vocab "
             f"or a changed prompt")

    module = G._module_for(bundle, torch.device("cuda"))
    plain_bundle = TorchBundle(
        "transformer_lm",
        dict(LM, attn_fn=functools.partial(full_attention, causal=True)),
        state_dict=bundle.state_dict, input_shape=(LM_PROMPT,))
    plain_module = plain_bundle.module(torch.device("cuda"))
    p_cuda = torch.from_numpy(prompt).cuda()
    with torch.inference_mode():
        logits = module(p_cuda)[0]
        plain_logits = plain_module(p_cuda)[0]
        # greedy's first new token, from the prefill's last position
        if not torch.equal(out[:, LM_PROMPT].long(),
                           logits[:, -1].argmax(-1)):
            fail("generate's first token is not the prefill's argmax")
    err_plain = rel_l2(logits.cpu().numpy(), plain_logits.cpu().numpy())
    log(f"[lm] prefill logits vs plain-attention prefill on the card: "
        f"rel_l2={err_plain:.3e} (bound {LM_PLAIN_RTOL})")
    if err_plain > LM_PLAIN_RTOL:
        fail("prefill logits disagree with the plain-attention prefill")
    del plain_module, plain_logits, logits

    cpu_bundle = TorchBundle("transformer_lm", LM, state_dict=bundle.state_dict,
                             input_shape=(LM_PROMPT,), dtype="float32")
    short = torch.from_numpy(prompt[:2, :LM_CPU_PROMPT])
    with torch.inference_mode():
        card_short = module(short.cuda())[0].cpu().numpy()
        cpu_short = cpu_bundle.module(torch.device("cpu"))(short)[0].numpy()
    err_cpu = rel_l2(card_short, cpu_short)
    log(f"[lm] prefill logits (bf16 on the card) vs an f32 CPU prefill of "
        f"a {LM_CPU_PROMPT}-token prompt, batch 2: rel_l2={err_cpu:.3e} "
        f"(bound {LM_CPU_RTOL})")
    if err_cpu > LM_CPU_RTOL:
        fail("prefill logits disagree with the f32 CPU prefill")

    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: G._prefill_cache(module, p_cuda), 5)
        _logits, cache = G._prefill_cache(module, p_cuda)
        tok = torch.zeros((LM_BATCH, 1), dtype=torch.int32, device="cuda")
        steps = LM_NEW - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            lg, cache = module.decode_step(tok, cache, LM_PROMPT + i)
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            G.generate(bundle, prompt, LM_NEW)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    log(f"[lm] prefill (batch {LM_BATCH} x {LM_PROMPT} tokens, 12 layers, "
        f"KV copied into the caches) {prefill_ms:.3f} ms (CUDA events over "
        f"5 back-to-back prefills) = "
        f"{LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} prompt tokens/s; "
        f"{steps} eager decode steps {decode_s * 1e3:.3f} ms = "
        f"{LM_BATCH * steps / decode_s:.0f} tokens/s "
        f"({decode_s / steps * 1e3:.3f} ms a step); whole generate walls "
        f"{min(walls):.4f}-{max(walls):.4f} s on {card}")
    profile_run(lambda: G.generate(bundle, prompt, LM_NEW), "lm",
                ["flash_fwd"], min(walls))
    del module, cache
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return launches


def paged_inputs(b, h, hkv, d, page, mp, dtype, positions, seed, n_pages=None):
    """q and K/V pools full of random values (the trash page 0 included);
    slot i owns distinct pages for its live positions 0..positions[i], the
    rest of its table row is 0."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    live = [p // page + 1 for p in positions]
    n_pages = n_pages or 1 + sum(live)
    q = torch.randn((b, h, d), device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn((n_pages, page, hkv, d), device="cuda",
                        generator=gen).to(dtype) for _ in range(2))
    table = np.zeros((b, mp), np.int32)
    order = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    nxt = 0
    for i, n in enumerate(live):
        table[i, :n] = order[nxt:nxt + n]
        nxt += n
    return (q, k, v, torch.from_numpy(table).cuda(),
            torch.tensor(positions, dtype=torch.int32, device="cuda"))


def paged_bound(q, pools, pos, int8: bool) -> tuple:
    """(bound_ms, bound_by) of one paged decode attention: each live K/V
    row read once (sum_b (pos_b + 1) * Hkv * D * itemsize * 2, plus the
    f32 scales for B8), q read and the f32 output written once, at the HBM
    rate; against 4 * sum_b (pos_b + 1) * H * D operations (QK and PV) at
    the f32 rate (the kernels use FMAs, no tensor cores)."""
    rows = int((pos.long() + 1).sum())
    _np, _page, hkv, d = pools[0].shape
    h = q.shape[1]
    nbytes = rows * hkv * d * pools[0].element_size() * 2
    if int8:
        nbytes += rows * hkv * 4 * 2
    nbytes += q.numel() * q.element_size() + q.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * rows * h * d / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_paged(PA, label, q, pools, table, pos, timed: bool):
    """B7 (pools (k, v)) or B8 (pools (kq, ks, vq, vs)) against its plain
    version on the same inputs; with `timed`, kernel, plain and library
    times (CUDA events) and the bound."""
    import torch
    import torch.nn.functional as F

    int8 = len(pools) == 4
    kernel = PA.paged_decode_attention_int8 if int8 else \
        PA.paged_decode_attention
    plain = PA.paged_decode_attention_int8_plain if int8 else \
        PA.paged_decode_attention_plain
    got = kernel(q, *pools, table, pos)
    ref = plain(q, *pools, table, pos)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{label}: bad output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    b, h, d = q.shape
    np_, page, hkv, _ = pools[0].shape
    shape = (f"q{list(q.shape)} {str(q.dtype)[6:]} pools{list(pools[0].shape)}"
             f" {str(pools[0].dtype)[6:]} MP {table.shape[1]} pos "
             f"{pos.min().item()}..{pos.max().item()}")
    if err > PAGED_ATOL:
        fail(f"{label} {shape}: kernel disagrees with plain version "
             f"(max abs err {err:.3e} > {PAGED_ATOL})")
    if not timed:
        log(f"[kernel] {label} {shape}: max_abs_err={err:.3e} "
            f"(limit {PAGED_ATOL})")
        return {"err": err}
    mp = table.shape[1]
    mask = (torch.arange(mp * page, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    idx = table.long()

    def library():
        # the gather and SDPA (B8: and the dequantization) as separate calls
        if int8:
            kq, ks, vq, vs = (t[idx] for t in pools)
            k_log = (kq.to(q.dtype) * ks[..., None].to(q.dtype))
            v_log = (vq.to(q.dtype) * vs[..., None].to(q.dtype))
        else:
            k_log, v_log = (t[idx] for t in pools)
        k_log, v_log = (x.reshape(b, mp * page, hkv, d).transpose(1, 2)
                        .repeat_interleave(h // hkv, dim=1)
                        for x in (k_log, v_log))
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k_log, v_log, attn_mask=mask)

    lib_err = float((library()[:, :, 0].float() - ref).abs().max())

    def call():
        return kernel(q, *pools, table, pos)

    # the record is the device time (a call is two short kernels behind a
    # Python wrapper), the back-to-back time beside it
    b2b_ms = cuda_ms(call, 50)
    kernel_ms = queued_ms(call)
    plain_ms = cuda_ms(lambda: plain(q, *pools, table, pos), 5)
    library_ms = cuda_ms(library, 20)
    bound_ms, bound_by = paged_bound(q, pools, pos, int8)
    calls = "gather+dequant+SDPA, 3 calls" if int8 else "gather+SDPA, 2 calls"
    log(f"[kernel] {label} {shape}: max_abs_err={err:.3e} (limit "
        f"{PAGED_ATOL}) kernel_ms={kernel_ms:.4f} (queued behind a spin; "
        f"back-to-back calls {b2b_ms:.4f}) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} ({calls}, max_abs_err vs plain "
        f"{lib_err:.3e}) bound_ms={bound_ms:.4f} ({bound_by}) "
        f"roofline_share={bound_ms / kernel_ms:.3f}")
    # the chunk rule (PA.split_pages): the same inputs at half (in whole
    # pages) and twice the rule's rows
    sp = PA.split_pages(page, pools[0].dtype)
    for pages in sorted({max(1, sp // 2), 2 * sp} - {sp}):
        other, other_err = paged_chunk_call(PA, q, pools, table, pos, pages,
                                            ref)
        log(f"[kernel] {label}: chunks of {pages * page} rows in place of "
            f"the rule's {sp * page}: max_abs_err={other_err:.3e}, queued "
            f"behind a spin {queued_ms(other):.4f} ms; the rule's queued "
            f"again {queued_ms(call):.4f} ms")
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def paged_chunk_call(PA, q, pools, table, pos, pages, ref):
    """(a call of the split kernels with chunks of `pages` pages through
    the wrapper's C entry, on these inputs; its largest error against
    `ref`): the chunk rule's alternative, timed beside it."""
    import torch

    lib = PA._kernel_lib()
    int8 = len(pools) == 4
    fn = lib.mmk_paged_attention_int8 if int8 else lib.mmk_paged_attention
    b, h, d = q.shape
    _np, page, hkv, _d = pools[0].shape
    mp = table.shape[1]
    out = torch.empty((b, h, d), dtype=torch.float32, device="cuda")
    ws = torch.empty(b * h * -(-mp // pages) * (d + 2), dtype=torch.float32,
                     device="cuda")
    args = (q.data_ptr(), *(t.data_ptr() for t in pools), table.data_ptr(),
            pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, hkv, d, page, mp, pages,
            q.stride(0), q.stride(1), 1.0 / math.sqrt(d))

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"{fn.__name__} at {pages} pages a chunk: CUDA error {err}")

    call()
    torch.cuda.synchronize()
    return call, float((out - ref).abs().max())


def paged_kernel_checks(PA):
    """Phase 3's B7/B8 cases: the serving shape (q [8, 12, 64] bf16, a
    129-page pool of 64-row pages, MP 16, positions from a seed with 0, 63,
    64 and 1023), f32 pools, a GQA pool (Hkv 4), D 32 with 16-row pages,
    and B8 over int8 pools from quantize_kv_row; returns {kernel: its
    largest error}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.quant import quantize_kv_row

    rng = np.random.default_rng(30)
    main_pos = [0, 63, 64, 1023] + rng.integers(0, 1024, 4).tolist()
    cases = [("main", 8, 12, 12, 64, PAGE, 16, torch.bfloat16, main_pos, 129),
             ("f32", 8, 12, 12, 64, PAGE, 16, torch.float32, main_pos, 129),
             ("gqa", 8, 12, 4, 64, PAGE, 16, torch.bfloat16, main_pos, 129),
             ("d32", 5, 4, 4, 32, 16, 8, torch.float32,
              [0, 15, 16, 127, 77], None)]
    errs = {"paged_decode_attention": 0.0, "paged_decode_attention_int8": 0.0}
    for name, b, h, hkv, d, page, mp, dtype, positions, n_pages in cases:
        q, k, v, table, pos = paged_inputs(b, h, hkv, d, page, mp, dtype,
                                           positions, seed=31, n_pages=n_pages)
        kq, ks = quantize_kv_row(k)
        vq, vs = quantize_kv_row(v)
        for key, pools in (("paged_decode_attention", (k, v)),
                           ("paged_decode_attention_int8", (kq, ks, vq, vs))):
            err = check_paged(PA, f"{key}[{name}]", q, pools, table, pos,
                              timed=False)["err"]
            errs[key] = max(errs[key], err)
    return errs


def _prefill_then_steps(module, prompt, split, kv_cache_dtype):
    """`generate`'s machinery: prefill prompt[:split], then one decode
    step per remaining prompt token; returns (next logits, cache, pos)."""
    import torch
    from mmlspark_tpu_torch.models import generation as G

    p = torch.as_tensor(prompt[:split], dtype=torch.int32, device="cuda")
    logits, cache = G._prefill_cache(module, p[None], kv_cache_dtype)
    cur, pos = logits[0, -1], split
    for t in prompt[split:]:
        cur, cache, pos = _step(module, int(t), cache, pos)
    return cur, cache, pos


def _step(module, tok, cache, pos):
    import torch

    lg, cache = module.decode_step(
        torch.tensor([[tok]], dtype=torch.int32, device="cuda"), cache, pos)
    return lg[0, 0], cache, pos + 1


def step_logits(module, prompt, toks, kv_cache_dtype, split=None):
    """The logits the reference reads before emitting toks[len(toks)]:
    `generate`'s prefill over the prompt (over prompt[:split] and then one
    decode step per remaining prompt token, with `split`), then one
    decode step per token of `toks`."""
    import torch

    with torch.inference_mode():
        cur, cache, pos = _prefill_then_steps(
            module, prompt, split or len(prompt), kv_cache_dtype)
        for t in toks:
            cur, cache, pos = _step(module, t, cache, pos)
    return cur


def split_generate(module, prompt, split, n, kv_cache_dtype):
    """Greedy tokens of a shared-prefix request as the batcher computes
    it with int8 pools: the prefix prefilled on its own, and the suffix
    attending over the QUANTIZED prefix rows (the JAX package's
    semantics; `generate`'s one prefill attends over them unquantized),
    fed here one decode step per token."""
    import torch

    toks = []
    with torch.inference_mode():
        cur, cache, pos = _prefill_then_steps(module, prompt, split,
                                              kv_cache_dtype)
        for i in range(n):
            toks.append(int(cur.argmax()))
            if i < n - 1:
                cur, cache, pos = _step(module, toks[-1], cache, pos)
    return toks


def compare_streams(label, module, prompts, got, refs, kv_cache_dtype,
                    splits=None):
    """Each stream against its reference tokens (`generate`'s, or
    `split_generate`'s where `splits` gives the prefix length).  A
    mismatch is a tie (printed, not failed) only where the reference's
    top-2 logit gap at the first differing step is under TIE_GAP."""
    splits = splits or [None] * len(prompts)
    for i, (prompt, g, r) in enumerate(zip(prompts, got, refs)):
        if g == r:
            continue
        step = next((j for j, (a, b) in enumerate(zip(g, r)) if a != b),
                    min(len(g), len(r)))
        if step >= len(r) or step >= len(g):
            fail(f"{label}: stream {i} has {len(g)} tokens, generate "
                 f"{len(r)}")
        top2 = step_logits(module, prompt, r[:step], kv_cache_dtype,
                           splits[i]).float().topk(2).values
        gap = float(top2[0] - top2[1])
        if gap >= TIE_GAP:
            fail(f"{label}: stream {i} (prompt {len(prompt)}) differs from "
                 f"generate at step {step} where the top-2 logit gap is "
                 f"{gap:.3e}")
        log(f"[serve] {label}: stream {i} ties generate at step {step} "
            f"(top-2 gap {gap:.2e} < {TIE_GAP})")
    log(f"[serve] {label}: {len(got)} streams of {len(got[0])} tokens equal "
        f"their references on the card (generate(); int8 shared-prefix "
        f"requests split_generate()), ties aside")


def batch_fill_count() -> int:
    """Ticks so far: one `serving.batcher.batch_fill` observation each."""
    from mmlspark_tpu_torch.core import telemetry

    return telemetry.histogram("serving.batcher.batch_fill").snapshot()["count"]


class StepCounter:
    """Counts one batcher's decode ticks (its `_step`, called once a tick,
    each launching the paged kernel once a layer) until `remove()`, and
    calls `observe()` at each tick before it runs, where one is given."""

    def __init__(self, batcher, observe=None):
        import threading

        self.batcher, self.real = batcher, batcher._step
        self.observe = observe
        self.ticks = 0
        self.lock = threading.Lock()
        batcher._step = self

    def __call__(self, tok, pos, table):
        with self.lock:
            self.ticks += 1
            if self.observe is not None:
                self.observe()
        return self.real(tok, pos, table)

    def remove(self):
        self.batcher._step = self.real


class PrefillCounter:
    """Records every batcher's admission prefill forwards (`_prefill_kv`,
    each launching B4 once a layer) until `remove()`: each forward's
    module and token shape, its tokens and logits handed to `observe`
    where one is given."""

    def __init__(self, observe=None):
        import threading

        from mmlspark_tpu_torch.serving import batcher as SB

        self.SB, self.real = SB, SB._prefill_kv
        self.observe = observe
        self.calls = []   # (module, token shape) a forward
        self.lock = threading.Lock()
        SB._prefill_kv = self

    @property
    def forwards(self) -> int:
        return len(self.calls)

    @property
    def shapes(self) -> list:
        return [shape for _m, shape in self.calls]

    def of(self, module) -> int:
        """The forwards of `module` alone."""
        return sum(m is module for m, _s in self.calls)

    def __call__(self, module, toks, kv_cache_dtype=None):
        logits, kv = self.real(module, toks, kv_cache_dtype)
        with self.lock:
            self.calls.append((module, tuple(toks.shape)))
            if self.observe is not None:
                self.observe(module, toks, logits)
        return logits, kv

    def remove(self):
        self.SB._prefill_kv = self.real


def post_streams(host, port, path, bodies, concurrency, trace_ids=None):
    """POST every JSON body from `concurrency` client threads, one
    connection a request, reading each reply as it arrives (`read1`):
    [{"status", "body", "chunks", "first_s", "total_s"}] in body order.
    Fails the run on a hung or failed client or an unanswered request
    (through `fail`'s SystemExit: a caller's thread must pass it on)."""
    import http.client
    import threading

    results = [None] * len(bodies)
    errors = []

    def client(c):
        try:
            for i in range(c, len(bodies), concurrency):
                conn = http.client.HTTPConnection(host, port,
                                                  timeout=STREAM_WAIT_S)
                headers = {"Content-Type": "application/json"}
                if trace_ids is not None:
                    headers["X-Trace-Id"] = trace_ids[i]
                t0 = time.perf_counter()
                conn.request("POST", path, body=json.dumps(
                    bodies[i]).encode(), headers=headers)
                resp = conn.getresponse()
                parts, first = [], None
                while True:
                    part = resp.read1(1 << 16)
                    if not part:
                        break
                    if first is None:
                        first = time.perf_counter() - t0
                    parts.append(part)
                results[i] = {"status": resp.status,
                              "body": b"".join(parts).decode(),
                              "chunks": len(parts), "first_s": first,
                              "total_s": time.perf_counter() - t0}
                conn.close()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=STREAM_WAIT_S)
    lost = [i for i, r in enumerate(results) if r is None]
    if any(t.is_alive() for t in threads) or errors or lost:
        fail(f"HTTP clients failed or hung: {errors[:3]}; requests "
             f"{lost[:8]} of {len(bodies)} got no answer")
    return results


def stream_tokens(label, results, n_new, vocab):
    """The token lists of `post_streams` results; fails the run on a
    non-200 answer, a stream of another length or a token outside the
    vocabulary."""
    bad = [(i, r["status"], r["body"][:120]) for i, r in enumerate(results)
           if r["status"] != 200]
    if bad:
        fail(f"{label}: {len(bad)} answers were not 200: {bad[:3]}")
    toks = [[int(t) for t in r["body"].split()] for r in results]
    if any(len(t) != n_new for t in toks) or \
            min(min(t) for t in toks) < 0 or \
            max(max(t) for t in toks) >= vocab:
        fail(f"{label}: stream lengths {[len(t) for t in toks]} (want "
             f"{n_new}) or tokens outside the vocabulary")
    return toks


def serve_exactness(card):
    """Phase 7a: f32 paged serving at GPT-small width (2 layers), plain
    and int8 pools, with a shared prefix, and over HTTP: every stream
    equals `generate()` on the card.  Returns the requests (prompts, the
    prefix, its suffixes) and their f32 `generate()` references, which
    phase 13 (c) serves again speculatively."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.serving import read_stream
    from mmlspark_tpu_torch.serving.batcher import ContinuousBatcher

    bundle = TorchBundle("transformer_lm", EXACT_LM, input_shape=(16,),
                         dtype="float32", seed=0)
    module = G._module_for(bundle, torch.device("cuda"))
    vocab = EXACT_LM["vocab_size"]
    rng = np.random.default_rng(1)
    lens = [16, 900] + rng.integers(16, 901, EXACT_REQUESTS - 2).tolist()
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    prefix = rng.integers(0, vocab, PREFIX_LEN).astype(np.int32)
    suffixes = [rng.integers(0, vocab, n).astype(np.int32) for n in (1, 100)]
    full = prompts + [np.concatenate([prefix, sfx]) for sfx in suffixes]
    refs = {}
    for kvd in (None, "int8"):
        label = f"f32 paged serving, {kvd or 'f32'} pools"
        refs[kvd] = [G.generate(bundle, p[None], EXACT_NEW,
                                kv_cache_dtype=kvd)[0, len(p):].cpu().tolist()
                     for p in full]
        # int8 pools: the shared-prefix requests' own semantics
        splits = [None] * len(prompts) + [PREFIX_LEN if kvd else None] * 2
        for i, split in enumerate(splits):
            if split is not None:
                refs[kvd][i] = split_generate(module, full[i], split,
                                              EXACT_NEW, kvd)
        batcher = ContinuousBatcher(bundle, max_slots=EXACT_SLOTS, paged=True,
                                    page_size=PAGE, kv_cache_dtype=kvd)
        handle = batcher.register_prefix(prefix)
        batcher.start()
        try:
            zero_launches()
            ticks0 = batch_fill_count()
            t0 = time.perf_counter()
            streams = ([batcher.submit(p, EXACT_NEW) for p in prompts]
                       + [batcher.submit(sfx, EXACT_NEW, prefix=handle)
                          for sfx in suffixes])
            got = [st.tokens(timeout=STREAM_WAIT_S) for st in streams]
            wall = time.perf_counter() - t0
            launches, ticks = read_launches(), batch_fill_count() - ticks0
        finally:
            batcher.stop()
        key = "paged_decode_attention_int8" if kvd else "paged_decode_attention"
        log(f"[serve] {label}: {len(full)} requests (prompts {min(lens)}.."
            f"{max(lens)}, one {PREFIX_LEN}-token shared prefix with 2 "
            f"suffixes), {EXACT_NEW} new tokens each, {EXACT_SLOTS} slots: "
            f"{wall:.3f} s, {ticks} ticks, launches {launches}")
        if launches[key] != EXACT_LM["num_layers"] * ticks or ticks == 0:
            fail(f"{label}: {key} launched {launches[key]} times in "
                 f"{ticks} ticks of {EXACT_LM['num_layers']} layers")
        compare_streams(label, module, full, got, refs[kvd], kvd, splits)

    # the same requests over HTTP, from 4 concurrent clients
    query = (read_stream()
             .continuous_server(name="lm", path="/lm")
             .parse_request(schema=["prompt"])
             .generate_stream(bundle, max_new_tokens=EXACT_NEW,
                              max_slots=EXACT_SLOTS, paged=True,
                              page_size=PAGE)
             .options(batch_timeout_ms=5.0)
             .start())
    try:
        si = query.service_info
        t0 = time.perf_counter()
        answers = post_streams(si.host, si.port, "/lm",
                               [{"prompt": p.tolist()} for p in full], 4)
        wall = time.perf_counter() - t0
    finally:
        query.stop()
    results = stream_tokens("HTTP f32 paged serving", answers, EXACT_NEW,
                            vocab)
    log(f"[serve] HTTP: {len(full)} requests from 4 concurrent clients "
        f"through read_stream().continuous_server().generate_stream("
        f"paged=True) in {wall:.3f} s")
    compare_streams("HTTP f32 paged serving", module, full, results,
                    refs[None], None)
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return prompts, prefix, suffixes, refs[None]


def serving_path(A, PA, card):
    """Phase 7b, the serving configuration: ContinuousBatcher, paged, over
    chip_smoke's GPT-small LM (12 layers, bf16), 8 slots, 64-row pages (the
    default 129-page pool), 16 requests of 16..900-token prompts and 64 new
    tokens; once with bf16 pools (B7) and once with int8 pools (B8).
    Returns ({kernel: launches}, {kernel: timing row from the live pools},
    B4's largest error on the admission prefills' own q/k/v)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.serving import batcher as SB

    layers = LM["num_layers"]
    bundle = TorchBundle("transformer_lm", LM, input_shape=(16,), seed=0)
    module = G._module_for(bundle, torch.device("cuda"))
    rng = np.random.default_rng(2)
    lens = rng.integers(16, 901, SERVE_REQUESTS)
    prompts = [rng.integers(0, LM["vocab_size"], n).astype(np.int32)
               for n in lens]
    total = {k: 0 for k in KERNELS}
    rows = {}
    flash_err = 0.0
    for kvd in (None, "int8"):
        key = "paged_decode_attention_int8" if kvd else "paged_decode_attention"
        label = f"serving {kvd or 'bf16'} pools"
        batcher = SB.ContinuousBatcher(bundle, max_slots=SERVE_SLOTS,
                                       paged=True, page_size=PAGE,
                                       kv_cache_dtype=kvd).start()
        # spies for the counted run: prefill forwards (with each row's
        # argmax), one tick's live attention inputs, pages in use per tick
        prefills, captured, pages_used, flash_checks = [], {}, [], []
        real_kernel, real_flash = getattr(PA, key), A.flash_attention_fwd

        def kernel_spy(q, *rest):
            # layer 0 of the 40th tick: slots are full and recycled
            if "args" not in captured and len(pages_used) == 40:
                captured["args"] = tuple(t.clone() for t in (q, *rest))
            return real_kernel(q, *rest)

        def flash_spy(q, k, v, causal):
            # every admission prefill's B4 launch (its kp rows at its
            # bucket) held against the plain version on the same q/k/v
            out, lse = real_flash(q, k, v, causal)
            ref, ref_lse = A.flash_attention_fwd_plain(q, k, v, causal)
            flash_checks.append((tuple(q.shape), float((out - ref).abs().max()),
                                 float((lse - ref_lse).abs().max())))
            return out, lse

        def record_pages():
            pages_used.append(batcher._np - 1 - len(batcher._free))

        def record_argmax(_module, toks, logits):
            prefills.append((toks.cpu().numpy(),
                             logits.argmax(-1).cpu().numpy()))

        steps = StepCounter(batcher, record_pages)
        prefill = PrefillCounter(record_argmax)
        setattr(PA, key, kernel_spy)
        A.flash_attention_fwd = flash_spy
        try:
            zero_launches()
            ticks0 = batch_fill_count()
            t0 = time.perf_counter()
            streams = [batcher.submit(p, SERVE_NEW) for p in prompts]
            got = [st.tokens(timeout=STREAM_WAIT_S) for st in streams]
            first_s = time.perf_counter() - t0
            launches, ticks = read_launches(), batch_fill_count() - ticks0
        finally:
            prefill.remove()
            steps.remove()
            setattr(PA, key, real_kernel)
            A.flash_attention_fwd = real_flash
        want = dict(NO_LAUNCHES, flash_attention_fwd=layers * len(prefills))
        want[key] = layers * ticks
        log(f"[serve] {label}: {SERVE_REQUESTS} requests (prompts "
            f"{lens.min()}..{lens.max()}), {SERVE_NEW} new tokens each, "
            f"{SERVE_SLOTS} slots, 12 layers bf16: first round {first_s:.3f}"
            f" s, {ticks} ticks, {len(prefills)} admission prefill "
            f"forwards, launches {launches}")
        if launches != want or ticks == 0:
            fail(f"{label}: launches {launches}, expected {want} ({key} "
                 f"once per layer per tick, B4 once per layer per admission "
                 f"prefill, B1 never)")
        err = max(e for _s, e, _l in flash_checks)
        lse_err = max(e for _s, _e, e in flash_checks)
        log(f"[serve] {label}: B4 on its {len(flash_checks)} admission "
            f"prefill launches' own q/k/v (shapes "
            f"{sorted(set(s for s, _e, _l in flash_checks))}): max_abs_err="
            f"{err:.3e} (limit {ATTN_ATOL['bfloat16']}) lse_err={lse_err:.3e}"
            f" (limit {LSE_ATOL}) against the plain version")
        if err > ATTN_ATOL["bfloat16"] or lse_err > LSE_ATOL:
            fail(f"{label}: B4 disagrees with its plain version on an "
                 f"admission prefill (max abs err {err:.3e}, lse "
                 f"{lse_err:.3e})")
        flash_err = max(flash_err, err)
        if any(len(t) != SERVE_NEW for t in got) or \
                min(min(t) for t in got) < 0 or \
                max(max(t) for t in got) >= LM["vocab_size"]:
            fail(f"{label}: stream lengths {[len(t) for t in got]} or "
                 f"tokens outside the vocabulary")
        for i, (p, toks) in enumerate(zip(prompts, got)):
            hit = [am[r, len(p) - 1] for tk, am in prefills
                   for r in range(tk.shape[0])
                   if tk.shape[1] >= len(p) and (tk[r, :len(p)] == p).all()]
            if not hit or hit[0] != toks[0]:
                fail(f"{label}: stream {i}'s first token {toks[0]} is not "
                     f"the argmax of its prefill logits ({hit[:1]})")
        agree = []
        with torch.inference_mode():
            for p, toks in zip(prompts, got):
                seq = torch.as_tensor(np.concatenate([p, toks[:-1]]),
                                      device="cuda")[None]
                pred = module(seq)[0][0, len(p) - 1:].argmax(-1).cpu()
                agree.append(float((pred.numpy() == np.asarray(toks)).mean()))
        log(f"[serve] {label}: first tokens equal the argmax of their "
            f"prefill logits; teacher-forced agreement with a prefill "
            f"forward over prompt + tokens: mean {np.mean(agree):.4f}, min "
            f"{min(agree):.4f} (bf16, informational)")
        rows[key] = check_paged(PA, f"{key}[live pools, tick 40, layer 0]",
                                captured["args"][0], captured["args"][1:-2],
                                captured["args"][-2], captured["args"][-1],
                                timed=True)
        del captured
        pool_bytes = sum(t.numel() * t.element_size()
                         for layer in batcher._cache for t in layer)
        page_bytes = pool_bytes // batcher._np
        dense_bytes = (pool_bytes // batcher._np) * SERVE_SLOTS * \
            (LM["max_len"] // PAGE)
        log(f"[serve] {label}: KV pools {pool_bytes / 2**20:.1f} MiB for "
            f"{batcher._np} pages; dense max_slots x max_len cache "
            f"{dense_bytes / 2**20:.1f} MiB; pages in use at most "
            f"{max(pages_used)} = {max(pages_used) * page_bytes / 2**20:.1f} "
            f"MiB")
        walls, tick_counts = [], []
        for _ in range(3):
            ticks0 = batch_fill_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for st in [batcher.submit(p, SERVE_NEW) for p in prompts]:
                st.tokens(timeout=STREAM_WAIT_S)
            walls.append(time.perf_counter() - t0)
            tick_counts.append(batch_fill_count() - ticks0)
        tps = [SERVE_REQUESTS * SERVE_NEW / w for w in walls]
        host_ms = [w * 1e3 / n for w, n in zip(walls, tick_counts)]
        log(f"[serve] {label}: 3 rounds: {min(tps):.0f}..{max(tps):.0f} "
            f"tokens/s aggregate; {min(host_ms):.3f}..{max(host_ms):.3f} ms "
            f"per tick on the host clock (admission prefills included; "
            f"ticks {tick_counts}) on {card}")
        kern = []
        for _ in range(3):
            ticks0 = batch_fill_count()

            def one_round():
                for st in [batcher.submit(p, SERVE_NEW) for p in prompts]:
                    st.tokens(timeout=STREAM_WAIT_S)

            # B7's or B8's two kernels (split, merge)
            busy = profiled_kernel_ms(one_round, PAGED_KERNEL_NAMES
                                      + ("flash_fwd",))
            n = batch_fill_count() - ticks0
            if busy is not None:
                paged_ms = sum(busy[1][k] for k in PAGED_KERNEL_NAMES)
                kern.append((busy[0] / n, paged_ms / busy[0],
                             busy[1]["flash_fwd"] / busy[0], busy[2] / n))
        if kern:
            log(f"[serve] {label}: 3 profiled rounds: kernel time "
                f"{min(k[0] for k in kern):.3f}..{max(k[0] for k in kern):.3f}"
                f" ms per tick against {min(k[3] for k in kern):.3f}.."
                f"{max(k[3] for k in kern):.3f} ms of profiled wall per tick;"
                f" the paged kernel's share of kernel time "
                f"{min(k[1] for k in kern):.4f}..{max(k[1] for k in kern):.4f}"
                f", B4's {min(k[2] for k in kern):.4f}.."
                f"{max(k[2] for k in kern):.4f}")
        else:
            log(f"[serve] {label}: the profiler saw no device time "
                "(kernel time per tick not measured)")
        batcher.stop()
        for k in KERNELS:
            total[k] += launches[k]
        del batcher
        torch.cuda.empty_cache()
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return total, rows, flash_err


def lm_train_flops(batch, seq, e, layers, vocab, mlp=4) -> float:
    """FLOPs of one LM train step as tools/roofline.py `analyze_lm_train`
    counts them (a copy of its formula): the forward's matmuls — qkv,
    attention (4 B S^2 e, no causal halving), proj and the MLP per layer,
    and the LM head — times 3 for forward plus backward."""
    per_layer = (2.0 * batch * seq * e * 3 * e + 4.0 * batch * seq * seq * e
                 + 2.0 * batch * seq * e * e
                 + 4.0 * batch * seq * e * mlp * e)
    return 3.0 * (layers * per_layer + 2.0 * batch * seq * e * vocab)


def rel_err(a, b) -> float:
    """Relative L2 error of tensor a against tensor b, in f32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def lm_grads(module, toks):
    """{name: f32 gradient or None} of one next-token loss.backward()."""
    from mmlspark_tpu_torch.models.training import lm_loss

    logits, _taps = module(toks)
    lm_loss(logits, toks).backward()
    grads = {n: None if p.grad is None else p.grad.float()
             for n, p in module.named_parameters()}
    for p in module.parameters():
        p.grad = None
    return grads


def lm_train_path(card):
    """Phase 8a; returns {kernel: launches} of the counted run."""
    import functools

    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.bundle import get_builder, init_state_dict
    from mmlspark_tpu_torch.parallel.ring_attention import full_attention

    cfg = dict(LM, max_len=TRAIN_SEQ)
    layers = cfg["num_layers"]
    builder = get_builder("transformer_lm")
    t0 = time.perf_counter()
    state = TR.init_train_state(builder(**cfg), TR.adam(TRAIN_LR), seed=0,
                                compute_dtype="bfloat16")
    n_params = sum(p.numel() for p in state.module.parameters())
    log(f"[train] GPT-small TransformerLM {cfg}, {n_params / 1e6:.1f} M f32 "
        f"parameters, bf16 working copy, Adam {TRAIN_LR}: ready in "
        f"{time.perf_counter() - t0:.2f} s")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ)).astype(
            np.int32)).cuda()

    # first-step gradients through the kernels against the same step
    # through full_attention, on the same weights and tokens (not counted)
    ref_module = builder(**cfg, attn_fn=functools.partial(full_attention,
                                                          causal=True))
    ref_module.load_state_dict(state.module.state_dict())
    ref_module = ref_module.to("cuda", torch.bfloat16)
    got = lm_grads(state.work, toks)
    ref = lm_grads(ref_module, toks)
    del ref_module
    missing = sorted(n for n, g in got.items() if g is None)
    if missing or sorted(got) != sorted(ref):
        fail(f"LM train step: parameters without a gradient: {missing}")
    rels = {n: rel_err(g, ref[n]) for n, g in got.items()}
    worst = max(rels, key=rels.get)
    log(f"[train] first-step gradients of all {len(rels)} parameters through "
        f"B4/B5/B6 vs through full_attention (bf16 both): worst rel_l2="
        f"{rels[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(rels.values()))):.3e} (limit "
        f"{TRAIN_GRAD_RTOL})")
    if rels[worst] > TRAIN_GRAD_RTOL:
        fail(f"LM train step: {worst}'s gradient disagrees with the "
             f"full_attention step (rel_l2 {rels[worst]:.3e})")
    del got, ref
    torch.cuda.empty_cache()

    # a 2-layer f32 step on the card against the same step on the CPU
    small = dict(LM, num_layers=2, max_len=128)
    weights = {k: torch.from_numpy(v) for k, v in init_state_dict(
        builder(**small), seed=5).items()}
    small_toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, small["vocab_size"], (2, 128)).astype(np.int32))
    side = {}
    for dev in ("cuda", "cpu"):
        module = builder(**small)
        module.load_state_dict(weights)
        module = module.to(dev)
        logits, _taps = module(small_toks.to(dev))
        loss = TR.lm_loss(logits, small_toks.to(dev))
        loss.backward()
        side[dev] = (loss.item(), {n: p.grad.cpu() for n, p in
                                   module.named_parameters()})
    loss_rel = abs(side["cuda"][0] - side["cpu"][0]) / abs(side["cpu"][0])
    grad_rel = max(rel_err(g, side["cpu"][1][n])
                   for n, g in side["cuda"][1].items())
    log(f"[train] 2-layer f32 LM step (batch 2 x 128) on the card vs the "
        f"CPU: loss rel {loss_rel:.3e} (limit {TRAIN_CPU_LOSS_RTOL}), worst "
        f"gradient rel_l2 {grad_rel:.3e} (limit {TRAIN_CPU_GRAD_RTOL})")
    if loss_rel > TRAIN_CPU_LOSS_RTOL or grad_rel > TRAIN_CPU_GRAD_RTOL:
        fail("the f32 LM step on the card disagrees with the CPU's")
    del side

    # the counted run: one warm-up step and TRAIN_STEPS timed steps of
    # make_lm_train_epoch on one repeated batch
    epoch = TR.make_lm_train_epoch()
    batch = toks[None]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    state, loss0 = epoch(state, batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses, step_s = [loss0], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = epoch(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = TRAIN_STEPS + 1
    want = dict(NO_LAUNCHES, flash_attention_fwd=layers * steps,
                flash_attention_bwd_dkdv=layers * steps,
                flash_attention_bwd_dq=layers * steps)
    losses = torch.cat(losses).cpu().numpy()
    log(f"[train] {steps} steps (1 warm-up, {warm_s * 1e3:.1f} ms): launches "
        f"{launches}; losses {np.array2string(losses, precision=4)}")
    if launches != want:
        fail(f"the LM train path launched the kernels {launches} times, "
             f"expected {want} (B4, B5 and B6 once per layer per step)")
    if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        fail(f"LM train losses not finite or not falling: {losses}")
    med = float(np.median(step_s))
    flops = lm_train_flops(TRAIN_BATCH, TRAIN_SEQ, cfg["embed_dim"], layers,
                           cfg["vocab_size"])
    log(f"[train] LM step (batch {TRAIN_BATCH} x {TRAIN_SEQ}, fwd + bwd + "
        f"Adam, CUDA-synchronised host clock): {min(step_s) * 1e3:.3f}.."
        f"{max(step_s) * 1e3:.3f} ms over {TRAIN_STEPS} steps, median "
        f"{med * 1e3:.3f} ms = {TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; "
        f"{flops / 1e12:.3f} TFLOP a step (tools/roofline.py's count) = "
        f"MFU {flops / med / BF16_FLOPS:.4f} against {BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s; peak memory {peak_gib:.2f} GiB on {card}")
    busy = profiled_kernel_ms(lambda: epoch(state, batch),
                              ["flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"])
    if busy is None:
        log("[train] profiled step: the profiler saw no device time (kernel "
            "time a step not measured)")
    else:
        total_ms, by_name, wall_ms = busy
        log(f"[train] profiled step: compute kernels {total_ms:.3f} ms on the "
            f"device (a step's wall {wall_ms:.3f} ms, busy share "
            f"{total_ms / wall_ms:.3f}), of which " + " ".join(
                f"{n} {ms:.3f} ms ({ms / total_ms:.4f})"
                for n, ms in by_name.items()))
    del state, epoch, batch
    torch.cuda.empty_cache()
    return launches


def cifar_train_path(card):
    """Phase 8b; returns {kernel: launches} of the counted run."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.resnet import resnet18

    state = TR.init_train_state(resnet18(num_classes=10), TR.sgd(0.1, 0.9),
                                seed=0, compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((CIFAR_STEPS, CIFAR_BATCH, 32, 32, 3),
                         device="cuda", generator=gen)
    labels = torch.randint(0, 10, (CIFAR_STEPS, CIFAR_BATCH), device="cuda",
                           generator=gen, dtype=torch.int32)
    epoch = TR.make_train_epoch(10)
    state, _m = epoch(state, images[:3], labels[:3])  # warm-up
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    state, ms = epoch(state, images, labels)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    losses = ms["loss"].cpu().numpy()
    log(f"[cifar] ResNet-18 (bf16, SGD 0.1 / 0.9) {CIFAR_STEPS} steps of "
        f"batch {CIFAR_BATCH} at 32x32 in {dt:.3f} s = "
        f"{CIFAR_STEPS * CIFAR_BATCH / dt:.0f} samples/s on {card}; launches "
        f"{launches}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if launches != NO_LAUNCHES:
        fail(f"the CIFAR train path launched ported kernels: {launches}")
    if not np.isfinite(losses).all():
        fail(f"CIFAR train losses not finite: {losses}")
    busy = profiled_kernel_ms(lambda: epoch(state, images[:5], labels[:5]),
                              [])
    if busy is not None:
        log(f"[cifar] profiled 5 steps: compute kernels {busy[0] / 5:.3f} ms "
            f"a step on the device against {busy[2] / 5:.3f} ms of wall "
            f"(busy share {busy[0] / busy[2]:.3f})")
    del state, images, labels
    torch.cuda.empty_cache()
    return launches


def deep_vision_path(card):
    """Phase 8c; returns {kernel: launches} of the counted run."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.deep_vision import DeepVisionClassifier

    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (DV_CLASSES, 3))
    labels = rng.integers(0, DV_CLASSES, DV_ROWS)
    noise = rng.normal(0, 20, (DV_ROWS, 32, 32, 3))
    images = np.clip(palette[labels][:, None, None, :] + noise, 0,
                     255).astype(np.uint8)
    table = Table({"image": list(images), "label": labels})
    zero_launches()
    t0 = time.perf_counter()
    model = DeepVisionClassifier(backbone="resnet18", batch_size=DV_BATCH,
                                 epochs=DV_EPOCHS, seed=0).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = read_launches()
    t0 = time.perf_counter()
    out = model.transform(table)
    score_s = time.perf_counter() - t0
    launches = read_launches()
    steps = DV_EPOCHS * math.ceil(DV_ROWS / DV_BATCH)
    chunks = math.ceil(DV_ROWS / 64)
    hist = np.asarray(model.loss_history)
    acc = float((np.asarray(out["prediction"]) == labels).mean())
    log(f"[deep_vision] DeepVisionClassifier(resnet18).fit: {DV_ROWS} uint8 "
        f"32x32 images, {DV_CLASSES} classes, batch {DV_BATCH}, {DV_EPOCHS} "
        f"epochs ({steps} steps) in {fit_s:.3f} s = "
        f"{steps * DV_BATCH / fit_s:.0f} samples/s; loss_history "
        f"{np.array2string(hist, precision=4)}; transform {score_s:.3f} s, "
        f"accuracy on the table {acc:.4f}; launches fit {fit_launches}, "
        f"fit + transform {launches} on {card}")
    if fit_launches != dict(NO_LAUNCHES, affine_resample=steps) or \
            launches != dict(NO_LAUNCHES, affine_resample=steps + chunks):
        fail(f"DeepVisionClassifier: B1 launched {fit_launches} / "
             f"{launches}, expected once a step ({steps}) and once a "
             f"scoring chunk ({chunks})")
    if not np.isfinite(hist).all() or hist[-1] >= hist[0]:
        fail(f"DeepVisionClassifier loss_history not finite or not "
             f"falling: {hist}")
    probs = np.asarray(out["probability"])
    if probs.shape != (DV_ROWS, DV_CLASSES) or not np.isfinite(probs).all():
        fail(f"DeepVisionModel probabilities {probs.shape}")
    torch.cuda.empty_cache()
    return launches


def unroll_bound(x) -> tuple:
    """(bound_ms, bound_by) of one normalize+unroll: the f32 batch read
    once and the f32 rows written once, against a subtract and a multiply
    an element at the f32 peak."""
    n = x.numel()
    t_bytes = 2 * n * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_unroll(K, shape, mean, std, seed, timed=False):
    """B2 against its plain version at one shape; with `timed`, also the
    kernel, plain and library times beside the bound."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, device="cuda", generator=gen) * 255.0
    got = K.fused_normalize_unroll(x, mean, std)
    ref = K.fused_normalize_unroll_plain(x, mean, std)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"unroll {shape}: bad output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    log(f"[kernel] fused_normalize_unroll f32{list(shape)}: "
        f"max_abs_err={err:.3e} (bound {UNROLL_ATOL})")
    if err > UNROLL_ATOL:
        fail(f"unroll {shape}: kernel disagrees with plain version "
             f"(max abs err {err:.3e} > {UNROLL_ATOL})")
    if not timed:
        return {"err": err}
    b, c = shape[0], shape[3]
    mean4 = torch.tensor(mean, device="cuda").expand(c).view(1, c, 1, 1)
    inv4 = (1.0 / torch.tensor(std, dtype=torch.float64, device="cuda")
            ).float().expand(c).view(1, c, 1, 1)
    lib_out = torch.empty((b, c, shape[1], shape[2]), device="cuda")

    def library():
        # stock ops: the subtract reads the permuted view and writes the
        # CHW planes, then an in-place multiply
        torch.sub(x.permute(0, 3, 1, 2), mean4, out=lib_out)
        return lib_out.mul_(inv4).view(b, -1)

    lib_err = float((library() - ref).abs().max())
    calls = {"kernel": lambda: K.fused_normalize_unroll(x, mean, std),
             "plain": lambda: K.fused_normalize_unroll_plain(x, mean, std),
             "library": library}
    ev = {k: cuda_ms(f, 20) for k, f in calls.items()}
    kernel_ms, plain_ms, library_ms = (queued_ms(f) for f in calls.values())
    bound_ms, bound_by = unroll_bound(x)
    log(f"[kernel] fused_normalize_unroll f32{list(shape)}: device time "
        f"(calls queued behind a spin) kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (torch.sub(x.permute(0,3,1,2), mean, "
        f"out=) + mul_(inv); agrees: {lib_err <= UNROLL_ATOL}, "
        f"max_abs_err={lib_err:.3e}); CUDA events over back-to-back calls "
        f"{ev['kernel']:.4f} / {ev['plain']:.4f} / {ev['library']:.4f}; "
        f"bound_ms={bound_ms:.4f} ({bound_by}) "
        f"roofline_share={bound_ms / kernel_ms:.3f}")
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms if lib_err <= UNROLL_ATOL else None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def rle_cases(images):
    """The byte-exactness cases of the decode: the worst case (phase 4's
    64 uniform-random 224x224 images as one chunk) and the JAX package's
    cases (tests/test_wire_codec.py:20-31)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return {
        "uniform_64x224x224x3": np.stack(images[1::len(SIZES)]),
        "zeros": np.zeros((4, 32, 32, 3), np.uint8),
        "quantized": (rng.integers(0, 6, (3, 16, 16, 3)) * 40
                      ).astype(np.uint8),
        "noise": rng.integers(0, 255, (2, 17, 13)).astype(np.uint8),
        "long_runs": np.repeat(np.arange(5, dtype=np.uint8),
                               1000).reshape(10, 500),
        "float32": rng.integers(0, 3, (64,)).astype(np.float32) * 0.5,
        "single": np.array([7], np.uint8),
    }


def check_rle(W, name, arr, timed=False):
    """B3 against its plain version and the raw chunk, exact to the byte;
    with `timed`, also the kernel, plain and library times beside the
    bound.  Returns the largest byte difference (0) and the times."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    p = W.rle_encode(arr)
    enc_s = time.perf_counter() - t0
    v = torch.from_numpy(p.values).cuda()
    e = torch.from_numpy(p.ends).cuda()
    got = W.decode_bytes(v, e, p.n_pad)
    ref = W.decode_bytes_plain(v, e, p.n_pad)
    raw = got.cpu().numpy()
    err = int(np.abs(raw.astype(np.int16)
                     - ref.cpu().numpy().astype(np.int16)).max())
    exact = raw[:p.nbytes_raw].tobytes() == np.ascontiguousarray(arr).tobytes()
    log(f"[kernel] rle_decode {name} {arr.dtype}{list(arr.shape)}: R={len(p.values)} "
        f"n_pad={p.n_pad} ratio={W.rle_ratio(p):.3f} encode {enc_s:.3f} s; "
        f"max_byte_diff vs plain={err}, equals the raw chunk: {exact}")
    if err or not exact:
        fail(f"rle_decode {name}: the decode is not exact to the byte")
    if not timed:
        return {"err": float(err)}
    counts = torch.diff(e.long(), prepend=torch.zeros(1, dtype=torch.int64,
                                                      device="cuda"))
    calls = {"kernel": lambda: W.decode_bytes(v, e, p.n_pad),
             "plain": lambda: W.decode_bytes_plain(v, e, p.n_pad),
             "library": lambda: torch.repeat_interleave(
                 v, counts, output_size=p.n_pad)}
    ev = {k: cuda_ms(f, 20) for k, f in calls.items()}
    kernel_ms, plain_ms, library_ms = (queued_ms(f) for f in calls.values())
    # the runs the chunk needs: up to the one holding byte n_pad - 1 (the
    # power-of-two padding runs after it are never read)
    r_used = int(np.searchsorted(p.ends, p.n_pad - 1, side="right")) + 1
    nbytes = r_used * 5 + p.n_pad
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] rle_decode {name}: device time (calls queued behind a "
        f"spin) "
        f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (torch.repeat_interleave(values, "
        f"counts, output_size=n_pad)); CUDA events over back-to-back calls "
        f"{ev['kernel']:.4f} / {ev['plain']:.4f} / {ev['library']:.4f}; "
        f"bound_ms={bound_ms:.4f} (bytes: 5 R_used + n_pad, R_used={r_used}"
        f" of R={len(p.values)}) "
        f"roofline_share={bound_ms / kernel_ms:.3f}")
    return {"err": float(err), "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes"}


def image_stage_pipeline(S, TorchModel, bundle, device=None, fuse=None):
    """Example 19's chain at the featurizer's size, the ImageNet eval crop:
    ImageTransformer -> UnrollImage -> TorchModel (the `pool` tap)."""
    from mmlspark_tpu_torch import Pipeline

    chain = S.ImageTransformer(fuse=fuse, device=device).resize(
        256, 256).center_crop(IMG, IMG).blur(2.0, 2.0).flip()
    return Pipeline([
        chain,
        S.UnrollImage(output_col="features", mean=list(MEAN_BGR),
                      std=list(STD_BGR), device=device),
        TorchModel(bundle=bundle, input_col="features", fetch_node="pool",
                   batch_size=BATCH, device=device)])


def image_stage_path(K, images, table, repo, card):
    """Phase 10 (a); returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                                  init_state_dict)
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet
    from mmlspark_tpu_torch.ops import image_stages as S

    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    t0 = time.perf_counter()
    model = image_stage_pipeline(S, TorchModel, bundle).fit(table)
    log(f"[stages] Pipeline.fit (runs the two image stages once) "
        f"{time.perf_counter() - t0:.3f} s")
    zero_launches()
    t0 = time.perf_counter()
    out = model.transform(table)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    feats = np.asarray(out["output"])
    log(f"[stages] transform {first_s:.3f} s; launches {launches}")
    want = dict(NO_LAUNCHES, affine_resample=len(SIZES),
                fused_normalize_unroll=1)
    if launches != want:
        fail(f"the image-stage path launched the kernels {launches} times, "
             f"expected {want} (B1 once per input shape group, B2 once for "
             f"the one 224x224 group, nothing inside TorchModel)")
    if feats.shape != (N_IMAGES, 2048) or not np.isfinite(feats).all():
        fail(f"image-stage features: shape {feats.shape}, "
             f"finite={np.isfinite(feats).all()}")
    if not (out["id"] == np.arange(N_IMAGES)).all():
        fail("the image-stage path changed the row order")

    # the ImageTransformer's kernel path against the plain composition on
    # the card, at the JAX package's limits (test_fused_pipeline.py:65-71)
    chain_k, unroll = model.stages[0], model.stages[1]
    rows_k = chain_k.transform(table)["image"]
    chain_p = image_stage_pipeline(S, TorchModel, bundle,
                                   fuse=False).stages[0]
    K.LAUNCHES = 0
    rows_p = chain_p.transform(table)["image"]
    if K.LAUNCHES:
        fail("the fuse=False ImageTransformer launched the resample kernel")
    diffs = [np.abs(a["data"].astype(np.int16) - b["data"].astype(np.int16))
             for a, b in zip(rows_k, rows_p)]
    lsb = max(int(d.max()) for d in diffs)
    share = sum(int((d > 0).sum()) for d in diffs) / sum(d.size for d in diffs)
    log(f"[stages] ImageTransformer kernel rows vs the plain composition "
        f"on the card: max {lsb} LSB (bound 1), share of differing pixel "
        f"values {share:.2e}")
    if lsb > 1 or any(a["data"].shape != (IMG, IMG, 3) for a in rows_k):
        fail("the ImageTransformer's kernel rows disagree with the plain "
             "composition")

    # UnrollImage against B2's plain version on the same rows
    vecs = np.asarray(list(unroll.transform(Table({"image": rows_k}))[
        "features"]))
    batch = torch.from_numpy(np.stack([r["data"] for r in rows_k])).cuda()
    plain = K.fused_normalize_unroll_plain(batch.float(), MEAN_BGR,
                                           STD_BGR).cpu().numpy()
    err_unroll = float(np.abs(vecs - plain).max())
    log(f"[stages] UnrollImage vectors vs B2's plain version: "
        f"max_abs_err={err_unroll:.3e} (bound {UNROLL_ATOL}); dtype "
        f"{vecs.dtype}")
    if err_unroll > UNROLL_ATOL or vecs.dtype != np.float64:
        fail("UnrollImage's vectors disagree with B2's plain version")

    # the whole pipeline, bf16 on the card against f32 on the CPU, on a
    # ResNet-50 whose BatchNorms are all random (as phase 4)
    few_table = Table({"image": [images[i] for i in range(4)]})
    check_state = init_state_dict(get_builder("resnet50")(num_classes=1000),
                                  seed=1, random_bn=True)
    side = {}
    for dev, dtype in (("cuda", "bfloat16"), ("cpu", "float32")):
        check_bundle = TorchBundle("resnet50", {"num_classes": 1000},
                                   state_dict=check_state,
                                   input_shape=(IMG, IMG, 3), dtype=dtype)
        pipe = image_stage_pipeline(S, TorchModel, check_bundle, device=dev)
        side[dev] = np.asarray(pipe.fit(few_table).transform(few_table)[
            "output"])
    err_cpu = rel_l2(side["cuda"], side["cpu"])
    log(f"[stages] features (random-BatchNorm ResNet-50, bf16 on the card) "
        f"vs an f32 CPU run of the whole pipeline on 4 images: "
        f"rel_l2={err_cpu:.3e} (bound {CPU_FEATURES_RTOL})")
    if err_cpu > CPU_FEATURES_RTOL:
        fail("image-stage features disagree with the f32 CPU run")

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.transform(table)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    log(f"[stages] Pipeline(ImageTransformer -> UnrollImage -> TorchModel "
        f"resnet50 pool), {N_IMAGES} images, 3 runs: images/s min "
        f"{N_IMAGES / walls[-1]:.0f}, median {N_IMAGES / walls[1]:.0f}, "
        f"max {N_IMAGES / walls[0]:.0f} (walls {walls[0]:.4f}-"
        f"{walls[-1]:.4f} s) on {card}")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler dropped the kernels of the first milliseconds of a
        # session late in this process (B1's 3 launches open the path)
        time.sleep(PROFILE_LEAD_S)
        t0 = time.perf_counter()
        model.transform(table)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    total_us, by_us = device_events_us(
        prof, ["affine_resample", "normalize_unroll"], copies=False)
    copy_us = device_events_us(prof, [], copies=True)[0] - total_us
    seen = {n: c for n, (_us, c) in by_us.items()}
    if seen != {"affine_resample": len(SIZES), "normalize_unroll": 1}:
        log(f"[stages] profiled run: the profiler saw {seen} of the path's "
            f"kernel launches, not all (shares not measured)")
    else:
        b1, b2 = by_us["affine_resample"][0], by_us["normalize_unroll"][0]
        rest = total_us - b1 - b2
        log(f"[stages] profiled run: compute kernels {total_us / 1e3:.3f} ms "
            f"on the device, of which B1 {b1 / 1e3:.4f} ms "
            f"({b1 / total_us:.4f}), B2 {b2 / 1e3:.4f} ms "
            f"({b2 / total_us:.4f}), the rest (the ResNet-50 forward and the "
            f"stages' casts) {rest / 1e3:.3f} ms ({rest / total_us:.4f}); "
            f"copies {copy_us / 1e3:.3f} ms; the profiled run's wall "
            f"{wall_ms:.3f} ms; kernels / median unprofiled wall = "
            f"{total_us / (walls[1] * 1e6):.3f}")
    del model
    torch.cuda.empty_cache()
    return launches, err_unroll


def compressed_wire_path(W, card):
    """Phase 10 (c); returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.io.feed import DeviceFeed, FeedTelemetry

    rng = np.random.default_rng(0)
    blk = 8
    chunks = [(rng.integers(0, 6, (RLE_CHUNK, RLE_SIDE, RLE_SIDE // blk, 1))
               * 40).astype(np.uint8).repeat(blk, axis=2).repeat(3, axis=3)
              for _ in range(RLE_CHUNKS)]
    t0 = time.perf_counter()
    payloads = [W.rle_encode(c) for c in chunks]
    enc_s = time.perf_counter() - t0
    feed = DeviceFeed(torch.device("cuda"), telemetry=FeedTelemetry())
    feed.put_group([payloads[0]])  # warm the ring slot
    tel = feed.telemetry = FeedTelemetry()
    zero_launches()
    t0 = time.perf_counter()
    outs, means = [], []
    for p in payloads:
        (x,) = feed.put_group([p])
        outs.append(x)
        means.append(x.float().mean(dim=(1, 2, 3)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    snap = tel.snapshot()
    ratio = snap["wire_bytes_raw"] / snap["wire_bytes_sent"]
    log(f"[wire] {RLE_CHUNKS} compressed groups of {RLE_CHUNK}x{RLE_SIDE}x"
        f"{RLE_SIDE}x3 uint8: R={len(payloads[0].values)} runs a chunk, "
        f"wire ratio {ratio:.3f} ({snap['wire_bytes_raw']:.0f} raw / "
        f"{snap['wire_bytes_sent']:.0f} sent bytes), host encode "
        f"{enc_s:.3f} s, put_group + decode + mean {wall:.4f} s; launches "
        f"{launches} on {card}")
    if launches != dict(NO_LAUNCHES, rle_decode=RLE_CHUNKS):
        fail(f"the compressed wire launched the kernels {launches} times, "
             f"expected rle_decode once per chunk ({RLE_CHUNKS})")
    if snap["compressed_groups"] != RLE_CHUNKS:
        fail(f"compressed_groups {snap['compressed_groups']}")
    for c, x in zip(chunks, outs):
        if x.dtype != torch.uint8 or tuple(x.shape) != c.shape or \
                x.cpu().numpy().tobytes() != c.tobytes():
            fail("a decoded chunk differs from its raw chunk")
    plain_means = [feed.put(c).float().mean(dim=(1, 2, 3)) for c in chunks]
    if not all(torch.equal(a, b) for a, b in zip(means, plain_means)):
        fail("the compressed chunks' means differ from the plain put's")
    log("[wire] every decoded chunk equals its raw chunk byte for byte; "
        "the f32 means equal the plain put path's")
    return launches, chunks[0]


def ycc_bound(layout, planes) -> tuple:
    """(bound ms, "bytes") of C2 on one image: its planes read once and
    the BGR image written once, over the card's memory rate (a few integer
    operations a byte: far below the compute bound)."""
    nbytes = sum(p.size for p in planes) + layout.height * layout.width * 3
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def check_ycc(native, blobs):
    """Phase 11 (c): C2 against its plain version on every colour
    fixture's nvJPEG planes, byte for byte, and against the decoder's own
    output; timed at the JPEG path's three image sizes (one of each,
    summed).  Returns the record's numbers."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.jpeg_color import ycc_to_bgr, ycc_to_bgr_plain

    timed = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    sizes_timed = set()
    err = 0
    for name in sorted(blobs):
        got = native.decode_jpeg_planes(blobs[name])
        if got is None or len(got[1]) != 3:
            continue  # gray: no C2; CMYK: refused
        layout, planes = got
        args = ([torch.from_numpy(p).cuda() for p in planes], layout.factors,
                layout.height, layout.width, layout.color)
        kern = ycc_to_bgr(*args)
        plain = ycc_to_bgr_plain(*args)
        torch.cuda.synchronize()
        decoded = native.decode_jpeg_bgr(blobs[name])
        e = int((kern.int() - plain.int()).abs().max())
        err = max(err, e)
        same_route = np.array_equal(kern.cpu().numpy(), decoded)
        log(f"[c2] {name} {layout.height}x{layout.width} factors "
            f"{layout.factors} planes {[p.shape for p in planes]}: kernel vs "
            f"plain max abs diff {e}; kernel == the decoder's pixels: "
            f"{same_route}")
        if e != 0 or not same_route:
            fail(f"C2 on {name}: the kernel differs from its plain version "
                 f"({e}) or from the decode ({same_route})")
        hw = (layout.height, layout.width)
        if name.startswith("bench_") and hw not in sizes_timed:
            sizes_timed.add(hw)
            ms = queued_ms(lambda: ycc_to_bgr(*args))
            plain_ms = cuda_ms(lambda: ycc_to_bgr_plain(*args), 10)
            bound, _ = ycc_bound(layout, planes)
            log(f"[c2] {hw}: kernel {ms:.4f} ms (queued behind a spin), "
                f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes) on "
                f"one image")
            timed = {"ms": timed["ms"] + ms,
                     "plain_ms": timed["plain_ms"] + plain_ms,
                     "bound_ms": timed["bound_ms"] + bound}
    if len(sizes_timed) != len(SIZES):
        fail(f"C2 timed at {sorted(sizes_timed)}, not the three sizes")
    return dict(timed, err=err, bound_by="bytes", library_ms=None)


def _state_numbers(state):
    """{name: host tensor} of every number a TrainState holds: masters and
    buffers, optimizer state, the bf16 working copy, the step."""
    out = {f"module/{k}": v.detach().cpu().clone()
           for k, v in state.module.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"optimizer/{i}/{k}"] = v.detach().cpu().clone()
    for i, p in enumerate(state.work.parameters()):
        out[f"work/{i}"] = p.detach().cpu().clone()
    return out


def _max_diff(a, b) -> tuple:
    """(leaves not bit-equal, max abs difference) of two number dicts."""
    import torch

    if sorted(a) != sorted(b):
        fail(f"the states hold other leaves: {sorted(set(a) ^ set(b))}")
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    diff = max([float((a[k].double() - b[k].double()).abs().max())
                for k in bad] or [0.0])
    return bad, diff


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _sub, files in os.walk(path) for f in files)


def resumable_train_path(card):
    """Phase 11 (a); returns {kernel: launches} of the counted runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import telemetry
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.checkpoint import CheckpointManager
    from mmlspark_tpu_torch.models.guard import TrainingGuard
    from mmlspark_tpu_torch.models.resnet import resnet18
    from mmlspark_tpu_torch.utils.faults import (FAULTS, FaultPlan,
                                                 InjectedCrash)

    steps_per_epoch = CIFAR_STEPS // 2
    rng = np.random.default_rng(0)
    n = steps_per_epoch * CIFAR_BATCH
    images = rng.standard_normal((n, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    root = tempfile.mkdtemp(prefix="resume-", dir=os.path.join(ROOT, "build"))

    def fresh():
        return TR.init_train_state(resnet18(num_classes=10),
                                   TR.sgd(0.1, 0.9), seed=0,
                                   compute_dtype="bfloat16")

    def fit(name, **kw):
        kw = dict(dict(epochs=2, checkpoint_every=RESUME_EVERY, seed=0), **kw)
        step = None if "step_factory" in kw else TR.make_train_step(10)
        return TR.fit_epochs_resumable(step, fresh(), images, labels,
                                       CIFAR_BATCH, os.path.join(root, name),
                                       **kw)

    try:
        zero_launches()
        t0 = time.perf_counter()
        ref, ref_m = fit("ref")
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        crash = FaultPlan(seed=1).on("training.step", nth=[RESUME_KILL_AT],
                                     error=InjectedCrash)
        try:
            with FAULTS.arm(crash):
                fit("kill")
            fail("the injected kill at step "
                 f"{RESUME_KILL_AT} did not stop fit_epochs_resumable")
        except InjectedCrash:
            pass
        kept = sorted(int(d) for d in os.listdir(os.path.join(root, "kill"))
                      if d.isdigit())
        resumes = telemetry.counters().get("training.resume", 0)
        res, res_m = fit("kill")
        torch.cuda.synchronize()
        resumed = telemetry.counters().get("training.resume", 0) - resumes
        launches = read_launches()
        bad, diff = _max_diff(_state_numbers(ref), _state_numbers(res))
        log(f"[resume] ResNet-18 CIFAR (bf16, SGD 0.1 / 0.9, batch "
            f"{CIFAR_BATCH}) through fit_epochs_resumable, {CIFAR_STEPS} "
            f"steps, a checkpoint every {RESUME_EVERY}: uninterrupted "
            f"{ref_s:.3f} s, loss {ref_m['loss']:.6f}; killed at step "
            f"{RESUME_KILL_AT} (checkpoints left {kept}), resumed "
            f"({resumed} resume) to step {res.step}, loss "
            f"{res_m['loss']:.6f}; {len(bad)} leaves differ, max abs diff "
            f"{diff:.3e}; launches {launches} on {card}")
        if kept != [RESUME_EVERY, 2 * RESUME_EVERY] or resumed != 1:
            fail(f"the kill left checkpoints {kept}, resumed {resumed}")
        if bad or res.step != ref.step or res_m != ref_m:
            fail(f"the resumed run is not the uninterrupted one bit for "
                 f"bit: {bad[:5]} (max abs diff {diff:.3e})")
        if launches != NO_LAUNCHES:
            fail(f"the CIFAR train path launched ported kernels: {launches}")

        # the guard drill: a poisoned batch before the first periodic
        # checkpoint rolls back to the floor checkpoint (step 0)
        guard = TrainingGuard(hang_timeout_s=600.0)
        rollbacks = telemetry.counters().get("training.rollback", 0)
        drill = FaultPlan(seed=5).on("training.loss_nan", nth=[RESUME_NAN_AT])
        with FAULTS.arm(drill):
            g_state, g_m = fit("guard", guard=guard, step_factory=lambda s:
                               TR.make_train_step(10, lr_scale=s))
        with open(os.path.join(root, "guard", "quarantine.json")) as f:
            quarantined = json.load(f)["quarantined"]
        spans = [sp for sp in telemetry.recent_spans()
                 if sp.get("name") == "training.guard.rollback"]
        restored = spans[-1]["attrs"].get("restored_step") if spans else None
        log(f"[resume] guard drill: training.loss_nan at step "
            f"{RESUME_NAN_AT}: quarantined {sorted(guard.quarantined)}, "
            f"rollbacks {guard.rollbacks} (to step {restored}), lr scale "
            f"{guard.lr_scale}, final step {g_state.step}, loss "
            f"{g_m['loss']:.6f}; quarantine.json {quarantined}")
        if (guard.quarantined != {RESUME_NAN_AT} or guard.rollbacks != 1 or
                telemetry.counters().get("training.rollback", 0)
                != rollbacks + 1 or restored != 0 or
                quarantined != [RESUME_NAN_AT] or
                g_state.step != CIFAR_STEPS - 1 or
                not math.isfinite(g_m["loss"])):
            fail("the guard drill did not quarantine, roll back to the "
                 "floor and finish")
        if not all(torch.isfinite(v).all() for v in
                   _state_numbers(g_state).values()):
            fail("the guard drill left a non-finite number in the state")

        # checkpoint costs: a save of the final state, its verified
        # restore into a live state, the verification alone
        mgr = CheckpointManager(os.path.join(root, "cost"))
        t0 = time.perf_counter()
        mgr.save(ref, step=CIFAR_STEPS)
        save_s = time.perf_counter() - t0
        nbytes = _dir_bytes(os.path.join(root, "cost", str(CIFAR_STEPS)))
        hist = telemetry.histogram("checkpoint.verify.latency")
        v0 = hist.snapshot()
        target = fresh()
        t0 = time.perf_counter()
        mgr.restore(CIFAR_STEPS, template=target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        v1 = hist.snapshot()
        verify_s = v1["sum"] - v0["sum"]
        bad, _ = _max_diff(_state_numbers(ref), _state_numbers(target))
        log(f"[resume] checkpoint of the ResNet-18 state: {nbytes} bytes "
            f"in {len(os.listdir(os.path.join(root, 'cost', str(CIFAR_STEPS))))}"
            f" files, save {save_s:.4f} s (synchronous, fsync'd), restore "
            f"{restore_s:.4f} s of which crc32 verification {verify_s:.4f} s;"
            f" restored state bit-equal: {not bad}")
        if bad:
            fail(f"a checkpoint round trip changed {bad[:5]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def deep_vision_resume_path(card):
    """Phase 11 (b); returns ({kernel: launches} of the counted fits, the
    uninterrupted fit's DeepVisionModel, its bytes table)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.deep_vision import DeepVisionClassifier

    blobs, _digests = jpeg_fixtures()
    names = sorted(n for n in blobs if n.startswith("bench_"))
    column = [blobs[names[i % len(names)]] for i in range(DVJ_ROWS)]
    labels = np.array([i % len(names) % 2 for i in range(DVJ_ROWS)])
    table = Table({"image": column, "label": labels})
    root = tempfile.mkdtemp(prefix="dv-", dir=os.path.join(ROOT, "build"))
    steps = math.ceil(DVJ_ROWS / DVJ_BATCH)
    kw = dict(backbone="resnet18", height=IMG, width=IMG,
              batch_size=DVJ_BATCH, seed=0)
    counted = dict(NO_LAUNCHES)
    try:
        runs = {}
        for name, epochs, ckpt in (("full", 2, ""), ("first", 1, root),
                                   ("resumed", 2, root)):
            zero_launches()
            t0 = time.perf_counter()
            runs[name] = DeepVisionClassifier(
                epochs=epochs, checkpoint_dir=ckpt, **kw).fit(table)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = read_launches()
            trained = epochs if name != "resumed" else 1
            want = dict(NO_LAUNCHES, affine_resample=steps * trained,
                        ycc_to_bgr=DVJ_ROWS)
            log(f"[dv-resume] {name}: DeepVisionClassifier(resnet18, "
                f"{IMG}x{IMG}, batch {DVJ_BATCH}, epochs={epochs}"
                f"{', checkpoint_dir' if ckpt else ''}) on {DVJ_ROWS} JPEG "
                f"bytes rows in {dt:.3f} s; loss_history "
                f"{runs[name].loss_history}; launches {launches}")
            if launches != want:
                fail(f"DeepVisionClassifier {name}: launches {launches}, "
                     f"expected {want} (B1 once a step, C2 once a row)")
            counted = {k: counted[k] + launches[k] for k in KERNELS}
        a = runs["full"].bundle.state_dict
        b = runs["resumed"].bundle.state_dict
        bad = [k for k in a if not np.array_equal(np.asarray(a[k]),
                                                  np.asarray(b[k]))]
        diff = max([float(np.abs(np.asarray(a[k], np.float64)
                                 - np.asarray(b[k], np.float64)).max())
                    for k in bad] or [0.0])
        log(f"[dv-resume] 1 + 1 epochs on one checkpoint_dir "
            f"(checkpoints {sorted(os.listdir(root))}) against 2 epochs: "
            f"{len(bad)} tensors differ, max abs diff {diff:.3e} on {card}")
        if bad or runs["resumed"].loss_history != \
                runs["full"].loss_history[1:] or \
                runs["first"].loss_history != runs["full"].loss_history[:1]:
            fail(f"the resumed DeepVisionClassifier fit is not the "
                 f"uninterrupted one: {bad[:5]} (max abs diff {diff:.3e})")
        if not all(math.isfinite(v) for v in runs["full"].loss_history):
            fail("DeepVisionClassifier on JPEG bytes: non-finite loss")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counted, runs["full"], table


def _clear_executor_caches() -> None:
    """Drop every cached device module: the caches key on `bundle_id`,
    which a saved bundle keeps, so a loaded stage would otherwise reuse
    the unsaved stage's module."""
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models import torch_model as TM

    TM._EXEC_CACHE.clear()
    G._MODULES.clear()
    torch.cuda.empty_cache()


def _save_load_check(label, stage, table, want_launches, card):
    """Save `stage`, clear the executor caches, load it, transform `table`
    on the card; the output must equal the unsaved stage's bit for bit
    and launch exactly `want_launches`.  Returns (launches, save s, load
    s, bytes on disk)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    want = stage.transform(table)
    root = tempfile.mkdtemp(prefix="persist-", dir=os.path.join(ROOT, "build"))
    try:
        path = os.path.join(root, "stage")
        t0 = time.perf_counter()
        stage.save(path)
        save_s = time.perf_counter() - t0
        size = _dir_bytes(path)
        _clear_executor_caches()
        t0 = time.perf_counter()
        loaded = PipelineStage.load(path)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    zero_launches()
    got = loaded.transform(table)
    torch.cuda.synchronize()
    launches = read_launches()
    same = got.approx_equals(want, rtol=0.0, atol=0.0)
    diffs = [float(np.abs(got[c].astype(np.float64)
                          - want[c].astype(np.float64)).max())
             for c in want.column_names
             if c in got.column_names and want[c].dtype.kind == "f"
             and got[c].shape == want[c].shape]
    log(f"[persist] {label}: saved in {save_s:.4f} s ({size} bytes on "
        f"disk), loaded in {load_s:.4f} s; the loaded stage's transform "
        f"equals the unsaved one's bit for bit: {same} (largest float "
        f"difference {max(diffs or [0.0]):.3e}); launches {launches} on "
        f"{card}")
    if not same:
        fail(f"{label}: the loaded stage's output differs from the unsaved "
             f"stage's")
    if launches != want_launches:
        fail(f"{label}: the loaded stage launched {launches}, expected "
             f"{want_launches}")
    return launches, save_s, load_s, size


def persistence_path(table, repo, n_chunks, dv_model, dv_table, card):
    """Phase 12 (a); returns {kernel: launches} of the loaded stages'
    transforms."""
    import numpy as np
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.torch_model import (ImagePreprocess,
                                                       TorchModel)
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet
    from mmlspark_tpu_torch.ops import image_stages as S

    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    total = dict(NO_LAUNCHES)

    def add(launches):
        for k in KERNELS:
            total[k] += launches[k]

    # the featurizer's own TorchModel over phase 4's uint8 table
    model = TorchModel(bundle=bundle, input_col="image", fetch_node="pool",
                       batch_size=BATCH,
                       preprocess=ImagePreprocess(IMG, IMG, MEAN_BGR,
                                                  STD_BGR),
                       group_by_shape=True, feed_dtype="uint8")
    launches, save_s, load_s, size = _save_load_check(
        "ResNet-50 TorchModel (uint8 table)", model, table,
        dict(NO_LAUNCHES, affine_resample=n_chunks), card)
    add(launches)
    log(f"[persist] ResNet-50 TorchModel: save {save_s:.4f} s, load "
        f"{load_s:.4f} s, {size} bytes on disk ({size / 2**20:.1f} MiB; the "
        f"f32 state dict {sum(v.nbytes for v in bundle.state_dict.values())}"
        f" bytes) on {card}")

    # the featurizer over phase 4b's JPEG bytes column
    blobs, _digests = jpeg_fixtures()
    by_size = {hw: [n for n in sorted(blobs) if n.startswith("bench_") and
                    n.endswith(f"_{hw[0]}x{hw[1]}.jpg")] for hw in SIZES}
    column = [blobs[by_size[SIZES[i % 3]][(i // 3) % 2]]
              for i in range(N_IMAGES)]
    add(_save_load_check(
        "ResNet-50 ImageFeaturizer (JPEG bytes)",
        ImageFeaturizer(bundle=bundle, batch_size=BATCH),
        Table({"image": column, "id": np.arange(N_IMAGES)}),
        dict(NO_LAUNCHES, affine_resample=n_chunks, ycc_to_bgr=N_IMAGES),
        card)[0])

    # phase 10's fitted PipelineModel
    pipeline_model = image_stage_pipeline(S, TorchModel, bundle).fit(table)
    add(_save_load_check(
        "phase 10's PipelineModel (ImageTransformer -> UnrollImage -> "
        "TorchModel)", pipeline_model, table,
        dict(NO_LAUNCHES, affine_resample=len(SIZES),
             fused_normalize_unroll=1), card)[0])

    # phase 11 (b)'s fitted DeepVisionModel over its bytes column: B1 once
    # a scoring chunk (64 rows of one size), C2 once a row
    size_of = {blobs[n]: n.rsplit("_", 1)[1] for n in blobs
               if n.startswith("bench_")}
    per_size = {}
    for blob in dv_table["image"]:
        per_size[size_of[bytes(blob)]] = per_size.get(
            size_of[bytes(blob)], 0) + 1
    chunks = sum(math.ceil(n / 64) for n in per_size.values())
    add(_save_load_check(
        "phase 11 (b)'s DeepVisionModel (JPEG bytes)", dv_model, dv_table,
        dict(NO_LAUNCHES, affine_resample=chunks,
             ycc_to_bgr=len(dv_table["image"])), card)[0])
    _clear_executor_caches()
    return total


def int8_vit_path(images, table, repo, n_chunks, card):
    """Phase 12 (b), the ViT: ImageFeaturizer over a ViT-B/16 with
    quant=True (int8 blocks, bf16 elsewhere) on phase 4's table; returns
    {kernel: launches}."""
    import numpy as np
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet
    from mmlspark_tpu_torch.ops import quant as Q

    base = get_or_create_resnet("vit_base", (IMG, IMG, 3), 1000, repo=repo)
    qbundle = TorchBundle("vit_base", dict(base.builder_kwargs, quant=True),
                          state_dict=base.state_dict,
                          input_shape=(IMG, IMG, 3))
    bf16 = ImageFeaturizer(bundle=base, batch_size=BATCH)
    int8 = ImageFeaturizer(bundle=qbundle, batch_size=BATCH)
    layers = 12
    zero_launches()
    Q.INT8_GEMMS = 0
    out = int8.transform(table)
    launches, gemms = read_launches(), Q.INT8_GEMMS
    feats = out["features"]
    want = dict(NO_LAUNCHES, affine_resample=n_chunks,
                flash_attention_fwd=layers * n_chunks)
    log(f"[int8-vit] ViT-B/16 quant=True (bf16 outside the int8 layers): "
        f"launches {launches}, int8 GEMMs {gemms} (chunks={n_chunks})")
    if launches != want or gemms != 4 * layers * n_chunks:
        fail(f"the int8 ViT launched {launches} and {gemms} int8 GEMMs, "
             f"expected {want} and 4 a block a chunk ({4 * layers * n_chunks})")
    if feats.shape != (N_IMAGES, 768) or not np.isfinite(feats).all():
        fail(f"int8 ViT features: shape {feats.shape}, "
             f"finite={np.isfinite(feats).all()}")
    if not (out["id"] == np.arange(N_IMAGES)).all():
        fail("the int8 ViT path changed the row order")

    # the reference's own bound (tests/test_quant.py:43-57): correlated
    # with the unquantized model's output on the same weights
    plain = bf16.transform(table)["features"]
    corr = float(np.corrcoef(feats.ravel(), plain.ravel())[0, 1])
    log(f"[int8-vit] features vs the bf16 ViT-B/16 on the same weights: "
        f"correlation {corr:.5f} (bound > {INT8_CORR}), rel_l2 "
        f"{rel_l2(feats, plain):.3e}")
    if not corr > INT8_CORR:
        fail("the int8 ViT's features are not correlated with the bf16 "
             "ViT's")

    # the card (bf16 + int8) against an f32 CPU run of the same quant
    # bundle on the same few images: a chunk's rows share one activation
    # scale a layer, so both sides run the same chunks
    few = [i for s in range(len(SIZES)) for i in range(s, 6, len(SIZES))]
    few_table = Table({"image": [images[i] for i in few]})
    card_few = int8.transform(few_table)["features"]
    cpu_bundle = TorchBundle("vit_base", qbundle.builder_kwargs,
                             state_dict=base.state_dict,
                             input_shape=(IMG, IMG, 3), dtype="float32")
    cpu_few = ImageFeaturizer(bundle=cpu_bundle, batch_size=BATCH,
                              device="cpu").transform(few_table)["features"]
    err_cpu = rel_l2(card_few, cpu_few)
    log(f"[int8-vit] features (bf16 + int8 on the card) vs an f32 CPU run "
        f"of the same quant bundle on {len(few)} images: rel_l2="
        f"{err_cpu:.3e} (bound {INT8_VIT_CPU_RTOL})")
    if err_cpu > INT8_VIT_CPU_RTOL:
        fail("the int8 ViT's features disagree with the f32 CPU run")

    walls = {}
    for label, f in (("vit bf16", bf16), ("vit int8", int8),
                     ("vit bf16", bf16), ("vit int8", int8)):
        walls.setdefault(label, []).append(
            timed_transforms(f, table, label, card, n_runs=3))
    log(f"[int8-vit] median walls in turns: bf16 {walls['vit bf16']} s, "
        f"int8 {walls['vit int8']} s = images/s bf16 "
        f"{[round(N_IMAGES / w) for w in walls['vit bf16']]}, int8 "
        f"{[round(N_IMAGES / w) for w in walls['vit int8']]} on {card}")
    del bf16, int8
    _clear_executor_caches()
    return launches


def int8_lm_path(card):
    """Phase 12 (b), the LM: phase 6's GPT-small with quant=True,
    prequantized, through `generate` and a paged ContinuousBatcher;
    returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle, prequantize
    from mmlspark_tpu_torch.ops import quant as Q
    from mmlspark_tpu_torch.serving import batcher as SB

    layers = LM["num_layers"]
    per_forward = 4 * layers + 1  # qkv, proj, mlp_in, mlp_out; the head
    base = TorchBundle("transformer_lm", LM, input_shape=(LM_PROMPT,),
                       seed=0)
    t0 = time.perf_counter()
    qbundle = prequantize(TorchBundle(
        "transformer_lm", dict(LM, quant=True), state_dict=base.state_dict,
        input_shape=(LM_PROMPT,)))
    log(f"[int8-lm] prequantized GPT-small in "
        f"{time.perf_counter() - t0:.2f} s (int8 bytes "
        f"{sum(v.nbytes for k, v in qbundle.state_dict.items() if k.endswith('.wq'))})")
    prompt = np.random.default_rng(0).integers(
        0, LM["vocab_size"], (LM_BATCH, LM_PROMPT)).astype(np.int32)
    total = dict(NO_LAUNCHES)

    zero_launches()
    Q.INT8_GEMMS = 0
    out = G.generate(qbundle, prompt, LM_NEW)
    torch.cuda.synchronize()
    launches, gemms = read_launches(), Q.INT8_GEMMS
    log(f"[int8-lm] generate (batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_NEW} new tokens): launches {launches}, int8 GEMMs {gemms}")
    want = dict(NO_LAUNCHES, flash_attention_fwd=layers)
    if launches != want or gemms != per_forward * LM_NEW:
        fail(f"the int8 LM launched {launches} and {gemms} int8 GEMMs, "
             f"expected {want} and {per_forward} a forward over 1 prefill "
             f"and {LM_NEW - 1} decode steps")
    for k in KERNELS:
        total[k] += launches[k]
    toks = out.cpu().numpy()
    if toks.shape != (LM_BATCH, LM_PROMPT + LM_NEW) or \
            not (toks[:, :LM_PROMPT] == prompt).all() or \
            toks.min() < 0 or toks.max() >= LM["vocab_size"]:
        fail(f"int8 generate returned {toks.shape}, or tokens outside the "
             f"vocab or a changed prompt")
    module = G._module_for(qbundle, torch.device("cuda"))
    if module.blocks[0].qkv.weight.dtype != torch.float32 or \
            module.blocks[0].qkv.wq.dtype != torch.int8 or \
            module.ln_f.weight.dtype != torch.bfloat16:
        fail("the int8 LM's layers are not f32 master + int8 copy in a "
             "bf16 module")
    cpu_bundle = TorchBundle("transformer_lm", qbundle.builder_kwargs,
                             state_dict=qbundle.state_dict,
                             input_shape=(LM_PROMPT,), dtype="float32")
    short = torch.from_numpy(prompt[:2, :LM_CPU_PROMPT])
    with torch.inference_mode():
        card_short = module(short.cuda())[0].cpu().numpy()
        cpu_short = cpu_bundle.module(torch.device("cpu"))(short)[0].numpy()
    err_cpu = rel_l2(card_short, cpu_short)
    log(f"[int8-lm] prefill logits (bf16 + int8 on the card) vs an f32 CPU "
        f"prefill of the same prequantized bundle, {LM_CPU_PROMPT}-token "
        f"prompt, batch 2: rel_l2={err_cpu:.3e} (bound {LM_CPU_RTOL})")
    if err_cpu > LM_CPU_RTOL:
        fail("the int8 LM's prefill logits disagree with the f32 CPU run")

    # decode tokens/s, bf16 and int8 in turns after one untimed turn each
    # (eager decode steps after one prefill), and whole generate walls
    modules = {"bf16": G._module_for(base, torch.device("cuda")),
               "int8": module}
    p_cuda = torch.from_numpy(prompt).cuda()
    steps = LM_NEW - 1
    rates = {"bf16": [], "int8": []}
    walls = {"bf16": [], "int8": []}
    with torch.inference_mode():
        for turn, name in enumerate(["bf16", "int8"] * 4):
            m = modules[name]
            _logits, cache = G._prefill_cache(m, p_cuda)
            tok = torch.zeros((LM_BATCH, 1), dtype=torch.int32,
                              device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                lg, cache = m.decode_step(tok, cache, LM_PROMPT + i)
                tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            rate = LM_BATCH * steps / (time.perf_counter() - t0)
            del cache
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            G.generate(base if name == "bf16" else qbundle, prompt, LM_NEW)
            torch.cuda.synchronize()
            if turn >= 2:
                rates[name].append(rate)
                walls[name].append(time.perf_counter() - t0)
    med = {k: sorted(v)[len(v) // 2] for k, v in rates.items()}
    log(f"[int8-lm] eager decode (batch {LM_BATCH}, {steps} steps after a "
        f"{LM_PROMPT}-token prefill), 3 turns each after a warm-up turn: "
        f"bf16 {[round(r) for r in rates['bf16']]} tokens/s, int8 "
        f"{[round(r) for r in rates['int8']]} tokens/s (medians int8 / bf16"
        f" {med['int8'] / med['bf16']:.3f}); whole generate walls bf16 "
        f"{[round(w, 4) for w in walls['bf16']]} s, int8 "
        f"{[round(w, 4) for w in walls['int8']]} s on {card}")
    del modules
    G._MODULES.clear()
    torch.cuda.empty_cache()

    # a paged ContinuousBatcher on the prequantized bundle
    rng = np.random.default_rng(3)
    lens = rng.integers(16, 301, INT8_SERVE_REQUESTS)
    prompts = [rng.integers(0, LM["vocab_size"], n).astype(np.int32)
               for n in lens]
    batcher = SB.ContinuousBatcher(qbundle, max_slots=SERVE_SLOTS,
                                   paged=True, page_size=PAGE).start()
    prefill = PrefillCounter()
    try:
        zero_launches()
        Q.INT8_GEMMS = 0
        ticks0 = batch_fill_count()
        t0 = time.perf_counter()
        got = [st.tokens(timeout=STREAM_WAIT_S) for st in
               [batcher.submit(p, INT8_SERVE_NEW) for p in prompts]]
        wall = time.perf_counter() - t0
        launches, gemms = read_launches(), Q.INT8_GEMMS
        ticks = batch_fill_count() - ticks0
    finally:
        prefill.remove()
        batcher.stop()
    want = dict(NO_LAUNCHES, flash_attention_fwd=layers * prefill.forwards,
                paged_decode_attention=layers * ticks)
    log(f"[int8-lm] paged ContinuousBatcher ({SERVE_SLOTS} slots, page "
        f"{PAGE}) on the prequantized bundle: {INT8_SERVE_REQUESTS} requests "
        f"(prompts {lens.min()}..{lens.max()}), {INT8_SERVE_NEW} new tokens "
        f"each in {wall:.3f} s = {INT8_SERVE_REQUESTS * INT8_SERVE_NEW / wall:.0f}"
        f" tokens/s; {ticks} ticks, admission prefills {prefill.shapes}; "
        f"launches "
        f"{launches}, int8 GEMMs {gemms} on {card}")
    if launches != want or ticks == 0:
        fail(f"the int8 batcher launched {launches}, expected {want} (B7 "
             f"once a layer a tick, B4 once a layer an admission prefill)")
    if gemms != per_forward * (ticks + prefill.forwards):
        fail(f"the int8 batcher ran {gemms} int8 GEMMs, expected "
             f"{per_forward} a forward over {ticks} ticks and "
             f"{prefill.forwards} prefills")
    if any(len(t) != INT8_SERVE_NEW for t in got) or \
            min(min(t) for t in got) < 0 or \
            max(max(t) for t in got) >= LM["vocab_size"]:
        fail(f"int8 batcher: stream lengths {[len(t) for t in got]} or "
             f"tokens outside the vocabulary")
    for k in KERNELS:
        total[k] += launches[k]
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return total


def first_mismatch_or_tie(label, module, prompt, got, ref):
    """`got` against the reference tokens `ref` of `prompt`, with
    compare_streams' tie rule; True when equal."""
    compare_streams(label, module, [prompt], [list(got)], [list(ref)], None)
    return list(got) == list(ref)


def moe_train_path(card):
    """Phase 13 (a), training: the MoE GPT-small (8 experts, capacity
    1.25, every block) through `make_lm_train_epoch`, bf16 over f32
    masters, Adam; returns ({kernel: launches}, the trained bundle)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.bundle import (TorchBundle, get_builder,
                                                  init_state_dict)

    cfg = dict(MOE_LM, max_len=TRAIN_SEQ)
    layers = cfg["num_layers"]
    builder = get_builder("transformer_lm")

    # a 2-layer f32 MoE step on the card against the same step on the CPU
    small = dict(cfg, num_layers=2, max_len=128)
    weights = {k: torch.from_numpy(v) for k, v in init_state_dict(
        builder(**small), seed=5).items()}
    small_toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, small["vocab_size"], (2, 128)).astype(np.int32))
    side = {}
    for dev in ("cuda", "cpu"):
        module = builder(**small)
        module.load_state_dict(weights)
        module = module.to(dev)
        logits, aux = TR._forward(module, small_toks.to(dev))
        loss = TR.lm_loss(logits, small_toks.to(dev)) + aux
        loss.backward()
        side[dev] = (loss.item(), {n: p.grad.cpu() for n, p in
                                   module.named_parameters()})
    loss_rel = abs(side["cuda"][0] - side["cpu"][0]) / abs(side["cpu"][0])
    grad_rel = max(rel_err(g, side["cpu"][1][n])
                   for n, g in side["cuda"][1].items())
    log(f"[moe] 2-layer f32 MoE LM step (batch 2 x 128, 8 experts, "
        f"capacity 1.25) on the card vs the CPU: loss rel {loss_rel:.3e} "
        f"(limit {TRAIN_CPU_LOSS_RTOL}), worst gradient rel_l2 "
        f"{grad_rel:.3e} (limit {TRAIN_CPU_GRAD_RTOL})")
    if loss_rel > TRAIN_CPU_LOSS_RTOL or grad_rel > TRAIN_CPU_GRAD_RTOL:
        fail("the f32 MoE LM step on the card disagrees with the CPU's")
    del side

    t0 = time.perf_counter()
    state = TR.init_train_state(builder(**cfg), TR.adam(TRAIN_LR), seed=0,
                                compute_dtype="bfloat16")
    n_params = sum(p.numel() for p in state.module.parameters())
    router = state.work.blocks[0].moe.router.weight
    log(f"[moe] MoE GPT-small {cfg}, {n_params / 1e6:.1f} M f32 parameters "
        f"(bf16 working copy, router {router.dtype}), Adam {TRAIN_LR}: "
        f"ready in {time.perf_counter() - t0:.2f} s")
    if router.dtype != torch.float32 or \
            state.work.blocks[0].moe.w_in.dtype != torch.bfloat16:
        fail("the bf16 working copy does not keep the MoE router f32")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ)).astype(
            np.int32)).cuda()
    epoch = TR.make_lm_train_epoch()
    batch = toks[None]
    # the warm-up step's objective: its cross-entropy and aux term, read
    # where the trainer adds them
    seen = []
    real_forward = TR._forward

    def forward_spy(module, x):
        logits, aux = real_forward(module, x)
        seen.append((TR.lm_loss(logits.detach(), x), aux.detach()))
        return logits, aux

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    TR._forward = forward_spy
    try:
        state, loss0 = epoch(state, batch)
    finally:
        TR._forward = real_forward
    torch.cuda.synchronize()
    losses, step_s = [loss0], []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = epoch(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = MOE_TRAIN_STEPS + 1
    want = dict(NO_LAUNCHES, flash_attention_fwd=layers * steps,
                flash_attention_bwd_dkdv=layers * steps,
                flash_attention_bwd_dq=layers * steps)
    losses = torch.cat(losses).cpu().numpy()
    ce, aux = (float(t) for t in seen[0])
    log(f"[moe] {steps} steps: launches {launches}; losses "
        f"{np.array2string(losses, precision=4)}; the warm-up step's loss "
        f"{losses[0]:.6f} = cross-entropy {ce:.6f} + 0.01 x aux "
        f"{aux / 0.01:.6f}")
    if launches != want:
        fail(f"the MoE train path launched the kernels {launches} times, "
             f"expected {want} (B4, B5 and B6 once per layer per step)")
    if not np.isfinite(losses).all():
        fail(f"MoE train losses not finite: {losses}")
    if not aux > 0 or abs(losses[0] - (ce + aux)) > 1e-5 * abs(losses[0]):
        fail(f"the MoE aux term is not in the loss: {losses[0]} against "
             f"{ce} + {aux}")
    med = float(np.median(step_s))
    flops = lm_train_flops(TRAIN_BATCH, TRAIN_SEQ, cfg["embed_dim"], layers,
                           cfg["vocab_size"])
    log(f"[moe] MoE LM step (batch {TRAIN_BATCH} x {TRAIN_SEQ}, fwd + bwd + "
        f"Adam, CUDA-synchronised host clock): {min(step_s) * 1e3:.3f}.."
        f"{max(step_s) * 1e3:.3f} ms over {MOE_TRAIN_STEPS} steps, median "
        f"{med * 1e3:.3f} ms = {TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; "
        f"{flops / 1e12:.3f} TFLOP a step counted as one expert a token (the "
        f"dense step's count, tools/roofline.py) = MFU "
        f"{flops / med / BF16_FLOPS:.4f}; peak memory {peak_gib:.2f} GiB on "
        f"{card}")
    bundle = TorchBundle.from_module("transformer_lm", state.module, cfg,
                                     input_shape=(LM_PROMPT,))
    del state, epoch, batch
    torch.cuda.empty_cache()
    return launches, bundle


def moe_decode_path(bundle, card):
    """Phase 13 (a), decode: `generate` and a plain paged batcher on the
    trained MoE GPT-small (bf16), then the f32 exactness checks at
    EXACT_LM width with drop-free capacity; returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.serving import batcher as SB

    layers = MOE_LM["num_layers"]
    total = dict(NO_LAUNCHES)
    prompt = np.random.default_rng(0).integers(
        0, LM["vocab_size"], (LM_BATCH, LM_PROMPT)).astype(np.int32)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = G.generate(bundle, prompt, LM_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if launches != dict(NO_LAUNCHES, flash_attention_fwd=layers):
        fail(f"MoE generate launched {launches}, expected B4 once a layer")
    for k in KERNELS:
        total[k] += launches[k]
    toks = out.cpu().numpy()
    if toks.shape != (LM_BATCH, LM_PROMPT + LM_NEW) or \
            toks.min() < 0 or toks.max() >= LM["vocab_size"]:
        fail(f"MoE generate returned {toks.shape} or tokens outside the "
             "vocabulary")
    module = G._module_for(bundle, torch.device("cuda"))
    if module.blocks[0].moe.router.weight.dtype != torch.float32:
        fail("the bf16 MoE bundle's router is not f32")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        G.generate(bundle, prompt, LM_NEW)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with torch.inference_mode():
        p_cuda = torch.from_numpy(prompt).cuda()
        _lg, cache = G._prefill_cache(module, p_cuda)
        tok = torch.zeros((LM_BATCH, 1), dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LM_NEW - 1):
            lg, cache = module.decode_step(tok, cache, LM_PROMPT + i)
            tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (LM_NEW - 1)
        del cache
    log(f"[moe] generate (batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_NEW} "
        f"new, bf16 MoE GPT-small): first {first_s:.3f} s, launches "
        f"{launches}; walls {min(walls):.4f}..{max(walls):.4f} s; eager "
        f"decode {step_ms:.3f} ms a step = "
        f"{LM_BATCH / step_ms * 1e3:.0f} tokens/s on {card}")

    rng = np.random.default_rng(5)
    lens = rng.integers(16, 901, MOE_SERVE_REQUESTS)
    prompts = [rng.integers(0, LM["vocab_size"], n).astype(np.int32)
               for n in lens]
    batcher = SB.ContinuousBatcher(bundle, max_slots=SERVE_SLOTS,
                                   paged=True, page_size=PAGE).start()
    prefill = PrefillCounter()
    try:
        zero_launches()
        ticks0 = batch_fill_count()
        t0 = time.perf_counter()
        got = [st.tokens(timeout=STREAM_WAIT_S) for st in
               [batcher.submit(p, MOE_SERVE_NEW) for p in prompts]]
        wall = time.perf_counter() - t0
        launches, ticks = read_launches(), batch_fill_count() - ticks0
    finally:
        prefill.remove()
        batcher.stop()
    want = dict(NO_LAUNCHES, flash_attention_fwd=layers * prefill.forwards,
                paged_decode_attention=layers * ticks)
    log(f"[moe] paged ContinuousBatcher ({SERVE_SLOTS} slots) on the MoE "
        f"GPT-small: {MOE_SERVE_REQUESTS} requests (prompts {lens.min()}.."
        f"{lens.max()}), {MOE_SERVE_NEW} new each in {wall:.3f} s = "
        f"{MOE_SERVE_REQUESTS * MOE_SERVE_NEW / wall:.0f} tokens/s, {ticks} "
        f"ticks, prefills {prefill.shapes}; launches {launches} on "
        f"{card}")
    if launches != want or ticks == 0:
        fail(f"the MoE batcher launched {launches}, expected {want} (B7 "
             "once a layer a tick, B4 once a layer an admission prefill)")
    if any(len(t) != MOE_SERVE_NEW for t in got):
        fail(f"MoE batcher stream lengths {[len(t) for t in got]}")
    for k in KERNELS:
        total[k] += launches[k]
    G._MODULES.clear()
    torch.cuda.empty_cache()

    # f32 exactness at EXACT_LM width, drop-free capacity
    exact = TorchBundle("transformer_lm", EXACT_MOE_LM, input_shape=(16,),
                        dtype="float32", seed=0)
    emod = G._module_for(exact, torch.device("cuda"))
    prompt = rng.integers(0, LM["vocab_size"], (2, 100)).astype(np.int32)
    got = G.generate(exact, prompt, MOE_EXACT_NEW).cpu().numpy()
    seq = torch.from_numpy(prompt).cuda()
    gaps = []
    with torch.inference_mode():
        for _ in range(MOE_EXACT_NEW):
            lg = emod(seq)[0][:, -1]
            top2 = lg.topk(2).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            seq = torch.cat([seq, lg.argmax(-1, keepdim=True).to(
                torch.int32)], dim=1)
    naive = seq.cpu().numpy()
    for r in range(prompt.shape[0]):
        diff = np.flatnonzero(got[r] != naive[r])
        if len(diff):
            step = int(diff[0]) - prompt.shape[1]
            if gaps[step][r] >= TIE_GAP:
                fail(f"f32 MoE generate differs from the naive recompute "
                     f"(row {r}, step {step}, top-2 gap {gaps[step][r]:.3e})")
            log(f"[moe] f32 generate ties the naive recompute at row {r} "
                f"step {step} (gap {gaps[step][r]:.2e})")
    log(f"[moe] f32 MoE generate (EXACT_LM width, 8 experts, capacity 8.0, "
        f"batch 2, prompt 100, {MOE_EXACT_NEW} new) equals the naive "
        "recompute of full forwards, ties aside")
    lens = [16, 900] + rng.integers(16, 901, EXACT_REQUESTS - 2).tolist()
    prompts = [rng.integers(0, LM["vocab_size"], n).astype(np.int32)
               for n in lens]
    refs = [G.generate(exact, p[None], EXACT_NEW)[0, len(p):].cpu().tolist()
            for p in prompts]
    batcher = SB.ContinuousBatcher(exact, max_slots=EXACT_SLOTS, paged=True,
                                   page_size=PAGE).start()
    try:
        got = [st.tokens(timeout=STREAM_WAIT_S) for st in
               [batcher.submit(p, EXACT_NEW) for p in prompts]]
    finally:
        batcher.stop()
    compare_streams("f32 MoE paged serving", emod, prompts, got, refs, None)
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return total


def seq_logprob(module, seq, s_p):
    """Summed log-probability of seq[:, s_p:] under one forward of
    `module` over the whole sequence (f32 log-softmax), per row."""
    import torch

    with torch.inference_mode():
        logits = module(seq)[0].float()
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        lp = logp.gather(-1, seq[:, 1:].long()[..., None])[..., 0]
    return lp[:, s_p - 1:].sum(dim=1).double().cpu().numpy()


def beam_path(card):
    """Phase 13 (b): beam search; returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle

    exact = TorchBundle("transformer_lm", EXACT_LM, input_shape=(16,),
                        dtype="float32", seed=0)
    emod = G._module_for(exact, torch.device("cuda"))
    prompt = np.random.default_rng(7).integers(
        0, LM["vocab_size"], (2, 100)).astype(np.int32)
    one = G.beam_search(exact, prompt, BEAM_NEW, num_beams=1).cpu().numpy()
    greedy = G.generate(exact, prompt, BEAM_NEW).cpu().numpy()
    for r in range(2):
        first_mismatch_or_tie(f"f32 beam_search(num_beams=1) row {r}", emod,
                              prompt[r], one[r, 100:], greedy[r, 100:])
    log("[beam] f32 beam_search(num_beams=1) at EXACT_LM width equals "
        "generate(), ties aside")
    G._MODULES.clear()

    layers = LM["num_layers"]
    bundle = TorchBundle("transformer_lm", LM, input_shape=(LM_PROMPT,),
                         seed=0)
    prompt = np.random.default_rng(0).integers(
        0, LM["vocab_size"], (LM_BATCH, LM_PROMPT)).astype(np.int32)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beam = G.beam_search(bundle, prompt, BEAM_NEW, num_beams=BEAM_K)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if launches != dict(NO_LAUNCHES, flash_attention_fwd=layers):
        fail(f"beam search launched {launches}, expected B4 once a layer "
             "(one prefill on B rows) and no paged kernel")
    greedy = G.generate(bundle, prompt, BEAM_NEW)
    f32 = TorchBundle("transformer_lm", LM, state_dict=bundle.state_dict,
                      input_shape=(LM_PROMPT,), dtype="float32")
    f32_mod = f32.module(torch.device("cuda"))
    lp_b = seq_logprob(f32_mod, beam, LM_PROMPT)
    lp_g = seq_logprob(f32_mod, greedy, LM_PROMPT)
    bf16_mod = G._module_for(bundle, torch.device("cuda"))
    lb16 = seq_logprob(bf16_mod, beam, LM_PROMPT)
    lg16 = seq_logprob(bf16_mod, greedy, LM_PROMPT)
    del f32_mod
    log(f"[beam] GPT-small bf16 beam_search (batch {LM_BATCH}, prompt "
        f"{LM_PROMPT}, {BEAM_NEW} new, {BEAM_K} beams): first {first_s:.3f} "
        f"s, launches {launches}; summed log-probability (one f32 forward) "
        f"beam - greedy per row {np.round(lp_b - lp_g, 4).tolist()} (bf16 "
        f"forward: {np.round(lb16 - lg16, 4).tolist()})")
    if (lp_b < lp_g - 1e-4).any():
        fail(f"beam search's hypotheses score below greedy's: {lp_b} "
             f"against {lp_g}")
    eos = int(greedy[0, LM_PROMPT + 1])
    out = G.beam_search(bundle, prompt, BEAM_NEW, num_beams=BEAM_K,
                        eos_id=eos).cpu().numpy()[:, LM_PROMPT:]
    hits = 0
    for row in out:
        at = np.flatnonzero(row == eos)
        if len(at):
            hits += 1
            if not (row[at[0]:] == eos).all():
                fail(f"beam search: a row un-finishes after eos: {row}")
    log(f"[beam] with eos_id={eos}: {hits} of {LM_BATCH} rows end in eos, "
        "every tail after its first eos is eos")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        G.beam_search(bundle, prompt, BEAM_NEW, num_beams=BEAM_K)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[beam] 3 runs: {min(walls):.4f}..{max(walls):.4f} s = "
        f"{LM_BATCH * BEAM_NEW / max(walls):.0f}.."
        f"{LM_BATCH * BEAM_NEW / min(walls):.0f} output tokens/s "
        f"({LM_BATCH * BEAM_K} rows a step, the prefill included) on {card}")
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return launches


def spec_exactness(target, draft, label, prompt, n, want_rounds=None):
    """speculative_generate(target, draft) against generate() at f32 (the
    tie rule); returns the rounds."""
    import torch
    from mmlspark_tpu_torch.models import generation as G

    module = G._module_for(target, torch.device("cuda"))
    got, rounds = G.speculative_generate(target, draft, prompt[None], n,
                                         gamma=SPEC_GAMMA, return_stats=True)
    ref = G.generate(target, prompt[None], n)
    equal = first_mismatch_or_tie(label, module, prompt,
                                  got[0, len(prompt):].cpu().tolist(),
                                  ref[0, len(prompt):].cpu().tolist())
    log(f"[spec] {label}: {n} tokens in {rounds} rounds (gamma "
        f"{SPEC_GAMMA}); equal to generate(): {equal}")
    if want_rounds is not None and rounds != want_rounds:
        fail(f"{label}: {rounds} rounds, expected {want_rounds}")
    return rounds


class TickCounter:
    """Counts a batcher's speculative ticks, the live slots each verified
    and the tokens each emitted (through `_speculative_tick`).  A tick
    holds the lock until its counts are in, so `read()` after the last
    stream ended sees the tick that ended it."""

    def __init__(self, batcher):
        import threading

        self.batcher, self.real = batcher, batcher._speculative_tick
        self.ticks = self.verifies = self.tokens = 0
        self.lock = threading.Lock()
        batcher._speculative_tick = self

    def __call__(self, active):
        with self.lock:
            reqs = [self.batcher._live[s] for s in active]
            before = sum(r.emitted for r in reqs)
            self.real(active)
            self.ticks += 1
            self.verifies += len(active)
            self.tokens += sum(r.emitted for r in reqs) - before

    def read(self):
        with self.lock:
            return self.ticks, self.verifies, self.tokens


def speculative_path(requests, card):
    """Phase 13 (c): speculative decoding; returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle, prequantize
    from mmlspark_tpu_torch.serving import batcher as SB

    total = dict(NO_LAUNCHES)
    target = TorchBundle("transformer_lm", EXACT_LM, input_shape=(16,),
                         dtype="float32", seed=0)
    draft = TorchBundle("transformer_lm", dict(EXACT_LM, num_layers=1),
                        input_shape=(16,), dtype="float32", seed=1)
    prompt = np.random.default_rng(8).integers(
        0, LM["vocab_size"], 200).astype(np.int32)
    spec_exactness(target, draft, "f32 speculative_generate, 1-layer draft",
                   prompt, EXACT_NEW)
    spec_exactness(target, target, "f32 speculative_generate, the target as "
                   "its own draft", prompt, EXACT_NEW,
                   want_rounds=math.ceil((EXACT_NEW - 1) / (SPEC_GAMMA + 1)))

    # the paged speculative batcher over phase 7 (a)'s requests
    prompts, prefix, suffixes, refs = requests
    module = G._module_for(target, torch.device("cuda"))
    batcher = SB.ContinuousBatcher(target, max_slots=EXACT_SLOTS, paged=True,
                                   page_size=PAGE, draft_model=draft,
                                   gamma=SPEC_GAMMA)
    handle = batcher.register_prefix(prefix)
    batcher.start()
    counter = TickCounter(batcher)
    prefill = PrefillCounter()
    try:
        zero_launches()
        t0 = time.perf_counter()
        streams = ([batcher.submit(p, EXACT_NEW) for p in prompts]
                   + [batcher.submit(sfx, EXACT_NEW, prefix=handle)
                      for sfx in suffixes])
        got = [st.tokens(timeout=STREAM_WAIT_S) for st in streams]
        wall = time.perf_counter() - t0
        ticks, verifies, emitted = counter.read()
        launches = read_launches()
    finally:
        prefill.remove()
        batcher.stop()
    prefills = {"target": prefill.forwards - prefill.of(batcher.draft),
                "draft": prefill.of(batcher.draft)}
    want = dict(NO_LAUNCHES, flash_attention_fwd=EXACT_LM["num_layers"]
                * prefills["target"] + prefills["draft"])
    log(f"[spec] f32 paged speculative batcher ({EXACT_SLOTS} slots, gamma "
        f"{SPEC_GAMMA}, 1-layer draft): {len(streams)} requests in "
        f"{wall:.3f} s, {ticks} ticks, {verifies} slot verifies emitting "
        f"{emitted} tokens; admission prefills {prefills}; launches "
        f"{launches}")
    if launches != want or ticks == 0:
        fail(f"the speculative batcher launched {launches}, expected {want}"
             " (no paged kernel in a speculative tick; B4 once a layer an "
             "admission prefill of the target and of the draft)")
    full = prompts + [np.concatenate([prefix, sfx]) for sfx in suffixes]
    compare_streams("f32 paged speculative serving", module, full, got, refs,
                    None)
    for k in KERNELS:
        total[k] += launches[k]
    G._MODULES.clear()
    torch.cuda.empty_cache()

    # the serving configuration: tools/mfu_sweep.py's 8_streams_spec
    layers = LM["num_layers"]
    base = TorchBundle("transformer_lm", LM, input_shape=(16,), seed=0)
    qdraft = prequantize(TorchBundle("transformer_lm", dict(LM, quant=True),
                                     state_dict=base.state_dict,
                                     input_shape=(16,)))
    rng = np.random.default_rng(2)
    lens = rng.integers(16, 901, SERVE_REQUESTS)
    prompts = [rng.integers(0, LM["vocab_size"], n).astype(np.int32)
               for n in lens]
    spec = SB.ContinuousBatcher(base, max_slots=SERVE_SLOTS, paged=True,
                                page_size=PAGE, draft_model=qdraft,
                                gamma=SPEC_GAMMA).start()
    plain = SB.ContinuousBatcher(base, max_slots=SERVE_SLOTS, paged=True,
                                 page_size=PAGE).start()
    prefill = None
    try:
        tprefills = []

        def record_target(module_, toks_, logits):
            if module_ is not spec.draft:
                tprefills.append((toks_.cpu().numpy(),
                                  logits.argmax(-1).cpu().numpy()))

        counter = TickCounter(spec)
        prefill = PrefillCounter(record_target)
        try:
            zero_launches()
            t0 = time.perf_counter()
            got = [st.tokens(timeout=STREAM_WAIT_S) for st in
                   [spec.submit(p, SERVE_NEW) for p in prompts]]
            first_s = time.perf_counter() - t0
            ticks, verifies, emitted = counter.read()
            launches = read_launches()
        finally:
            prefill.remove()
        drafts = prefill.of(spec.draft)
        want = dict(NO_LAUNCHES, flash_attention_fwd=layers
                    * (len(tprefills) + drafts))
        log(f"[spec] serving (8_streams_spec: bf16 GPT-small, int8 "
            f"prequantized self-draft, gamma {SPEC_GAMMA}, {SERVE_SLOTS} "
            f"slots, paged): {SERVE_REQUESTS} requests, {SERVE_NEW} new "
            f"each, first round {first_s:.3f} s, {ticks} ticks, "
            f"{len(tprefills)} target and {drafts} draft admission "
            f"prefills; launches {launches}")
        if launches != want:
            fail(f"speculative serving launched {launches}, expected {want}")
        for k in KERNELS:
            total[k] += launches[k]
        if any(len(t) != SERVE_NEW for t in got) or \
                min(min(t) for t in got) < 0 or \
                max(max(t) for t in got) >= LM["vocab_size"]:
            fail(f"speculative serving: stream lengths "
                 f"{[len(t) for t in got]} or tokens outside the vocabulary")
        for i, (p, toks) in enumerate(zip(prompts, got)):
            hit = [am[r, len(p) - 1] for tk, am in tprefills
                   for r in range(tk.shape[0])
                   if tk.shape[1] >= len(p) and (tk[r, :len(p)] == p).all()]
            if not hit or hit[0] != toks[0]:
                fail(f"speculative serving: stream {i}'s first token "
                     f"{toks[0]} is not its prefill's argmax ({hit[:1]})")
        module = G._module_for(base, torch.device("cuda"))
        agree = []
        with torch.inference_mode():
            for p, toks in zip(prompts, got):
                seq = torch.as_tensor(np.concatenate([p, toks[:-1]]),
                                      device="cuda")[None]
                pred = module(seq)[0][0, len(p) - 1:].argmax(-1).cpu()
                agree.append(float((pred.numpy() == np.asarray(toks)).mean()))
        log(f"[spec] serving: first tokens equal their prefill's argmax; "
            f"teacher-forced agreement with the target: mean "
            f"{np.mean(agree):.4f}, min {min(agree):.4f} (bf16, "
            f"informational); {emitted} tokens from {verifies} slot "
            f"verifies in {ticks} ticks = {emitted / verifies:.4f} tokens a "
            f"verify of {SPEC_GAMMA + 1} ({emitted / verifies - 1:.4f} "
            f"draft tokens accepted)")
        def serve_round(b):
            ticks0 = batch_fill_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for st in [b.submit(p, SERVE_NEW) for p in prompts]:
                st.tokens(timeout=STREAM_WAIT_S)
            return time.perf_counter() - t0, batch_fill_count() - ticks0

        first_plain = serve_round(plain)  # warm-up (spec's: the counted run)
        rates = {"plain": [], "spec": []}
        tick_ms = {"plain": [], "spec": []}
        for _ in range(3):
            for name, b in (("spec", spec), ("plain", plain)):
                w, n = serve_round(b)
                rates[name].append(SERVE_REQUESTS * SERVE_NEW / w)
                tick_ms[name].append(w * 1e3 / n)
        log(f"[spec] serving, in turns after a warm-up round each: plain "
            f"paged {[round(r) for r in rates['plain']]} tokens/s, "
            f"{[round(t, 3) for t in tick_ms['plain']]} ms a tick; "
            f"speculative {[round(r) for r in rates['spec']]} tokens/s, "
            f"{[round(t, 3) for t in tick_ms['spec']]} ms a tick (host "
            f"clock, admission prefills included; the plain warm-up "
            f"{first_plain[0]:.3f} s, {first_plain[1]} ticks) on {card}")
    finally:
        if prefill is not None:
            prefill.remove()
        spec.stop()
        plain.stop()
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return total


def distill_path(card):
    """Phase 13 (d): a 2-layer student (GPT-small width) distilled from
    the bf16 GPT-small teacher, then used as the draft of an f32
    speculative decode at EXACT_LM width; returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.bundle import TorchBundle, get_builder

    teacher = TorchBundle("transformer_lm", LM, input_shape=(16,), seed=0)
    student_cfg = dict(LM, num_layers=DISTILL_LAYERS)
    state = TR.init_train_state(get_builder("transformer_lm")(**student_cfg),
                                TR.adam(TRAIN_LR), seed=7,
                                compute_dtype="bfloat16")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, LM["vocab_size"], (DISTILL_BATCH, TRAIN_SEQ)).astype(
            np.int32)).cuda()[None]
    epoch = TR.make_distill_epoch(teacher)
    zero_launches()
    state, loss0 = epoch(state, toks)
    torch.cuda.synchronize()
    losses, step_s = [loss0], []
    for _ in range(DISTILL_STEPS):
        t0 = time.perf_counter()
        state, loss = epoch(state, toks)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_launches()
    steps = DISTILL_STEPS + 1
    layers = LM["num_layers"]
    want = dict(NO_LAUNCHES,
                flash_attention_fwd=(layers + DISTILL_LAYERS) * steps,
                flash_attention_bwd_dkdv=DISTILL_LAYERS * steps,
                flash_attention_bwd_dq=DISTILL_LAYERS * steps)
    losses = torch.cat(losses).cpu().numpy()
    log(f"[distill] {DISTILL_LAYERS}-layer student from the bf16 GPT-small "
        f"teacher (batch {DISTILL_BATCH} x {TRAIN_SEQ}, T 2.0, alpha 0.7, "
        f"Adam {TRAIN_LR}): {steps} steps, launches {launches}; losses "
        f"{np.array2string(losses, precision=4)}; "
        f"{min(step_s) * 1e3:.3f}..{max(step_s) * 1e3:.3f} ms a step, median "
        f"{float(np.median(step_s)) * 1e3:.3f} ms on {card}")
    if launches != want:
        fail(f"distillation launched {launches}, expected {want} (the "
             "teacher's forward B4 once a layer, the student's B4, B5, B6 "
             "once a layer; no backward for the teacher)")
    if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        fail(f"distillation losses not finite or not falling: {losses}")
    student = TorchBundle.from_module("transformer_lm", state.module,
                                      student_cfg, input_shape=(16,),
                                      dtype="float32")
    del state, epoch
    G._MODULES.clear()
    torch.cuda.empty_cache()
    target = TorchBundle("transformer_lm", EXACT_LM, input_shape=(16,),
                         dtype="float32", seed=0)
    prompt = np.random.default_rng(9).integers(
        0, LM["vocab_size"], 200).astype(np.int32)
    spec_exactness(target, student, "f32 speculative_generate, the distilled "
                   "student as the draft", prompt, EXACT_NEW)
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return launches


def start_lm_fleet(bundle, name, replicas, registry_url, n_new, slots,
                   kv_cache_dtype=None):
    """`read_stream().distributed_server(replicas=, registry_url=)` over
    `bundle` with a paged `generate_stream` (64-row pages), on the card."""
    from mmlspark_tpu_torch.serving import read_stream

    query = (read_stream()
             .distributed_server(name=name, path="/lm", replicas=replicas,
                                 registry_url=registry_url)
             .parse_request(schema=["prompt"])
             .generate_stream(bundle, max_new_tokens=n_new, max_slots=slots,
                              paged=True, page_size=PAGE,
                              kv_cache_dtype=kv_cache_dtype)
             .options(batch_timeout_ms=5.0)
             .start())
    if query._batcher.device.type != "cuda":
        fail(f"fleet {name}: the batcher serves from "
             f"{query._batcher.device}, not the card")
    return query


def fleet_exactness(exact_requests, card):
    """Phase 14 (a), exactness: phase 7 (a)'s requests (f32, GPT-small
    width, 2 layers) through a gateway over `distributed_server(replicas=
    2)`: every stream equals `generate()` on the card (ties aside), the
    paged kernel once a layer a tick and B4 once a layer an admission
    prefill forward.  Returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.serving import FleetGateway, ServiceRegistry

    prompts, prefix, suffixes, refs = exact_requests
    full = prompts + [np.concatenate([prefix, sfx]) for sfx in suffixes]
    bundle = TorchBundle("transformer_lm", EXACT_LM, input_shape=(16,),
                         dtype="float32", seed=0)
    module = G._module_for(bundle, torch.device("cuda"))
    reg = ServiceRegistry()
    url = reg.start()
    query = gw = prefills = None
    try:
        query = start_lm_fleet(bundle, "fleet-exact", FLEET_REPLICAS, url,
                               EXACT_NEW, EXACT_SLOTS)
        gw = FleetGateway(name="fleet-exact", registry_url=url,
                          probe_interval_s=5.0)
        gw.start()
        if len(gw.replicas()) != FLEET_REPLICAS:
            fail(f"the gateway found {len(gw.replicas())} replicas in the "
                 f"registry, expected {FLEET_REPLICAS}")
        ticks = StepCounter(query._batcher)
        prefills = PrefillCounter()
        zero_launches()
        gi = gw.service_info
        results = post_streams(gi.host, gi.port, gi.path,
                               [{"prompt": p.tolist()} for p in full], 4)
        launches = read_launches()
    finally:
        if prefills is not None:
            prefills.remove()
        if gw is not None:
            gw.stop()
        if query is not None:
            query.stop()
        reg.stop()
    layers = EXACT_LM["num_layers"]
    want = dict(NO_LAUNCHES, flash_attention_fwd=layers * prefills.forwards,
                paged_decode_attention=layers * ticks.ticks)
    log(f"[fleet] f32 exactness: {len(full)} requests through a gateway "
        f"over {FLEET_REPLICAS} replicas: {ticks.ticks} ticks, "
        f"{prefills.forwards} admission prefill forwards, launches "
        f"{launches}")
    if launches != want or ticks.ticks == 0:
        fail(f"fleet f32 exactness: launches {launches}, expected {want}")
    got = stream_tokens("fleet f32 exactness", results, EXACT_NEW,
                        EXACT_LM["vocab_size"])
    compare_streams("fleet f32 paged serving through the gateway", module,
                    full, got, refs, None)
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return launches


def _fleet_memory(bundle, url):
    """(the two-replica query, the card's bytes grown by starting the
    one-replica query, by starting the two-replica one): each from a
    cleared model cache, so each holds one model and its pools."""
    import gc

    import torch
    from mmlspark_tpu_torch.models import generation as G

    def grown(replicas, registry_url):
        G._MODULES.clear()
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        query = start_lm_fleet(bundle, "fleet-lm", replicas, registry_url,
                               SERVE_NEW, SERVE_SLOTS)
        torch.cuda.synchronize()
        return query, torch.cuda.memory_allocated() - before

    one, grown_one = grown(1, None)
    one.stop()
    del one
    two, grown_two = grown(FLEET_REPLICAS, url)
    return two, grown_one, grown_two


def fleet_gateway_share(trace_ids):
    """ms the gateway added to each request: its `serving.fleet.request`
    span less the replica's `serving.request` child span."""
    from mmlspark_tpu_torch.core import telemetry

    out = []
    for tid in trace_ids:
        spans = telemetry.get_trace(tid)
        gw = [s for s in spans if s["name"] == "serving.fleet.request"]
        rep = [s for s in spans if s["name"] == "serving.request"]
        if len(gw) != 1 or len(rep) != 1 or \
                rep[0]["parent_id"] != gw[0]["span_id"]:
            fail(f"trace {tid}: spans {[s['name'] for s in spans]} are not "
                 f"one gateway span over one replica span")
        out.append((gw[0]["wall_s"] - rep[0]["wall_s"]) * 1e3)
    return out


def fleet_telemetry_check(gw, query):
    """Phase 14 (c): `/fleet/metrics.json` against every replica's own
    `/metrics.json` and the gateway's own snapshot (no traffic between),
    a client trace id stitched by `/trace/<id>`, and `/fleet/alerts`."""
    import uuid

    from mmlspark_tpu_torch.core import telemetry
    from mmlspark_tpu_torch.io.http.clients import send_request
    from mmlspark_tpu_torch.io.http.schema import HTTPRequestData

    def get(host, port, path):
        resp = send_request(HTTPRequestData(
            url=f"http://{host}:{port}{path}", method="GET"), timeout=30.0)
        if resp.status_code != 200:
            fail(f"GET {path} answered {resp.status_code}")
        return resp.json()

    gi = gw.service_info
    tid = f"fleet-{uuid.uuid4().hex}"
    res = post_streams(gi.host, gi.port, gi.path, [{"prompt": [1, 2, 3]}],
                       1, trace_ids=[tid])
    stream_tokens("fleet trace request", res, SERVE_NEW, LM["vocab_size"])
    time.sleep(1.0)   # older than the plane's 0.5 s cache: a fresh pull
    own = {f"{i.host}:{i.port}": get(i.host, i.port, "/metrics.json")
           for i in query.service_infos}
    own["gateway"] = telemetry.export_snapshot(include_spans=False)
    merged = get(gi.host, gi.port, "/fleet/metrics.json")
    if sorted(merged["meta"]["sources"]) != sorted(own) or \
            merged["meta"]["failed"]:
        fail(f"/fleet/metrics.json sources {merged['meta']['sources']} "
             f"(failed {merged['meta']['failed']}), expected {sorted(own)}")
    prefixes = ("serving.", "flow.")
    names = sorted({k for snap in own.values() for k in snap["counters"]
                    if k.startswith(prefixes)
                    and not k.startswith("serving.fleet")})
    for k in names:
        want = sum(int(s["counters"].get(k, 0)) for s in own.values())
        if merged["counters"].get(k) != want:
            fail(f"/fleet/metrics.json counter {k} = "
                 f"{merged['counters'].get(k)}, the replicas' own sum {want}")
    hists = sorted({k for snap in own.values() for k in snap["histograms"]
                    if k.startswith(("serving.request", "serving.batcher",
                                     "flow."))})
    for k in hists:
        parts = [s["histograms"][k] for s in own.values()
                 if k in s["histograms"]]
        m = merged["histograms"][k]
        if m["count"] != sum(p["count"] for p in parts) or any(
                cum != sum(int(p["buckets"][i][1]) for p in parts)
                for i, (_le, cum) in enumerate(m["buckets"])):
            fail(f"/fleet/metrics.json histogram {k} is not the exact sum "
                 f"of the replicas' own")
    if not any(k.startswith("serving.batcher.batch_fill") for k in hists):
        fail(f"no batcher histogram among the merged series: {hists}")
    log(f"[fleet] /fleet/metrics.json over {len(own)} sources (one process, "
        f"so one registry's copies): {len(names)} flow counters {names} and "
        f"{len(hists)} histograms equal the exact sums of each source's own "
        f"snapshot")
    doc = get(gi.host, gi.port, f"/trace/{tid}")
    tree = doc.get("tree") or []
    if len(tree) != 1 or tree[0]["name"] != "serving.fleet.request" or \
            "serving.request" not in {c["name"] for c in tree[0]["children"]}:
        fail(f"/trace/{tid} is not one gateway span over a replica child: "
             f"{[(n['name'], [c['name'] for c in n['children']]) for n in tree]}")
    alerts = get(gi.host, gi.port, "/fleet/alerts")["alerts"]
    states = {a["slo"]: a["state"] for a in alerts}
    if set(states) != {"availability", "latency_p99", "deadline_miss"}:
        fail(f"/fleet/alerts: {states}")
    log(f"[fleet] /trace/<id>: a gateway span over a replica child "
        f"({doc['span_count']} spans from sources {doc['sources']}); "
        f"/fleet/alerts: {states}")


def fleet_rollout(bundle, url):
    """Phase 14 (b): two queries over the same bundle with int8 pools
    (B8): v1 behind `distributed_server(replicas=2)`, v2 one replica
    registered as version v2; a `RolloutController` canary that promotes
    on `ROLLOUT_METRICS`, then v1's replicas drained and retired while
    clients keep posting.  The rollout has a gateway of its own, started
    with both versions in the registry, so each version's latency window
    holds only requests served while both batchers share the host, and
    the clients post ROLLOUT_CLIENTS at a time, so that both batchers
    are busy in almost every round.  Both versions keep int8 pools: an
    int8 tick costs 1.4 x a bf16 one on the host (phase 12).  Returns
    {kernel: launches}."""
    import threading

    import numpy as np
    from mmlspark_tpu_torch.serving import (FleetGateway, RolloutController,
                                            ServiceInfo, register_service)

    v1 = start_lm_fleet(bundle, "fleet-lm-int8", FLEET_REPLICAS, url,
                        SERVE_NEW, SERVE_SLOTS, kv_cache_dtype="int8")
    v2 = start_lm_fleet(bundle, "fleet-lm-int8-v2", 1, None, SERVE_NEW,
                        SERVE_SLOTS, kv_cache_dtype="int8")
    prefills = None
    try:
        i2 = v2.service_info
        register_service(url, ServiceInfo("fleet-lm-int8", i2.host, i2.port,
                                          i2.path, version="v2"))
        gw = FleetGateway(name="fleet-lm-int8", registry_url=url,
                          probe_interval_s=5.0)
        gw.start()
        versions = sorted(r.version for r in gw.replicas())
        if versions != ["v1"] * FLEET_REPLICAS + ["v2"]:
            fail(f"gateway versions after the v2 registration: {versions}")
        ctl = RolloutController(gw, canary_weight=CANARY_WEIGHT,
                                min_requests=CANARY_MIN)
        ctl.begin("v2")
        t1, t2 = StepCounter(v1._batcher), StepCounter(v2._batcher)
        prefills = PrefillCounter()
        zero_launches()
        gi = gw.service_info
        rng = np.random.default_rng(3)
        results, posted, errors = [], [], []
        stop = threading.Event()

        def traffic():
            # post_streams fails through SystemExit, which would end this
            # thread quietly: every exit is kept for the main thread
            try:
                while not stop.is_set():
                    bodies = [{"prompt": rng.integers(
                        0, LM["vocab_size"], n).tolist()}
                        for n in rng.integers(16, 400, ROLLOUT_CLIENTS)]
                    posted.extend(bodies)
                    results.extend(post_streams(gi.host, gi.port, gi.path,
                                                bodies, ROLLOUT_CLIENTS))
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        feeder = threading.Thread(target=traffic, daemon=True)
        t0 = time.perf_counter()
        feeder.start()
        while ctl.state == "canary" and time.perf_counter() - t0 < 120.0:
            time.sleep(0.5)
            ctl.step()
        promoted_s = time.perf_counter() - t0
        time.sleep(2.0)       # clients keep posting to the promoted pool
        stop.set()
        feeder.join(timeout=STREAM_WAIT_S)
        if feeder.is_alive() or errors or len(results) != len(posted):
            fail(f"rollout clients hung or failed ({errors}): "
                 f"{len(results)} answers to {len(posted)} requests posted")
        launches = read_launches()
    finally:
        if prefills is not None:
            prefills.remove()
    if ctl.state != "promoted":
        fail(f"the canary did not promote: state {ctl.state}, verdict "
             f"{ctl.last_verdict}, rows {ctl.last_rows}")
    toks = stream_tokens("rollout", results, SERVE_NEW, LM["vocab_size"])
    versions = sorted(r.version for r in gw.replicas())
    if versions != ["v2"]:
        fail(f"after the promotion the pool holds {versions}, expected v2 "
             f"alone")
    served = gw.version_stats("v2")["requests"]
    layers = LM["num_layers"]
    want = dict(NO_LAUNCHES, flash_attention_fwd=layers * prefills.forwards,
                paged_decode_attention_int8=layers * (t1.ticks + t2.ticks))
    rows = {r["metric"]: (round(r["base"], 4), round(r["fresh"], 4),
                          r["regressed"]) for r in ctl.last_rows}
    log(f"[fleet] rollout (int8 pools, v1 on {FLEET_REPLICAS} replicas): "
        f"v2 canary at weight {CANARY_WEIGHT}"
        f" promoted after {promoted_s:.2f} s on rows {rows}; v1's "
        f"{FLEET_REPLICAS} replicas drained and retired; {len(toks)} "
        f"requests during the rollout, every one 200 with {SERVE_NEW} "
        f"tokens; v2 served {served}; ticks v1 {t1.ticks} v2 {t2.ticks}, "
        f"{prefills.forwards} admission prefill forwards; launches "
        f"{launches}")
    if launches != want or t1.ticks == 0 or t2.ticks == 0 or served == 0:
        fail(f"rollout launches {launches}, expected {want} (v2 served "
             f"{served})")
    gw.stop()
    v1.stop()
    v2.stop()
    return launches


def fleet_lm_path(card):
    """Phase 14 (a) at full width, then (c) and (b): chip_smoke's
    GPT-small (bf16) behind `distributed_server(replicas=2,
    registry_url=)` and a gateway that finds both replicas through
    `sync_registry()`; phase 7 (b)'s 16 requests posted concurrently
    through the gateway: every answer 200 with 64 tokens, B4 once a
    layer an admission prefill forward and B7 once a layer a tick,
    exactly; each stream read as it arrives; the gateway's share of a
    request; tokens/s through the gateway and straight to one replica in
    turns.  Returns [{kernel: launches}, ...] of the counted runs."""
    import uuid

    import numpy as np
    import torch
    from mmlspark_tpu_torch.models import generation as G
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.serving import FleetGateway, ServiceRegistry

    layers = LM["num_layers"]
    bundle = TorchBundle("transformer_lm", LM, input_shape=(16,), seed=0)
    rng = np.random.default_rng(2)
    lens = rng.integers(16, 901, SERVE_REQUESTS)
    bodies = [{"prompt": rng.integers(0, LM["vocab_size"], n).tolist()}
              for n in lens]
    reg = ServiceRegistry()
    url = reg.start()
    query = gw = prefills = None
    out = []
    try:
        query, grown_one, grown_two = _fleet_memory(bundle, url)
        log(f"[fleet] the card's memory grown by starting the query: one "
            f"replica {grown_one / 2**20:.1f} MiB, {FLEET_REPLICAS} replicas "
            f"{grown_two / 2**20:.1f} MiB (one model, one batcher, one set "
            f"of pools)")
        if grown_two > grown_one + (64 << 10):
            fail(f"{FLEET_REPLICAS} replicas took {grown_two} B of the card "
                 f"against one replica's {grown_one} B")
        gw = FleetGateway(name="fleet-lm", registry_url=url,
                          probe_interval_s=5.0)
        gw.start()
        if len(gw.replicas()) != FLEET_REPLICAS:
            fail(f"the gateway found {len(gw.replicas())} replicas in the "
                 f"registry, expected {FLEET_REPLICAS}")
        gi = gw.service_info
        ticks = StepCounter(query._batcher)
        prefills = PrefillCounter()
        tids = [f"fleet-{uuid.uuid4().hex}" for _ in bodies]
        zero_launches()
        t0 = time.perf_counter()
        results = post_streams(gi.host, gi.port, gi.path, bodies,
                               SERVE_REQUESTS, trace_ids=tids)
        first_s = time.perf_counter() - t0
        launches = read_launches()
        forwards = prefills.forwards
        prefills.remove()
        prefills = None
        want = dict(NO_LAUNCHES, flash_attention_fwd=layers * forwards,
                    paged_decode_attention=layers * ticks.ticks)
        log(f"[fleet] {SERVE_REQUESTS} requests (prompts {lens.min()}.."
            f"{lens.max()}, {SERVE_NEW} new tokens each) through the gateway"
            f" over {FLEET_REPLICAS} replicas of one batcher, {layers} layers:"
            f" {first_s:.3f} s, {ticks.ticks} ticks, {forwards} admission "
            f"prefill forwards, launches {launches}")
        if launches != want or ticks.ticks == 0:
            fail(f"fleet serving: launches {launches}, expected {want} (B4 "
                 f"once a layer an admission prefill forward, B7 once a "
                 f"layer a tick)")
        stream_tokens("fleet serving", results, SERVE_NEW, LM["vocab_size"])
        reads = [r["chunks"] for r in results]
        first = [r["first_s"] / r["total_s"] for r in results]
        log(f"[fleet] streams read as they arrive through two hops: "
            f"{min(reads)}..{max(reads)} reads a stream, the first token "
            f"after {min(first):.3f}..{max(first):.3f} of its request's time")
        if min(reads) < 2:
            fail("a stream reached its client in one piece through the "
                 "gateway: the relay buffered it")
        share = sorted(fleet_gateway_share(tids))
        log(f"[fleet] gateway ms added a request (its span less the "
            f"replica's child span): min {share[0]:.3f} median "
            f"{share[len(share) // 2]:.3f} max {share[-1]:.3f} ({card})")
        r0 = query.service_infos[0]
        rates = {"gateway": [], "direct": []}
        for label in ("gateway", "direct", "direct", "gateway"):
            host, port, path = ((gi.host, gi.port, gi.path)
                                if label == "gateway"
                                else (r0.host, r0.port, r0.path))
            t0 = time.perf_counter()
            res = post_streams(host, port, path, bodies, SERVE_REQUESTS)
            wall = time.perf_counter() - t0
            stream_tokens(f"fleet timing ({label})", res, SERVE_NEW,
                          LM["vocab_size"])
            rates[label].append(SERVE_REQUESTS * SERVE_NEW / wall)
        log(f"[fleet] tokens/s through the gateway "
            f"{' '.join(f'{r:.1f}' for r in rates['gateway'])} against "
            f"straight to one replica "
            f"{' '.join(f'{r:.1f}' for r in rates['direct'])} (16 "
            f"concurrent requests, in turns; {card})")
        out.append(launches)
        fleet_telemetry_check(gw, query)
        out.append(fleet_rollout(bundle, url))
    finally:
        if prefills is not None:
            prefills.remove()
        if gw is not None:
            gw.stop()
        if query is not None:
            query.stop()
        reg.stop()
    G._MODULES.clear()
    torch.cuda.empty_cache()
    return out


def fleet_featurizer_path(repo, card):
    """Phase 14 (d), HTTP on tables: the featurizer pipeline of the JAX
    suite's tests/test_serving_model.py (base64 JPEG -> ImageFeaturizer ->
    reply) at 224x224 over phase 4's ResNet-50 behind
    `DistributedServingServer(replicas=2)` and a gateway; the client a
    Table of the six bench fixtures repeated to 64 rows through
    `SimpleHTTPTransformer(concurrency=8)`.  Features within 2e-2
    relative L2 of the same featurizer run directly on the card; B1 once
    a fixture size a server batch and C2 once a row, exactly; images/s
    through the fleet and direct in turns.  Returns {kernel: launches}."""
    import base64

    import numpy as np
    import torch
    from mmlspark_tpu_torch import LambdaTransformer, Pipeline, Table
    from mmlspark_tpu_torch.io.http import SimpleHTTPTransformer
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet
    from mmlspark_tpu_torch.serving import (DistributedServingServer,
                                            FleetGateway)

    blobs, _digests = jpeg_fixtures()
    names = [n for n in sorted(blobs) if n.startswith("bench_")]
    rows = [names[i % len(names)] for i in range(FLEET_ROWS)]
    size_of = {base64.b64encode(blobs[n]).decode(): n.rsplit("_", 1)[1]
               for n in names}
    b64 = [base64.b64encode(blobs[n]).decode() for n in rows]
    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    featurizer = ImageFeaturizer(bundle=bundle, input_col="image",
                                 output_col="features", batch_size=BATCH)
    from mmlspark_tpu_torch.device import resolve_device

    if resolve_device(featurizer.device).type != "cuda":
        fail(f"the featurizer runs on {resolve_device(featurizer.device)}")
    batches = []

    def decode(t):
        col = list(t["image_b64"])
        batches.append([size_of[v] for v in col])
        return t.with_column("image", [base64.b64decode(v) for v in col])

    def reply(t):
        return t.with_column("reply", [list(map(float, row))
                                       for row in t["features"]])

    model = Pipeline(stages=[LambdaTransformer(fn=decode), featurizer,
                             LambdaTransformer(fn=reply)]).fit(
        Table({"image_b64": b64[:1]}))
    dss = DistributedServingServer(model, reply_col="reply",
                                   name="fleet-feat", path="/featurize",
                                   replicas=FLEET_REPLICAS,
                                   max_batch=FLEET_CONCURRENCY,
                                   batch_timeout_ms=5.0)
    gw = None
    try:
        dss.start()
        gw = FleetGateway(name="fleet-feat", registry_url=dss.registry.url,
                          probe_interval_s=5.0)
        gw.start()
        if len(gw.replicas()) != FLEET_REPLICAS:
            fail(f"the featurizer gateway found {len(gw.replicas())} "
                 f"replicas")
        client = SimpleHTTPTransformer(input_cols=["image_b64"], url=gw.url,
                                       output_col="result",
                                       concurrency=FLEET_CONCURRENCY,
                                       timeout=float(STREAM_WAIT_S))
        table = Table({"image_b64": b64})
        batches.clear()
        zero_launches()
        t0 = time.perf_counter()
        out = client.transform(table)
        fleet_s = time.perf_counter() - t0
        launches = read_launches()
        errors = [e for e in out["errors"] if e is not None]
        if errors:
            fail(f"the featurizer fleet answered {len(errors)} errors: "
                 f"{errors[:2]}")
        feats = np.asarray([r["reply"] for r in out["result"]], np.float32)
        n_batches = len(batches)
        served = sorted(s for b in batches for s in b)
        want = dict(NO_LAUNCHES, ycc_to_bgr=FLEET_ROWS,
                    affine_resample=sum(len(set(b)) for b in batches))
        log(f"[fleet] SimpleHTTPTransformer(concurrency="
            f"{FLEET_CONCURRENCY}) over {FLEET_ROWS} JPEG rows through the "
            f"gateway: {fleet_s:.3f} s, {len(batches)} server batches, "
            f"launches {launches}")
        if served != sorted(size_of[v] for v in b64) or launches != want:
            fail(f"featurizer fleet: launches {launches}, expected {want} "
                 f"(B1 once a fixture size a server batch, C2 once a row; "
                 f"{len(served)} rows featurized)")
        direct = featurizer.transform(Table({"image": [blobs[n]
                                                       for n in rows]}))
        direct = np.asarray(direct["features"], np.float32)
        err = rel_l2(feats, direct)
        row_err = max(rel_l2(feats[i], direct[i]) for i in range(FLEET_ROWS))
        log(f"[fleet] features through the fleet vs the featurizer run "
            f"directly on the card: rel_l2={err:.3e}, worst row "
            f"{row_err:.3e} (bound {FLEET_FEATURES_RTOL})")
        if feats.shape != (FLEET_ROWS, 2048) or not np.isfinite(feats).all() \
                or err > FLEET_FEATURES_RTOL:
            fail("the featurizer fleet disagrees with the direct run")
        rates = {"fleet": [], "direct": []}
        direct_table = Table({"image": [blobs[n] for n in rows]})
        for label in ("fleet", "direct", "direct", "fleet"):
            t0 = time.perf_counter()
            if label == "fleet":
                client.transform(table)
            else:
                featurizer.transform(direct_table)
            rates[label].append(FLEET_ROWS / (time.perf_counter() - t0))
        log(f"[fleet] images/s through SimpleHTTPTransformer and the fleet "
            f"{' '.join(f'{r:.1f}' for r in rates['fleet'])} against the "
            f"featurizer directly "
            f"{' '.join(f'{r:.1f}' for r in rates['direct'])} (in turns; "
            f"{card})")
        # the fixed cost of one transform at a server batch's mean size
        per = max(1, round(FLEET_ROWS / n_batches))
        small = Table({"image": [blobs[n] for n in rows[:per]]})
        small_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            featurizer.transform(small)
            small_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"[fleet] a direct transform of {per} rows (the counted run's "
            f"mean server batch: {FLEET_ROWS} rows in {n_batches} batches "
            f"over {FLEET_REPLICAS} replicas) takes "
            f"{' '.join(f'{m:.2f}' for m in small_ms)} ms ({card})")
    finally:
        if gw is not None:
            gw.stop()
        dss.stop()
    del featurizer, model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 15: the GBDT engine
# ---------------------------------------------------------------------------

def higgs_like(n: int, seed: int):
    """UCI HIGGS's 28 columns, made from a seed: the lepton's pT, eta and
    phi, the missing energy and its phi, four jets' pT, eta, phi and
    b-tag (HIGGS's three b-tag values), then seven reconstructed masses;
    f64.  The label is a fixed nonlinear rule of them plus logistic
    noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = np.empty((n, GBDT_FEATURES))
    x[:, 0] = rng.lognormal(0.0, 0.5, n)
    x[:, 1] = rng.normal(0.0, 1.0, n)
    x[:, 2] = rng.uniform(-np.pi, np.pi, n)
    x[:, 3] = rng.lognormal(0.0, 0.6, n)
    x[:, 4] = rng.uniform(-np.pi, np.pi, n)
    for j in range(4):
        c = 5 + 4 * j
        x[:, c] = rng.lognormal(0.0, 0.5, n)
        x[:, c + 1] = rng.normal(0.0, 1.0, n)
        x[:, c + 2] = rng.uniform(-np.pi, np.pi, n)
        x[:, c + 3] = rng.choice([0.0, 1.086538, 2.173076], n,
                                 p=[0.5, 0.25, 0.25])
    x[:, 21:] = rng.lognormal(0.0, 0.3, (n, 7))
    s = (2.0 * (x[:, 25] - 1.0) - 1.5 * (x[:, 26] - 1.0)
         + 0.8 * x[:, 8] * x[:, 5] - 0.6 * np.abs(x[:, 1])
         + 0.5 * np.cos(x[:, 2] - x[:, 4]) + 0.4 * np.log(x[:, 3]) - 0.5)
    y = (s + rng.logistic(size=n) > 0).astype(np.float64)
    return x, y


def gbdt_compare():
    """tests/torch_gbdt_compare.py: the tie rule of the port's GBDT parity
    tests (numpy and torch only), here between a CPU fit and a card fit."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_gbdt_compare

    return torch_gbdt_compare


def same_forest(a, b) -> tuple:
    """(split structures equal, leaf values equal bit for bit) of two
    forests."""
    import numpy as np

    keys = ("split_feature", "threshold_bin", "left", "right")
    if len(a) != len(b):
        return False, False
    same = all(np.array_equal(getattr(s, k), getattr(t, k))
               for s, t in zip(a, b) for k in keys)
    return same, same and all(np.array_equal(s.value, t.value)
                              for s, t in zip(a, b))


def iter_clock():
    """A GBDT delegate that stamps the start of training and each
    iteration's end on the host clock; `.ms()` gives ms an iteration."""
    import numpy as np
    import torch

    from mmlspark_tpu_torch.gbdt.delegate import GBDTDelegate

    class IterClock(GBDTDelegate):
        stamps = []

        def before_training(self, booster):
            torch.cuda.synchronize()
            self.stamps = [time.perf_counter()]

        def after_iteration(self, booster, iteration, records):
            self.stamps.append(time.perf_counter())

        def ms(self):
            return np.diff(self.stamps) * 1e3

    return IterClock()


def gbdt_dense_path(card):
    """Phase 15 (a): GBDTClassifier at LightGBM's defaults on a HIGGS-shaped
    table of GBDT_ROWS rows, GBDT_ITERS iterations on the card.  Returns
    an unhooked card fit and its recorded split calls (phase 20 (d))."""
    import numpy as np
    import torch

    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.gbdt import Booster, GBDTClassifier
    from mmlspark_tpu_torch.gbdt import histogram as H
    from mmlspark_tpu_torch.gbdt import tree as T
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.objectives import get_objective
    from mmlspark_tpu_torch.models.statistics import roc_auc

    C = gbdt_compare()
    t0 = time.perf_counter()
    x, y = higgs_like(GBDT_ROWS, seed=15)
    xh, yh = higgs_like(GBDT_HOLD, seed=16)
    table = Table({"features": x, "label": y})
    log(f"[phase 15] HIGGS-shaped table {GBDT_ROWS} x {GBDT_FEATURES} f64 "
        f"(+{GBDT_HOLD} held out), positives {y.mean():.4f}, made in "
        f"{time.perf_counter() - t0:.1f} s")

    # the root histogram: the card's against the plain function on the CPU
    binned = BinMapper(255, seed=0).fit_transform(x)
    obj = get_objective("binary")
    w = np.ones(GBDT_ROWS)
    init = obj.init_score_fn(y, w)
    grad, hess = obj.grad_fn(np.full(GBDT_ROWS, init), y, w)
    builder = H.HistogramBuilder(binned, 256, device="cuda")
    arrs = builder.device_arrays(grad, hess, w)
    root_mask = builder.node_mask(np.ones(GBDT_ROWS, bool))
    card_hist = builder.build(*arrs, root_mask)
    again = builder.build(*arrs, root_mask)
    cpu = [torch.as_tensor(np.asarray(a, np.float32)) for a in (grad, hess, w)]
    plain = H.build_histogram(torch.as_tensor(binned), *cpu,
                              torch.ones(GBDT_ROWS, dtype=torch.bool), 256)
    err = C.hist_err(card_hist.cpu().double().numpy(),
                     plain.double().numpy())
    bitwise = bool(torch.equal(card_hist, again))
    build_ms = cuda_ms(lambda: builder.build(*arrs, root_mask), 10)
    log(f"[phase 15] root histogram [{GBDT_FEATURES}, 256, 3]: card vs CPU "
        f"plain {err:.3g} of the node's mass (limit {GBDT_TOL}); two card "
        f"builds bitwise equal: {bitwise} (max diff "
        f"{float((card_hist - again).abs().max()):.3g}); a build "
        f"{build_ms:.3f} ms (CUDA events, 10 back to back)")
    if not err <= GBDT_TOL:
        fail(f"GBDT root histogram: card vs CPU {err} > {GBDT_TOL}")
    del builder, arrs, card_hist, again, plain

    # the CPU fit of the first iterations, its split calls recorded
    t0 = time.perf_counter()
    with C.recorded_splits(T) as cpu_calls:
        cpu_model = GBDTClassifier(num_iterations=GBDT_CPU_ITERS,
                                   device="cpu").fit(table)
    cpu_s = time.perf_counter() - t0
    # the card fit, timed: each histogram build between CUDA events, each
    # iteration on the host clock; its first calls held to the CPU fit's
    builds = []
    orig_build = H.HistogramBuilder.build

    def timed_build(self, *a):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig_build(self, *a)
        ev[1].record()
        builds.append(ev + (time.perf_counter(),))
        return out

    # and where an iteration's time goes, on the host clock: the grower's
    # `grow` (its `best_split` calls wait for the device: the build, then
    # the split search) and `predict_binned` (the scores' update)
    spans = []

    def host_timed(owner, attr, name):
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            t = time.perf_counter()
            out = orig(*a, **k)
            spans.append((name, t, time.perf_counter()))
            return out

        setattr(owner, attr, wrapped)
        return orig

    clock = iter_clock()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    H.HistogramBuilder.build = timed_build
    grow = host_timed(T.TreeGrower, "grow", "grow")
    predict = host_timed(T.Tree, "predict_binned", "predict_binned")
    try:
        with C.following_splits(T, cpu_calls, "phase 15 card fit",
                                prefix=True) as (card_calls, ties):
            host_timed(T, "best_split", "best_split")
            t0 = time.perf_counter()
            model = GBDTClassifier(num_iterations=GBDT_ITERS,
                                   delegate=clock).fit(table)
            fit_s = time.perf_counter() - t0
    except AssertionError as e:
        fail(f"GBDT: the card fit against the CPU fit's split calls: {e}")
    finally:
        H.HistogramBuilder.build = orig_build
        T.TreeGrower.grow, T.Tree.predict_binned = grow, predict
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    iter_ms = clock.ms()
    med_ms = float(np.median(iter_ms[1:]))
    build_each = [s.elapsed_time(e) for s, e, _ in builds]
    booster = model.booster
    n_trees = len(booster.trees)
    log(f"[phase 15] (a) GBDTClassifier(31 leaves, max_bin 255, "
        f"min_data_in_leaf 20, lr 0.1) x {GBDT_ITERS} on the card: fit "
        f"{fit_s:.2f} s (binning included); ms an iteration "
        f"{', '.join(f'{m:.1f}' for m in iter_ms)} (median after the "
        f"first {med_ms:.1f}); {len(builds)} histogram builds, "
        f"{len(builds) / n_trees:.1f} a tree, ms a build median "
        f"{np.median(build_each):.3f} (min {min(build_each):.3f}, max "
        f"{max(build_each):.3f}), {sum(build_each) / 1e3:.2f} s of the "
        f"fit; {GBDT_ROWS / med_ms * 1e3:,.0f} training rows/s an "
        f"iteration (median); peak device memory {peak / 2**20:.1f} MiB "
        f"above the start ({torch.cuda.max_memory_allocated() / 2**20:.1f}"
        f" MiB in all)")
    # the iterations after the CPU-held ones (no host copies of the
    # histograms): medians of each part's ms an iteration
    stamps = clock.stamps
    parts = {}
    for i in range(GBDT_CPU_ITERS, GBDT_ITERS):
        lo, hi = stamps[i], stamps[i + 1]
        for name in ("grow", "best_split", "predict_binned"):
            parts.setdefault(name, []).append(1e3 * sum(
                e - b for n_, b, e in spans if n_ == name and lo <= b < hi))
    parts["builds (device)"] = [
        sum(ms for ms, (_, _, t) in zip(build_each, builds)
            if stamps[i] <= t < stamps[i + 1])
        for i in range(GBDT_CPU_ITERS, GBDT_ITERS)]
    parts["rest"] = [iter_ms[i] - g - p for i, g, p in zip(
        range(GBDT_CPU_ITERS, GBDT_ITERS), parts["grow"],
        parts["predict_binned"])]
    med = {k: float(np.median(v)) for k, v in parts.items()}
    log(f"[phase 15] an iteration's {med_ms:.1f} ms (median of all after "
        f"the first), each part's median over iterations "
        f"{GBDT_CPU_ITERS + 1}-{GBDT_ITERS}: grow {med['grow']:.1f} (of "
        f"which best_split calls {med['best_split']:.1f}, waiting on the "
        f"device, whose builds take {med['builds (device)']:.1f}), "
        f"predict_binned {med['predict_binned']:.1f}, the rest "
        f"(gradients, bookkeeping) {med['rest']:.1f}")
    worst_hist = max(C.hist_err(c[0], r[0])
                     for c, r in zip(card_calls, cpu_calls))
    log(f"[phase 15] the CPU fit ({GBDT_CPU_ITERS} iterations, this "
        f"machine's CPU) {cpu_s:.1f} s; the card's first {len(cpu_calls)} "
        f"split calls held to it by the tie rule (tie gap "
        f"{C.TIE_GAP}): histograms within {worst_hist:.3g} of the node's "
        f"mass (limit {C.TOL}), {len(ties)} tie(s) reported")
    try:
        C.compare_fits(cpu_model.booster, booster, "phase 15",
                       n_trees=GBDT_CPU_ITERS)
    except AssertionError as e:
        fail(f"GBDT: the card's first {GBDT_CPU_ITERS} trees differ from "
             f"the CPU fit's: {e}")
    worst = max(float(np.abs(a.value - b.value).max()) for a, b in
                zip(cpu_model.booster.trees, booster.trees))
    log(f"[phase 15] the first {GBDT_CPU_ITERS} trees equal the CPU fit's "
        f"(leaf values within {worst:.3g})")

    auc_card = roc_auc(yh, booster._raw_scores(xh, GBDT_CPU_ITERS))
    auc_cpu = roc_auc(yh, cpu_model.booster._raw_scores(xh))
    auc_all = roc_auc(yh, booster._raw_scores(xh))
    log(f"[phase 15] held-out AUC after {GBDT_CPU_ITERS} iterations: card "
        f"{auc_card:.6f}, CPU {auc_cpu:.6f} (limit {GBDT_AUC_GAP}); after "
        f"{GBDT_ITERS}: {auc_all:.6f}")
    if not abs(auc_card - auc_cpu) <= GBDT_AUC_GAP:
        fail(f"GBDT held-out AUC: card {auc_card} vs CPU {auc_cpu}")

    host = booster._raw_scores(xh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = booster.raw_scores_jit(xh)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    err = float(np.abs(dev - host).max())
    t0 = time.perf_counter()
    booster._raw_scores(xh)
    host_s = time.perf_counter() - t0
    log(f"[phase 15] forest predictor: raw_scores_jit on the card vs "
        f"_raw_scores {err:.3g} (limit {GBDT_TOL}) over {GBDT_HOLD} rows x "
        f"{n_trees} trees; {pred_s * 1e3:.1f} ms (uploads included) "
        f"against {host_s * 1e3:.1f} ms on the host")
    if not err <= GBDT_TOL:
        fail(f"GBDT forest predictor: {err} > {GBDT_TOL}")
    again = Booster.from_model_string(booster.model_string())
    if not (np.array_equal(again._raw_scores(xh), host)
            and np.array_equal(again.raw_scores_jit(xh), dev)):
        fail("GBDT: the model string round trip changed the scores")
    log("[phase 15] the model string round trip gives identical scores "
        "(host and card predictors)")

    # determinism: a second card fit of the same data, no hooks
    t0 = time.perf_counter()
    with C.recorded_splits(T) as second_calls:
        second = GBDTClassifier(num_iterations=GBDT_ITERS).fit(table).booster
    same, exact = same_forest(booster.trees, second.trees)
    log(f"[phase 15] a second card fit ({time.perf_counter() - t0:.2f} s, "
        f"its split calls recorded for phase 20): split structure equal to "
        f"the first's: {same}, leaf values bit for bit: {exact} (the first "
        f"fit's {len(ties)} steered tie(s) aside)")
    return second, second_calls


def synthetic_reviews(n: int, seed: int = 0):
    """examples/02_hashed_text_gbdt.py's synthetic reviews."""
    import numpy as np

    from mmlspark_tpu_torch import Table

    rng = np.random.default_rng(seed)
    good = [f"great{i}" for i in range(25)]
    bad = [f"awful{i}" for i in range(25)]
    filler = [f"word{i}" for i in range(400)]
    texts, labels = [], []
    for _ in range(n):
        label = int(rng.random() < 0.5)
        words = list(rng.choice(good if label else bad, 3)) + \
            list(rng.choice(filler, 10))
        rng.shuffle(words)
        texts.append(" ".join(words))
        labels.append(float(label))
    return Table({"text": np.asarray(texts, object),
                  "label": np.asarray(labels)})


def gbdt_sparse_path(card):
    """Phase 15 (b): example 02's hashed reviews through the CSR path on
    the card.  Returns (the fit's booster, the featurized table)."""
    import numpy as np
    import torch

    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt import sparse as SP
    from mmlspark_tpu_torch.models.statistics import roc_auc
    from mmlspark_tpu_torch.online import VowpalWabbitFeaturizer

    t0 = time.perf_counter()
    table = VowpalWabbitFeaturizer(
        input_cols=["text"], output_col="features", num_bits=18,
        string_split_cols=["text"]).transform(
            synthetic_reviews(GBDT_TEXT_ROWS))
    feat_s = time.perf_counter() - t0
    clock = iter_clock()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = GBDTClassifier(num_iterations=GBDT_TEXT_ITERS, num_leaves=7,
                           min_data_in_leaf=10, delegate=clock).fit(table)
    fit_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    mapper = model.booster.bin_mapper
    bins = SP.effective_sparse_max_bin(255, 1 << 18, 7)
    if not (isinstance(mapper, SP.SparseBinMapper)
            and mapper.num_features_ == 1 << 18 and mapper.max_bin == bins):
        fail(f"GBDT sparse: not the CSR path at 2^18 features and "
             f"{bins} bins: {type(mapper).__name__}")
    out = model.transform(table)
    auc = roc_auc(np.asarray(table["label"]), out["probability"][:, 1])
    dense_bytes = GBDT_TEXT_ROWS * (1 << 18)
    iter_ms = clock.ms()
    log(f"[phase 15] (b) example 02's reviews, {GBDT_TEXT_ROWS} rows -> "
        f"VowpalWabbitFeaturizer(num_bits=18) ({feat_s:.1f} s) -> "
        f"GBDTClassifier(7 leaves) x {GBDT_TEXT_ITERS} on the CSR path "
        f"({mapper.max_bin} bins by effective_sparse_max_bin): fit "
        f"{fit_s:.2f} s; ms an iteration "
        f"{', '.join(f'{m:.1f}' for m in iter_ms)} (median after the "
        f"first {float(np.median(iter_ms[1:])):.1f}); train AUC {auc:.6f} "
        f"(limit > 0.9); peak device memory {peak / 2**20:.1f} MiB above "
        f"the start (limit N x 2^18 B = {dense_bytes / 2**20:.0f} MiB)")
    if not auc > 0.9:
        fail(f"GBDT sparse: train AUC {auc}")
    if not peak < dense_bytes:
        fail(f"GBDT sparse: peak device memory {peak} >= {dense_bytes}")

    # the root COO histogram on the card against the plain function on
    # the CPU
    from mmlspark_tpu_torch.gbdt.estimators import _features_matrix

    view = mapper.transform(_features_matrix(table["features"],
                                             table.get_meta("features")))
    n = GBDT_TEXT_ROWS
    rng = np.random.default_rng(17)
    grad = rng.normal(size=n).astype(np.float32)
    hess = np.full(n, 0.25, np.float32)
    w = np.ones(n, np.float32)
    b = SP.SparseHistogramBuilder(view, mapper.num_bins, device="cuda")
    card_hist = b.build(*b.device_arrays(grad, hess, w),
                        b.node_mask(np.ones(n, bool)))
    put = torch.as_tensor
    plain = SP.build_histogram_coo(
        put(view.feat_nz), put(view.bin_nz), put(view.row_nz),
        put(view.zero_bins), put(grad), put(hess), put(w),
        torch.ones(n, dtype=torch.bool), mapper.num_bins, 1 << 18)
    err = gbdt_compare().hist_err(card_hist.cpu().double().numpy(),
                                  plain.double().numpy())
    log(f"[phase 15] root COO histogram [2^18, {mapper.num_bins}, 3] "
        f"({view.nnz} entries): card vs CPU plain {err:.3g} of the node's "
        f"mass (limit {GBDT_TOL})")
    if not err <= GBDT_TOL:
        fail(f"GBDT COO histogram: card vs CPU {err} > {GBDT_TOL}")
    return model.booster, table


# ---------------------------------------------------------------------------
# phase 16: the classic-ML slice
# ---------------------------------------------------------------------------

def adult_like(n: int, seed: int) -> dict:
    """UCI Adult's columns, made from a seed: age, fnlwgt, education-num,
    capital-gain, capital-loss and hours-per-week (int64, in Adult's
    ranges: 92% and 95% of the capital columns zero), the eight
    categoricals with Adult's level counts ("?" a level of workclass,
    occupation and native-country) and the string label "income",
    ">50K" for about 24% of the rows by a fixed rule plus logistic
    noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cols = {
        "age": np.clip(rng.gamma(6.0, 3.6, n) + 17, 17, 90).astype(np.int64),
        "fnlwgt": np.clip(rng.lognormal(12.0, 0.55, n), 12_285,
                          1_484_705).astype(np.int64),
        "education-num": np.clip(np.round(rng.normal(10.1, 2.6, n)), 1,
                                 16).astype(np.int64),
        "capital-gain": np.where(
            rng.random(n) < 0.083,
            np.where(rng.random(n) < 0.05, 99_999,
                     np.minimum(rng.lognormal(8.5, 0.8, n), 99_998)),
            0).astype(np.int64),
        "capital-loss": np.where(rng.random(n) < 0.047,
                                 rng.normal(1_900, 350, n), 0).clip(
                                     0, 4_356).astype(np.int64),
        "hours-per-week": np.clip(np.round(rng.normal(40.4, 12.3, n)), 1,
                                  99).astype(np.int64),
    }
    score = (0.04 * (cols["age"] - 38) + 0.35 * (cols["education-num"] - 10)
             + 0.03 * (cols["hours-per-week"] - 40)
             + 2.5 * (cols["capital-gain"] > 5_000)
             + 0.8 * (cols["capital-loss"] > 1_500))
    for name, k, unknown in ADULT_LEVELS:
        levels = (["?"] if unknown else []) + \
            [f"{name}-{i}" for i in range(k - unknown)]
        idx = rng.choice(k, n, p=rng.dirichlet(np.full(k, 0.8)))
        cols[name] = np.asarray(levels, object)[idx]
        score = score + rng.normal(0.0, 0.6, k)[idx]
    score = score + 0.8 * rng.logistic(size=n)
    cols["income"] = np.where(score > np.quantile(score, 0.76), ">50K",
                              "<=50K").astype(object)
    return cols


def flights_like(n: int, seed: int) -> dict:
    """Example 21's flight rows at On-Time Performance widths, made from a
    seed: 14 carriers, FLIGHT_AIRPORTS origin and destination airports
    (three-letter codes, Zipf-like traffic), departure hour (8% NaN),
    day of week, distance (from the airports' places, 5% NaN) and the
    delay in minutes (example 21's rule: the evening cascade, a
    carrier's and a hub's effect, distance, noise)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    codes = []
    while len(codes) < FLIGHT_AIRPORTS:
        c = "".join(rng.choice(letters, 3))
        if c not in codes:
            codes.append(c)
    codes = np.asarray(codes, object)
    place = rng.uniform((0.0, 0.0), (2_500.0, 1_200.0), (FLIGHT_AIRPORTS, 2))
    traffic = 1.0 / np.arange(1, FLIGHT_AIRPORTS + 1) ** 0.8
    traffic /= traffic.sum()
    origin = rng.choice(FLIGHT_AIRPORTS, n, p=traffic)
    dest = (origin + 1 + rng.choice(FLIGHT_AIRPORTS - 1, n,
                                    p=np.roll(traffic, -1)[:-1] /
                                    np.roll(traffic, -1)[:-1].sum())) \
        % FLIGHT_AIRPORTS
    carriers = np.asarray(["AA", "AS", "B6", "DL", "EV", "F9", "G4", "HA",
                           "MQ", "NK", "OH", "OO", "UA", "WN"], object)
    carrier = rng.choice(FLIGHT_CARRIERS, n)
    dep_hour = rng.integers(5, 23, n).astype(np.float64)
    day = rng.integers(1, 8, n).astype(np.int64)
    distance = np.hypot(*(place[origin] - place[dest]).T) + 50.0
    delay = (3.0 * (dep_hour - 12).clip(0)
             + rng.normal(0.0, 4.0, FLIGHT_CARRIERS)[carrier]
             + rng.gamma(1.0, 4.0, FLIGHT_AIRPORTS)[origin]
             + 1.5 * (day >= 5) + 0.004 * distance
             + rng.normal(size=n) * 5.0)
    dep_hour[rng.random(n) < 0.08] = np.nan
    distance[rng.random(n) < 0.05] = np.nan
    return {"carrier": carriers[carrier], "origin": codes[origin],
            "dest": codes[dest], "dep_hour": dep_hour, "day_of_week": day,
            "distance": distance, "delay": delay}


# example 23's review words (examples/23_text_analytics_word2vec.py)
REVIEW_POS = ["wonderful", "gripping", "masterful", "delightful", "superb"]
REVIEW_NEG = ["tedious", "shallow", "clumsy", "dreadful", "forgettable"]
REVIEW_FILL = ["the", "book", "plot", "chapters", "author", "characters",
               "story", "prose", "pacing", "ending"]


def book_reviews(n: int, seed: int):
    """Example 23's synthetic book reviews: (texts, 1-5 star ratings);
    seven filler words and two words of the rating's sentiment."""
    import numpy as np

    rng = np.random.default_rng(seed)
    texts, stars = [], []
    for _ in range(n):
        rating = int(rng.integers(1, 6))
        lex = REVIEW_POS if rating > 3 else REVIEW_NEG
        words = list(rng.choice(REVIEW_FILL, size=7))
        for _k in range(2):
            words.insert(int(rng.integers(len(words))), str(rng.choice(lex)))
        texts.append(" ".join(words))
        stars.append(rating)
    return np.asarray(texts, object), np.asarray(stars)


@contextlib.contextmanager
def timing(obj, name: str):
    """Every obj.name(...) call inside the block: its wall seconds (the card
    synchronized on both sides), arguments and result.  A module's function
    or a class's own method is swapped and put back; on an instance, an
    instance attribute shadows the method while the block runs."""
    import torch

    calls, orig = [], getattr(obj, name)
    own = name in vars(obj)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t, args, out))
        return out

    setattr(obj, name, wrapped)
    try:
        yield calls
    finally:
        if own:
            setattr(obj, name, orig)
        else:
            delattr(obj, name)


def adam_step_ms(x, y, n_classes: int, steps: int) -> float:
    """ms an Adam step of `linear.fit_logistic` at the learners' defaults
    on device tensors (CUDA events around `steps` steps)."""
    import torch

    from mmlspark_tpu_torch.models import linear as L

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    L.fit_logistic(x, y, n_classes, 1e-4, steps, 0.1)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def weights_gap(a: dict, b: dict) -> float:
    """max |a - b| over a linear model's weights and bias, over max |a|."""
    import numpy as np

    wa = np.concatenate([np.ravel(a["w"]), np.ravel(a["b"])])
    wb = np.concatenate([np.ravel(b["w"]), np.ravel(b["b"])])
    return float(np.abs(wa - wb).max() / np.abs(wa).max())


def tf32_fit_gap(x, y, n_classes: int, want: dict) -> float:
    """The control for LR_W_RTOL: `linear.fit_logistic` at the learners'
    defaults on device tensors with TF32 on and the module's full-f32
    guard bypassed; its weights' gap to `want` (as `weights_gap`)."""
    import contextlib

    import torch

    from mmlspark_tpu_torch.models import linear as L

    guard = L._full_f32
    L._full_f32 = contextlib.nullcontext
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        w, b, _ = L.fit_logistic(x, y, n_classes, 1e-4, 200, 0.1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        L._full_f32 = guard
    return weights_gap(want, {"w": w.cpu().numpy(), "b": b.cpu().numpy()})


def peak_mib(base: int) -> str:
    import torch

    peak = torch.cuda.max_memory_allocated()
    return (f"peak device memory {(peak - base) / 2**20:.1f} MiB above the "
            f"start ({peak / 2**20:.1f} MiB in all)")


def adult_path(card):
    """Phase 16 (a): TrainClassifier at its defaults on the Adult-shaped
    table on the card, held against the CPU fit; scored with
    ComputeModelStatistics; saved, loaded and scored again.  Returns the
    card's model and the held-out table (phase 18 (b) explains them)."""
    import tempfile

    import numpy as np
    import torch

    from mmlspark_tpu_torch import PipelineStage, Table
    from mmlspark_tpu_torch.models.linear import (LogisticRegression,
                                                  LogisticRegressionModel)
    from mmlspark_tpu_torch.models.statistics import ComputeModelStatistics
    from mmlspark_tpu_torch.models.train_classifier import TrainClassifier

    cols = adult_like(ADULT_TRAIN + ADULT_TEST, seed=16)
    train = Table({k: v[:ADULT_TRAIN] for k, v in cols.items()})
    test = Table({k: v[ADULT_TRAIN:] for k, v in cols.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with timing(LogisticRegression, "_fit") as learner:
        t0 = time.perf_counter()
        model = TrainClassifier(label_col="income").fit(train)
        fit_s = time.perf_counter() - t0
    learner_s = sum(c[0] for c in learner)
    t0 = time.perf_counter()
    scored = model.transform(test)
    score_s = time.perf_counter() - t0
    memory = peak_mib(base)
    n_feat = model.featurizer.transform(test.slice(0, 1))["features"].shape[1]
    lm = model.label_model.levels
    t0 = time.perf_counter()
    cpu = TrainClassifier(label_col="income", device="cpu").fit(train)
    cpu_s = time.perf_counter() - t0
    cpu_scored = cpu.transform(test)

    # the card's fit against the CPU's: weights, scores, predictions
    gap = weights_gap(cpu.inner_model.weights, model.inner_model.weights)
    s_card, s_cpu = scored["scores"], cpu_scored["scores"]
    score_err = float(np.abs(s_card - s_cpu).max())
    far = s_cpu.max(axis=1) >= LR_FAR
    differ = np.asarray(scored["prediction"]) != \
        np.asarray(cpu_scored["prediction"])
    # the CPU fit's weights on both devices: the transform alone
    same_w = LogisticRegressionModel(
        weights=cpu.inner_model.weights, device="cuda").transform(
            cpu.featurizer.transform(test))["scores"]
    same_err = float(np.abs(same_w - s_cpu).max())

    # held-out statistics over the restored string labels
    def stats(out):
        t = Table({"label": [lm.get_index(v) for v in test["income"]],
                   "prediction": [lm.get_index(v)
                                  for v in out["prediction"]],
                   "scores": out["scores"]})
        return ComputeModelStatistics(
            evaluation_metric="classification").transform(t)

    st, st_cpu = stats(scored), stats(cpu_scored)
    x = torch.as_tensor(model.featurizer.transform(
        model.label_model.transform(train))["features"], device="cuda")
    y = torch.as_tensor(np.asarray([lm.get_index(v)
                                    for v in train["income"]]),
                        device="cuda")
    step_ms = adam_step_ms(x, y, 2, 200)
    tf32_gap = tf32_fit_gap(x, y, 2, cpu.inner_model.weights)
    del x, y
    log(f"[phase 16] (a) Adult-shaped {ADULT_TRAIN} + {ADULT_TEST} rows, "
        f"{n_feat} features, label '>50K' for "
        f"{np.mean(cols['income'] == '>50K'):.4f}: TrainClassifier() on "
        f"the card (LogisticRegression, 200 Adam steps, lr 0.1) fit "
        f"{fit_s:.3f} s = host featurization {fit_s - learner_s:.3f} s "
        f"+ device learner {learner_s:.3f} s; {step_ms:.4f} ms an Adam "
        f"step (CUDA events, 200 steps); {ADULT_TRAIN / fit_s:,.0f} training"
        f" rows/s; scoring {ADULT_TEST / score_s:,.0f} rows/s; {memory} "
        f"({card})")
    acc, auc = float(st["accuracy"][0]), float(st["AUC"][0])
    acc_cpu, auc_cpu = float(st_cpu["accuracy"][0]), float(st_cpu["AUC"][0])
    log(f"[phase 16] (a) held-out accuracy {acc:.6f}, AUC {auc:.6f} (CPU "
        f"fit {acc_cpu:.6f}, {auc_cpu:.6f}; the CPU fit {cpu_s:.2f} s); "
        f"card vs CPU fit: weights {gap:.3g} of max |w| (limit {LR_W_RTOL}),"
        f" scores {score_err:.3g} (limit {LR_SCORE_ATOL}), predictions "
        f"differing {int(differ.sum())} ({int(differ[far].sum())} where the "
        f"CPU's top probability >= {LR_FAR}); the same weights on both "
        f"devices: scores {same_err:.3g} (limit {LR_SAME_ATOL}); the "
        f"control, the card's fit with TF32 on and the full-f32 guard "
        f"bypassed: weights {tf32_gap:.3g} of max |w| (must exceed "
        f"{LR_W_RTOL})")
    if not tf32_gap > LR_W_RTOL:
        fail(f"Adult: a TF32 fit's weights {tf32_gap} lie within the "
             f"limit {LR_W_RTOL}: the limit does not tell it from a full "
             f"f32 fit")
    if not (gap <= LR_W_RTOL and score_err <= LR_SCORE_ATOL
            and not differ[far].any() and same_err <= LR_SAME_ATOL):
        fail(f"Adult: the card's TrainClassifier fit against the CPU's: "
             f"weights {gap}, scores {score_err}, predictions away from "
             f"the boundary {int(differ[far].sum())}, same weights "
             f"{same_err}")

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        t0 = time.perf_counter()
        model.save(os.path.join(d, "adult"))
        loaded = PipelineStage.load(os.path.join(d, "adult"))
        io_s = time.perf_counter() - t0
    again = loaded.transform(test)
    if not (again.approx_equals(scored, rtol=0.0, atol=0.0)
            and list(again["prediction"]) == list(scored["prediction"])):
        fail("Adult: the loaded TrainedClassifierModel's output differs "
             "from the unsaved model's")
    log(f"[phase 16] (a) TrainedClassifierModel saved and loaded in "
        f"{io_s:.3f} s; the loaded model's output equals the unsaved "
        f"model's bit for bit")
    return model, test


def flights_path(card) -> None:
    """Phase 16 (b): example 21's flight delays: the numeric columns
    through a CSV that `read_csv` parses on the host library, then
    CleanMissingData -> TrainRegressor() with the ridge solved in f64 on
    the card, held against the CPU fit."""
    import numpy as np
    import torch

    from mmlspark_tpu_torch import Table, native
    from mmlspark_tpu_torch.featurize import CleanMissingData
    from mmlspark_tpu_torch.io.binary import read_csv
    from mmlspark_tpu_torch.models import linear as L
    from mmlspark_tpu_torch.models.statistics import ComputeModelStatistics
    from mmlspark_tpu_torch.models.train_classifier import TrainRegressor

    cols = flights_like(FLIGHT_ROWS, seed=21)
    numeric = ["dep_hour", "day_of_week", "distance", "delay"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "flights.csv")
    t0 = time.perf_counter()
    np.savetxt(path, np.column_stack([cols[c] for c in numeric]),
               delimiter=",", header=",".join(numeric), comments="",
               fmt="%.17g")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csv = read_csv(path)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = native.load_csv_numeric_plain(path)
    plain_s = time.perf_counter() - t0
    mib = os.path.getsize(path) / 2**20
    os.remove(path)
    for i, c in enumerate(numeric):
        if not (np.array_equal(csv[c], np.asarray(cols[c], np.float64),
                               equal_nan=True)
                and np.array_equal(csv[c], plain[:, i], equal_nan=True)):
            fail(f"flights: read_csv's column {c} differs from the data "
                 f"written or from np.loadtxt's")
    table = Table({**{c: cols[c] for c in ("carrier", "origin", "dest")},
                   **{c: csv[c] for c in numeric}})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cleaned = CleanMissingData(input_cols=numeric[:3]).fit(table).transform(
        table)
    clean_s = time.perf_counter() - t0
    with timing(L.LinearRegression, "_fit") as learner:
        t0 = time.perf_counter()
        model = TrainRegressor(label_col="delay").fit(cleaned)
        fit_s = time.perf_counter() - t0
    learner_s = sum(c[0] for c in learner)
    memory = peak_mib(base)
    t0 = time.perf_counter()
    cpu = TrainRegressor(label_col="delay", device="cpu").fit(cleaned)
    cpu_s = time.perf_counter() - t0
    gap = weights_gap(cpu.inner_model.weights, model.inner_model.weights)
    pred = np.asarray(model.transform(cleaned)["prediction"])
    pred_cpu = np.asarray(cpu.transform(cleaned)["prediction"])
    pred_err = float(np.abs(pred - pred_cpu).max() / np.abs(pred_cpu).max())
    r2 = float(ComputeModelStatistics(
        label_col="delay", evaluation_metric="regression").transform(
            cleaned.with_column("prediction", pred))["r2"][0])
    x = torch.as_tensor(model.featurizer.transform(cleaned)["features"],
                        device="cuda")
    y = torch.as_tensor(np.asarray(cleaned["delay"]), device="cuda")
    solve_ms = cuda_ms(lambda: L.solve_ridge(x, y, 1e-6), 3)
    d = x.shape[1] + 1
    del x, y
    log(f"[phase 16] (b) flights {FLIGHT_ROWS} rows: a {mib:.1f} MiB CSV "
        f"of the 4 numeric columns written in {write_s:.2f} s, read_csv on "
        f"the host library {read_s:.3f} s (np.loadtxt {plain_s:.3f} s, "
        f"equal); CleanMissingData {clean_s:.3f} s; TrainRegressor() on "
        f"the card (X~ {FLIGHT_ROWS} x {d} f64, "
        f"{FLIGHT_ROWS * d * 8 / 2**20:.0f} MiB) fit {fit_s:.3f} s = host "
        f"featurization {fit_s - learner_s:.3f} s + device learner "
        f"{learner_s:.3f} s; the f64 ridge {solve_ms:.3f} ms (CUDA "
        f"events, 3 back to back: Gram, X~'y, solve); "
        f"{FLIGHT_ROWS / fit_s:,.0f} rows/s; {memory} ({card})")
    log(f"[phase 16] (b) training r2 {r2:.6f}; card vs CPU fit ({cpu_s:.2f}"
        f" s): weights {gap:.3g} of max |w| (limit {RIDGE_W_RTOL}), "
        f"predictions {pred_err:.3g} of max |prediction| (limit "
        f"{RIDGE_PRED_RTOL})")
    if not (gap <= RIDGE_W_RTOL and pred_err <= RIDGE_PRED_RTOL):
        fail(f"flights: the card's ridge against the CPU's: weights {gap}, "
             f"predictions {pred_err}")


def reviews_path(card):
    """Phase 16 (c): example 23's hashed TF-IDF reviews into
    LogisticRegression on the card; held-out accuracy above 0.85.  Returns
    the fitted featurizer and learner and the held-out texts (phase 18 (c)
    explains them)."""
    import numpy as np
    import torch

    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.featurize import TextFeaturizer
    from mmlspark_tpu_torch.models.linear import LogisticRegression

    texts, stars = book_reviews(REVIEW_ROWS, seed=2)
    labels = (stars > 3).astype(np.float64)
    cut = REVIEW_TRAIN
    t0 = time.perf_counter()
    tf = TextFeaturizer(input_col="text", output_col="features",
                        num_features=REVIEW_FEATURES).fit(
                            Table({"text": texts[:cut]}))
    train_x = tf.transform(Table({"text": texts[:cut]}))["features"]
    test_x = tf.transform(Table({"text": texts[cut:]}))["features"]
    feat_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with timing(LogisticRegression, "_fit") as learner:
        t0 = time.perf_counter()
        clf = LogisticRegression(max_iter=REVIEW_STEPS).fit(
            Table({"features": train_x, "label": labels[:cut]}))
        fit_s = time.perf_counter() - t0
    learner_s = sum(c[0] for c in learner)
    t0 = time.perf_counter()
    pred = np.asarray(clf.transform(
        Table({"features": test_x}))["prediction"])
    score_s = time.perf_counter() - t0
    memory = peak_mib(base)
    acc = float(np.mean(pred == labels[cut:]))
    x = torch.as_tensor(train_x, device="cuda")
    y = torch.as_tensor(labels[:cut].astype(np.int64), device="cuda")
    step_ms = adam_step_ms(x, y, 2, REVIEW_STEPS)
    del x, y
    log(f"[phase 16] (c) book reviews {REVIEW_ROWS} ({cut} to train, "
        f"{train_x.nbytes / 2**20:.0f} MiB of f32 features): "
        f"TextFeaturizer(num_features={REVIEW_FEATURES}) fit + transform "
        f"on the host {feat_s:.3f} s; LogisticRegression(max_iter="
        f"{REVIEW_STEPS}) on the card fit {fit_s:.3f} s (device learner "
        f"{learner_s:.3f} s); {step_ms:.4f} ms an Adam step (CUDA "
        f"events); {cut / (feat_s * cut / REVIEW_ROWS + fit_s):,.0f} "
        f"training rows/s (featurization included); scoring "
        f"{(REVIEW_ROWS - cut) / score_s:,.0f} rows/s; held-out accuracy "
        f"{acc:.6f} (limit > {REVIEW_ACC}); {memory} ({card})")
    if not acc > REVIEW_ACC:
        fail(f"book reviews: held-out accuracy {acc} <= {REVIEW_ACC}")
    return tf, clf, texts[cut:]


def host_library_path() -> None:
    """Phase 16: the host library builds here (g++) and its murmur3
    agrees with the Python hash on 1M strings."""
    import numpy as np

    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.online.hashing import murmurhash3_32

    t0 = time.perf_counter()
    try:
        native.host_library()
    except native.HostLibraryError as e:
        fail(f"the host library did not build: {e}")
    build_s = time.perf_counter() - t0
    strings = [f"feature_{i}={i * 7919 % 1_000_003}"
               for i in range(MURMUR_STRINGS)]
    t0 = time.perf_counter()
    got = native.murmur3_batch(strings, seed=42)
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np.array([murmurhash3_32(s.encode(), 42) for s in strings],
                    np.uint32)
    py_s = time.perf_counter() - t0
    log(f"[phase 16] host library (native/src/host.cpp, g++) built in "
        f"{build_s:.2f} s; murmur3_batch over {MURMUR_STRINGS:,} strings "
        f"{lib_s:.3f} s against {py_s:.3f} s for the Python "
        f"murmurhash3_32, equal: {np.array_equal(got, want)}")
    if not np.array_equal(got, want):
        fail("murmur3_batch differs from murmurhash3_32")


def vgg_path(card) -> dict:
    """Phase 17 (a): ImageFeaturizer over VGG-16 at 224x224 (1000 classes)
    on uint8 rows, DeepVisionClassifier(vgg16) steps and a convnet_cifar
    fit; returns the main path's {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.models.deep_vision import DeepVisionClassifier
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.ops import image_kernels as K

    t_part = time.perf_counter()
    rng = np.random.default_rng(17)
    images = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
              for _ in range(VGG_ROWS)]
    table = Table({"image": images})
    t0 = time.perf_counter()
    bundle = TorchBundle("vgg16", {"num_classes": 1000},
                         input_shape=(IMG, IMG, 3), seed=0)
    n_params = sum(int(v.size) for v in bundle.state_dict.values())
    init_s = time.perf_counter() - t0
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=VGG_BATCH)
    chunks = math.ceil(VGG_ROWS / VGG_BATCH)
    zero_launches()
    t0 = time.perf_counter()
    feats = np.asarray(featurizer.transform(table)["features"])
    first_s = time.perf_counter() - t0
    launches = read_launches()
    if launches != dict(NO_LAUNCHES, affine_resample=chunks):
        fail(f"the VGG-16 featurizer launched {launches}, expected B1 once "
             f"a chunk ({chunks})")
    if feats.shape != (VGG_ROWS, 4096) or not np.isfinite(feats).all():
        fail(f"VGG-16 features: shape {feats.shape}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    featurizer.transform(table)
    warm_s = time.perf_counter() - t0

    plain_model = featurizer._model_for(bundle, "image")
    plain_model.set(preprocess=plain_preprocess(K))
    err_plain = rel_l2(feats, np.asarray(
        plain_model.transform(table)["features"]))
    cpu_bundle = TorchBundle("vgg16", {"num_classes": 1000},
                             state_dict=bundle.state_dict,
                             input_shape=(IMG, IMG, 3), dtype="float32")
    cpu_feats = np.asarray(ImageFeaturizer(
        bundle=cpu_bundle, batch_size=VGG_CPU_ROWS, device="cpu").transform(
            Table({"image": images[:VGG_CPU_ROWS]}))["features"])
    err_cpu = rel_l2(feats[:VGG_CPU_ROWS], cpu_feats)
    log(f"[phase 17] (a) ImageFeaturizer(vgg16, {IMG}x{IMG}, 1000 classes, "
        f"{n_params / 1e6:.1f}M parameters, bf16; random init in "
        f"{init_s:.2f} s) over {VGG_ROWS} uint8 256x256 rows at batch "
        f"{VGG_BATCH}: first transform {first_s:.3f} s, warm {warm_s:.3f} s "
        f"= {VGG_ROWS / warm_s:,.0f} images/s; launches {launches}; pool "
        f"features vs the plain-preprocess run rel_l2={err_plain:.3e} "
        f"(limit {PLAIN_FEATURES_RTOL}), vs an f32 CPU run of "
        f"{VGG_CPU_ROWS} rows rel_l2={err_cpu:.3e} (limit "
        f"{CPU_FEATURES_RTOL}) on {card}")
    if err_plain > PLAIN_FEATURES_RTOL or err_cpu > CPU_FEATURES_RTOL:
        fail("VGG-16 features disagree with the plain-preprocess or the CPU "
             "run")
    del featurizer, plain_model, cpu_bundle
    total = dict(launches)
    zero_launches()

    # DeepVisionClassifier(vgg16) at ImageNet width: a few SGD steps
    labels = rng.permutation(np.arange(VGG_TRAIN_ROWS) % VGG_CLASSES)
    rows = [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)
            for _ in range(VGG_TRAIN_ROWS)]
    train = Table({"image": rows, "label": labels})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = DeepVisionClassifier(backbone="vgg16", height=IMG, width=IMG,
                                 batch_size=VGG_BATCH, epochs=1,
                                 learning_rate=VGG_LR, seed=0).fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    memory = peak_mib(base)
    fit_launches = read_launches()
    out = model.transform(Table({"image": rows}))
    dv_launches = read_launches()
    steps = math.ceil(VGG_TRAIN_ROWS / VGG_BATCH)
    score_chunks = math.ceil(VGG_TRAIN_ROWS / 64)
    hist = np.asarray(model.loss_history)
    probs = np.asarray(out["probability"])
    log(f"[phase 17] (a) DeepVisionClassifier(vgg16, {IMG}x{IMG}, batch "
        f"{VGG_BATCH}, lr {VGG_LR}): {steps} steps in {fit_s:.3f} s (model "
        f"init and the weights' copy back included); loss_history "
        f"{np.array2string(hist, precision=4)}; launches fit {fit_launches}, "
        f"fit + transform {dv_launches}; {memory} on {card}")
    if fit_launches != dict(NO_LAUNCHES, affine_resample=steps) or \
            dv_launches != dict(NO_LAUNCHES,
                                affine_resample=steps + score_chunks):
        fail(f"DeepVisionClassifier(vgg16): B1 launched {fit_launches} / "
             f"{dv_launches}, expected once a step ({steps}) and once a "
             f"scoring chunk ({score_chunks})")
    if not np.isfinite(hist).all() or probs.shape != (
            VGG_TRAIN_ROWS, len(np.unique(labels))) or \
            not np.isfinite(probs).all():
        fail(f"DeepVisionClassifier(vgg16): loss {hist}, probabilities "
             f"{probs.shape}")
    del model, out
    torch.cuda.empty_cache()
    total = {k: total[k] + dv_launches[k] for k in KERNELS}
    zero_launches()

    # convnet_cifar on CIFAR-shaped rows (32x32, 10 classes)
    palette = rng.integers(0, 256, (CIFAR_CLASSES, 3))
    clabels = rng.integers(0, CIFAR_CLASSES, CIFAR_ROWS)
    cimages = np.clip(palette[clabels][:, None, None, :] + rng.normal(
        0, 20, (CIFAR_ROWS, 32, 32, 3)), 0, 255).astype(np.uint8)
    ctable = Table({"image": list(cimages), "label": clabels})
    t0 = time.perf_counter()
    cmodel = DeepVisionClassifier(backbone="convnet_cifar",
                                  batch_size=CIFAR_BATCH, epochs=1,
                                  learning_rate=CIFAR_LR, seed=0).fit(ctable)
    torch.cuda.synchronize()
    cfit_s = time.perf_counter() - t0
    cout = cmodel.transform(ctable)
    c_launches = read_launches()
    csteps = math.ceil(CIFAR_ROWS / CIFAR_BATCH)
    cchunks = math.ceil(CIFAR_ROWS / 64)
    chist = np.asarray(cmodel.loss_history)
    cacc = float((np.asarray(cout["prediction"]) == clabels).mean())
    log(f"[phase 17] (a) DeepVisionClassifier(convnet_cifar, lr {CIFAR_LR}): "
        f"{CIFAR_ROWS} 32x32 rows, {CIFAR_CLASSES} classes, batch "
        f"{CIFAR_BATCH}, 1 epoch "
        f"({csteps} steps) in {cfit_s:.3f} s = "
        f"{CIFAR_ROWS / cfit_s:,.0f} samples/s; loss "
        f"{np.array2string(chist, precision=4)}; accuracy on the table "
        f"{cacc:.4f}; launches {c_launches} on {card}")
    if c_launches != dict(NO_LAUNCHES, affine_resample=csteps + cchunks):
        fail(f"DeepVisionClassifier(convnet_cifar): B1 launched "
             f"{c_launches}, expected {csteps} steps + {cchunks} chunks")
    cprobs = np.asarray(cout["probability"])
    if not np.isfinite(chist).all() or cprobs.shape != (
            CIFAR_ROWS, CIFAR_CLASSES) or not cacc > CIFAR_ACC:
        fail(f"convnet_cifar: loss {chist}, probabilities {cprobs.shape}, "
             f"accuracy {cacc} (limit > {CIFAR_ACC})")
    log(f"[phase 17] (a) {time.perf_counter() - t_part:.1f} s")
    return {k: total[k] + c_launches[k] for k in KERNELS}


CONLL_TAG_NAMES = ("O", "B-PER", "I-PER", "B-ORG", "I-ORG", "B-LOC", "I-LOC",
                   "B-MISC", "I-MISC")


def conll_like(n: int, seed: int):
    """A CoNLL-2003-shaped corpus: sentences of 14.5 tokens on average
    (1 to 113) over a Zipf vocabulary of CONLL_VOCAB words, each word
    with a fixed one of the 9 tags (83% "O", CoNLL's share); the tag
    table is made from seed 0, so train and test rows agree."""
    import numpy as np

    table_rng = np.random.default_rng(0)
    word_tag = table_rng.choice(
        len(CONLL_TAG_NAMES), CONLL_VOCAB,
        p=[0.83] + [0.17 / (len(CONLL_TAG_NAMES) - 1)] * 8)
    freq = 1.0 / np.arange(1, CONLL_VOCAB + 1) ** 1.1
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(13.5, n) + 1, 1, 113)
    words = rng.choice(CONLL_VOCAB, int(lengths.sum()), p=freq / freq.sum())
    toks = np.empty(n, object)
    tags = np.empty(n, object)
    start = 0
    for i, k in enumerate(lengths):
        w = words[start:start + k]
        toks[i] = [f"w{j}" for j in w]
        tags[i] = [CONLL_TAG_NAMES[t] for t in word_tag[w]]
        start += k
    return toks, tags


def tagger_path(card) -> dict:
    """Phase 17 (b): SequenceTagger at its defaults (embed 64, hidden 128,
    10 epochs of Adam 1e-3) on a CoNLL-2003-shaped corpus on the card; a
    card fit against a CPU fit from one initial state on a prefix."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.bilstm import SequenceTagger, bucket_length

    t_part = time.perf_counter()
    toks, tags = conll_like(CONLL_TRAIN, seed=3)
    test_toks, test_tags = conll_like(CONLL_TEST, seed=4)
    n_tokens = sum(len(t) for t in toks)
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = SequenceTagger().fit(Table({"tokens": toks, "tags": tags}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    memory = peak_mib(base)
    t0 = time.perf_counter()
    pred = model.transform(Table({"tokens": test_toks}))["prediction"]
    score_s = time.perf_counter() - t0
    launches = read_launches()
    right = sum(int(np.sum(np.asarray(p) == np.asarray(t)))
                for p, t in zip(pred, test_tags))
    n_test = sum(len(t) for t in test_tags)
    acc = right / n_test
    majority = sum(t.count("O") for t in test_tags) / n_test
    buckets = sorted({bucket_length(len(t), tuple(model.buckets))
                      for t in toks})
    steps = 10 * len(buckets)
    log(f"[phase 17] (b) SequenceTagger(embed 64, hidden 128, 10 epochs) on "
        f"{CONLL_TRAIN:,} sentences / {n_tokens:,} tokens, "
        f"{len(model.vocab):,} words, {len(model.tag_vocab)} tags, buckets "
        f"{buckets} ({steps} Adam steps): fit {fit_s:.3f} s = "
        f"{n_tokens * 10 / fit_s:,.0f} tokens/s, "
        f"{fit_s / steps * 1e3:.1f} ms a step (wall); held-out "
        f"{CONLL_TEST:,} sentences tagged in {score_s:.3f} s, token "
        f"accuracy {acc:.4f} (the majority tag's share {majority:.4f}); "
        f"{memory} on {card}")
    if any(len(p) != len(t) for p, t in zip(pred, test_toks)) or \
            acc < majority - 0.01:
        fail(f"SequenceTagger: accuracy {acc} below the majority share "
             f"{majority}, or ragged predictions")
    # the card's fit against the CPU's, from one initial state (the seed's
    # torch.Generator), one epoch on a prefix
    prefix = Table({"tokens": toks[:CONLL_CPU_ROWS],
                    "tags": tags[:CONLL_CPU_ROWS]})
    runs = []
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs.append((SequenceTagger(epochs=1, device=dev).fit(prefix),
                     time.perf_counter() - t0))
    (card_fit, card_s), (cpu_fit, cpu_s) = runs
    worst = 0.0
    for cell, leaves in cpu_fit.model_params.items():
        for name, leaf in leaves.items():
            got = card_fit.model_params[cell][name]
            pairs = (leaf.items() if isinstance(leaf, dict)
                     else [(None, leaf)])
            for k, ref in pairs:
                g = got if k is None else got[k]
                worst = max(worst, float(np.abs(g - ref).max())
                            / max(float(np.abs(ref).max()), 1e-6))
    log(f"[phase 17] (b) one epoch on {CONLL_CPU_ROWS:,} sentences from one "
        f"initial state: card {card_s:.3f} s, CPU {cpu_s:.3f} s; every param "
        f"within {worst:.3e} of its tensor's largest (limit {TAGGER_TOL})")
    if worst > TAGGER_TOL:
        fail(f"SequenceTagger: the card's fit is {worst} off the CPU's")
    log(f"[phase 17] (b) {time.perf_counter() - t_part:.1f} s")
    return launches


def word2vec_path(card) -> dict:
    """Phase 17 (c): example 23's recipe 2 on phase 16 (c)'s reviews:
    Word2Vec at the reference's defaults on the card, its doc vectors into
    LogisticRegression; held-out accuracy and the step's time."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.featurize import Word2Vec
    from mmlspark_tpu_torch.featurize.text import _tokenize
    from mmlspark_tpu_torch.featurize.word2vec import sgns_step
    from mmlspark_tpu_torch.models.linear import LogisticRegression

    t_part = time.perf_counter()
    texts, stars = book_reviews(REVIEW_ROWS, seed=2)
    labels = (stars > 3).astype(np.float64)
    cut = REVIEW_TRAIN
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w2v = Word2Vec(input_col="text", output_col="features").fit(
        Table({"text": texts[:cut]}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_x = np.asarray(w2v.transform(Table({"text": texts[:cut]}))[
        "features"])
    test_x = np.asarray(w2v.transform(Table({"text": texts[cut:]}))[
        "features"])
    clf = LogisticRegression(max_iter=REVIEW_STEPS).fit(
        Table({"features": train_x, "label": labels[:cut]}))
    pred = np.asarray(clf.transform(Table({"features": test_x}))[
        "prediction"])
    launches = read_launches()
    acc = float(np.mean(pred == labels[cut:]))
    vocab = set(w2v.vocabulary)
    pairs = 0  # (center, context) pairs at window 3, as the fit counts them
    for doc in texts[:cut]:
        n = len([t for t in _tokenize(doc) if t in vocab])
        pairs += sum(min(n, i + 4) - max(0, i - 3) - 1 for i in range(n))
    steps = 3 * max(1, pairs // 1024)
    v, d = np.asarray(w2v.vectors).shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    w_in = torch.tensor(np.asarray(w2v.vectors), device="cuda")
    w_out = torch.zeros_like(w_in)
    g_in, g_out = torch.zeros_like(w_in), torch.zeros_like(w_in)
    c = torch.randint(0, v, (1024,), device="cuda", generator=gen)
    o = torch.randint(0, v, (1024,), device="cuda", generator=gen)
    neg = torch.randint(0, v, (1024, 4), device="cuda", generator=gen)
    step_ms = cuda_ms(lambda: sgns_step(w_in, w_out, g_in, g_out, c, o, neg,
                                        0.25), 50)
    syn = [s for s, _ in w2v.find_synonyms("superb", 4)]
    log(f"[phase 17] (c) Word2Vec at the reference's defaults (vector 32, "
        f"window 3, min_count 2, 4 negatives, 3 epochs, batch 1024) on "
        f"{cut:,} reviews: {len(w2v.vocabulary)} words, {pairs:,} pairs, "
        f"{steps} steps in {fit_s:.3f} s ({fit_s / steps * 1e3:.3f} ms a step "
        f"on the wall clock, {step_ms:.4f} ms a step on CUDA events); "
        f"losses {np.round(w2v.training_losses, 4).tolist()}; doc vectors "
        f"into LogisticRegression(max_iter={REVIEW_STEPS}): held-out "
        f"accuracy {acc:.6f} (limit > {W2V_ACC}); synonyms of 'superb' "
        f"{syn}; launches {launches} on {card}")
    if not acc > W2V_ACC or not np.isfinite(w2v.vectors).all():
        fail(f"Word2Vec recipe: held-out accuracy {acc} <= {W2V_ACC}")
    log(f"[phase 17] (c) {time.perf_counter() - t_part:.1f} s")
    return launches


def vw_columns(rng, n: int) -> dict:
    """examples/20_vowpal_wabbit_overview.py's census-ish rows."""
    import numpy as np

    jobs = ["clerk", "eng", "sales", "exec"]
    edus = ["hs", "college", "masters"]
    age = (rng.integers(18, 65, size=n) - 40.0) / 10.0
    hours = (rng.integers(20, 60, size=n) - 40.0) / 10.0
    job = rng.choice(jobs, size=n)
    edu = rng.choice(edus, size=n)
    score = (age + hours + (job == "exec") * 1.5 + (edu == "masters") * 1.0
             + rng.normal(size=n) * 0.3)
    return {"age": age, "hours": hours, "job": job, "edu": edu,
            "const": np.ones(n), "label": (score > 0).astype(np.float64)}


VW_COLS = ("age", "hours", "job", "edu", "const")


def vw_hashed_rows(cols: dict):
    """The rows VowpalWabbitFeaturizer(input_cols=VW_COLS, num_bits=
    VW_BITS) makes, built with array operations: (idx [n, 5] uint32,
    val [n, 5] f32, nnz [n]) with each row's nonzero slots first, sorted
    by index (zero numerics dropped, as the featurizer drops them)."""
    import numpy as np
    from mmlspark_tpu_torch.online.hashing import FeatureHasher

    h = FeatureHasher(VW_BITS, 0)
    n = len(cols["age"])
    idx = np.zeros((n, len(VW_COLS)), np.int64)
    val = np.zeros((n, len(VW_COLS)), np.float32)
    seen = set()
    for j, c in enumerate(VW_COLS):
        v = np.asarray(cols[c])
        if v.dtype.kind in "fiu":
            idx[:, j] = h(c, c)
            val[:, j] = v
            seen.add(h(c, c))
        else:
            levels = sorted(set(v.tolist()))
            table = {lv: h(c, lv) for lv in levels}
            seen |= set(table.values())
            idx[:, j] = np.vectorize(table.get)(v)
            val[:, j] = 1.0
    if len(seen) != 3 + 4 + 3:
        fail("example 20's hashed slots collide: the array build would need "
             "the featurizer's collision sums")
    key = np.where(val != 0, idx, np.int64(1) << 40)
    order = np.argsort(key, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, 1).astype(np.uint32)
    val = np.take_along_axis(val, order, 1)
    return idx, val, (val != 0).sum(axis=1)


def object_rows(idx, val, nnz):
    import numpy as np

    col = np.empty(len(idx), object)
    for i in range(len(idx)):
        k = nnz[i]
        col[i] = (idx[i, :k], val[i, :k])
    return col


def k1_bound_ms(plan_nnz, n: int) -> float:
    """K1's byte bound: each nonzero slot's index and value read once,
    its w and g2 entries read and written once (24 bytes a slot), each
    row's label read and its loss and valid flag written (12 bytes)."""
    return (24.0 * float(plan_nnz) + 12.0 * n) / HBM_BYTES_PER_S * 1e3


def vw_path(card):
    """Phase 17 (d): example 20's rows at num_bits 18 through
    VowpalWabbitClassifier on the card (1,000,000 rows: K1's time), a
    20,000-row prefix against the plain loop, and a contextual-bandit log
    of 100,000 events.  Returns (main-path launches, K1's record)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.online import (VowpalWabbitClassifier,
                                           VowpalWabbitContextualBandit,
                                           VowpalWabbitFeaturizer)
    from mmlspark_tpu_torch.online.hashing import FeatureHasher
    from mmlspark_tpu_torch.ops import online_pass as OP

    t_part = time.perf_counter()
    rng = np.random.default_rng(20)
    cols = vw_columns(rng, VW_ROWS)
    t0 = time.perf_counter()
    idx, val, nnz = vw_hashed_rows(cols)
    prefix = {c: cols[c][:VW_PREFIX] for c in cols}
    featurized = VowpalWabbitFeaturizer(
        input_cols=list(VW_COLS), num_bits=VW_BITS).transform(
            Table(dict(prefix)))["features"]
    for i, (fi, fv) in enumerate(featurized):
        k = nnz[i]
        if not (np.array_equal(fi, idx[i, :k]) and fi.dtype == np.uint32
                and np.array_equal(fv, val[i, :k])):
            fail(f"example 20's row {i}: the array build {idx[i, :k]} "
                 f"{val[i, :k]} differs from the featurizer's {fi} {fv}")
    features = object_rows(idx, val, nnz)
    host_s = time.perf_counter() - t0
    table = Table({"features": features, "label": cols["label"]})
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = VowpalWabbitClassifier(num_passes=VW_PASSES, learning_rate=0.5,
                                 num_bits=VW_BITS).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    stats = clf.performance_statistics
    t0 = time.perf_counter()
    pred = np.asarray(clf.transform(table)["prediction"])
    score_s = time.perf_counter() - t0
    launches = read_launches()
    acc = float(np.mean(pred == cols["label"]))
    losses = np.asarray(stats["average_loss"])
    log(f"[phase 17] (d) VowpalWabbitClassifier(num_bits {VW_BITS}, "
        f"{VW_PASSES} passes) on example 20's rows, {VW_ROWS:,} (hashed "
        f"rows built with array operations in {host_s:.2f} s, equal to "
        f"VowpalWabbitFeaturizer's on the first {VW_PREFIX:,}): fit "
        f"{fit_s:.3f} s (ingest {stats['ingest_time_ns'][0] / 1e9:.3f} s, "
        f"learn {stats['learn_time_ns'][0] / 1e9:.3f} s) = "
        f"{VW_ROWS * VW_PASSES / fit_s:,.0f} examples/s; per-pass loss "
        f"{np.round(losses, 5).tolist()}; transform {score_s:.3f} s; "
        f"accuracy {acc:.4f}; launches {launches} on {card}")
    if launches != dict(NO_LAUNCHES, online_pass=VW_PASSES):
        fail(f"VowpalWabbitClassifier launched {launches}, expected K1 once "
             f"a pass ({VW_PASSES})")
    if not acc > 0.8 or not losses[-1] < losses[0]:
        fail(f"VowpalWabbitClassifier: accuracy {acc}, losses {losses}")

    # K1 alone: one pass over the million rows, and its per-example floor
    # on a chain of one-slot rows of one index (CUDA events, warm)
    dev = torch.device("cuda")
    y = torch.as_tensor(np.where(cols["label"] > 0, 1.0, -1.0).astype(
        np.float32), device=dev)
    plan = OP.plan_rows(torch.as_tensor(idx.astype(np.int64), device=dev),
                        torch.as_tensor(val, device=dev))
    dim = 1 << VW_BITS

    def one_pass(p, yy):
        w = torch.zeros(dim, device=dev)
        g2 = torch.zeros(dim, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = OP.online_pass(w, g2, p, yy, 0.5, loss="logistic")
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), w, g2, out

    one_pass(plan, y)
    full_ms = one_pass(plan, y)[0]
    chain = OP.plan_rows(torch.zeros(VW_ROWS, 1, dtype=torch.int64,
                                     device=dev),
                         torch.ones(VW_ROWS, 1, device=dev))
    chain_ms = one_pass(chain, y)[0]
    full_nnz = int(plan.nnz.sum())
    full_bound = k1_bound_ms(full_nnz, VW_ROWS)

    # the prefix: K1 against its plain loop on the card, two launches
    # compared bit for bit
    pplan = OP.plan_rows(plan.idx[:VW_PREFIX].long(), plan.val[:VW_PREFIX])
    py = y[:VW_PREFIX].contiguous()
    ms_a, w_a, g_a, (l_a, v_a) = one_pass(pplan, py)
    ms_b, w_b, g_b, (l_b, v_b) = one_pass(pplan, py)
    same = (torch.equal(w_a, w_b) and torch.equal(g_a, g_b)
            and torch.equal(l_a, l_b) and torch.equal(v_a, v_b))
    k1_ms = min(ms_a, ms_b)
    w_p = torch.zeros(dim, device=dev)
    g_p = torch.zeros(dim, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_p, v_p = OP.online_pass_plain(w_p, g_p, pplan, py, 0.5,
                                    loss="logistic")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((w_a - w_p).abs().max())
    scale = float(w_p.abs().max())
    loss_err = float((l_a - l_p).abs().max())
    prefix_nnz = int(pplan.nnz.sum())
    bound = k1_bound_ms(prefix_nnz, VW_PREFIX)
    log(f"[phase 17] (d) K1 one pass over {VW_ROWS:,} rows ({full_nnz:,} "
        f"nonzero slots): {full_ms:.3f} ms = "
        f"{full_ms / VW_ROWS * 1e6:.1f} ns an example; byte bound "
        f"{full_bound:.4f} ms; over {VW_ROWS:,} one-slot rows of one index "
        f"(the chain of dependent examples alone) {chain_ms:.3f} ms = "
        f"{chain_ms / VW_ROWS * 1e6:.1f} ns an example (CUDA events) on "
        f"{card}")
    log(f"[phase 17] (d) K1 on the first {VW_PREFIX:,} rows: {k1_ms:.4f} ms "
        f"against the plain loop's {plain_ms:.1f} ms on the card (host "
        f"clock); byte bound {bound:.5f} ms; weights max |diff| {err:.3e} "
        f"({err / scale:.3e} of max |w|, limit {K1_W_RTOL}), per-example "
        f"losses max |diff| {loss_err:.3e}; two launches bit for bit: "
        f"{same}")
    if not same:
        fail("K1: two launches from one state differ")
    if err > K1_W_RTOL * scale or not torch.equal(v_a, v_p) or \
            loss_err > K1_W_RTOL * max(1.0, float(l_p.abs().max())):
        fail(f"K1 disagrees with its plain loop: weights {err}, losses "
             f"{loss_err}")
    record = {"err": err, "ms": k1_ms, "plain_ms": plain_ms,
              "bound_ms": bound, "bound_by": "bytes", "library_ms": None}
    del plan, chain, pplan
    torch.cuda.empty_cache()

    # a contextual-bandit log: shared context, 4 actions each, a uniform
    # logging policy
    n, acts, d = CB_EVENTS, 4, 6
    h = FeatureHasher(VW_BITS, 0)
    ctx = rng.normal(size=(n, d)).astype(np.float32)
    true_w = rng.normal(size=(acts, d)).astype(np.float32)
    shared_idx = np.array([h("shared", f"s{j}") for j in range(d)],
                          np.uint32)
    act_idx = [np.array([h(f"act{a}", f"x{j}") for j in range(d)],
                        np.uint32) for a in range(acts)]
    chosen = rng.integers(0, acts, n)
    cost = (np.einsum("nd,nd->n", true_w[chosen], ctx)
            + 0.1 * rng.normal(size=n)).astype(np.float32)
    shared = np.empty(n, object)
    actions = np.empty(n, object)
    for i in range(n):
        shared[i] = (shared_idx, ctx[i])
        actions[i] = [(act_idx[a], ctx[i]) for a in range(acts)]
    log_table = Table({"shared": shared, "features": actions,
                       "chosen_action": chosen + 1, "cost": cost,
                       "probability": np.full(n, 1.0 / acts, np.float32)})
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb = VowpalWabbitContextualBandit(num_bits=VW_BITS, num_passes=1,
                                      learning_rate=0.5).fit(log_table)
    torch.cuda.synchronize()
    cb_s = time.perf_counter() - t0
    cb_launches = read_launches()
    m = cb.train_metrics
    greedy = np.array([int(np.argmin(s)) for s in
                       cb.transform(log_table)["prediction"]])
    greedy_cost = float(np.mean(np.einsum("nd,nd->n", true_w[greedy], ctx)))
    uniform_cost = float(np.mean(ctx @ true_w.T))
    log(f"[phase 17] (d) VowpalWabbitContextualBandit on a log of {n:,} "
        f"events ({acts} actions, shared context): fit {cb_s:.3f} s "
        f"(the IPS / SNIPS pass over the log included); average loss "
        f"{m['average_loss']:.5f}, IPS {m['ips_estimate']:.5f}, SNIPS "
        f"{m['snips_estimate']:.5f}; the greedy policy's true cost "
        f"{greedy_cost:.4f} against the logging policy's {uniform_cost:.4f}; "
        f"launches {cb_launches} on {card}")
    if cb_launches != dict(NO_LAUNCHES, online_pass=1):
        fail(f"the contextual bandit launched {cb_launches}, expected K1 "
             f"once")
    if not greedy_cost < uniform_cost - 0.1 or not np.isfinite(
            [m["ips_estimate"], m["snips_estimate"]]).all():
        fail(f"contextual bandit: greedy cost {greedy_cost} against "
             f"{uniform_cost}")
    log(f"[phase 17] (d) {time.perf_counter() - t_part:.1f} s")
    return {k: launches[k] + cb_launches[k] for k in KERNELS}, record


def knn_path(card) -> dict:
    """Phase 17 (e): KNN over SIFT1M-shaped keys (1,000,000 x 128,
    non-negative integer descriptors) with 10,000 queries, k = 5; 500
    queries against an f64 top-k on the CPU; ConditionalKNN on example
    18."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.nn import KNN, ConditionalKNN

    t_part = time.perf_counter()
    rng = np.random.default_rng(18)
    keys = np.maximum(rng.integers(-40, 64, (KNN_KEYS, KNN_DIM),
                                   dtype=np.int16), 0).astype(np.float32)
    queries = np.maximum(rng.integers(-40, 64, (KNN_QUERIES, KNN_DIM),
                                      dtype=np.int16), 0).astype(np.float32)
    zero_launches()
    t0 = time.perf_counter()
    model = KNN(k=KNN_K).fit(Table({"features": keys,
                                    "values": np.arange(KNN_KEYS)}))
    fit_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = model.transform(Table({"features": queries}))["output"]
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    memory = peak_mib(base)
    knn_launches = read_launches()
    got = np.array([[m["value"] for m in row] for row in out[:KNN_CHECK]])
    dist = np.array([[m["distance"] for m in row] for row in out[:KNN_CHECK]])
    k64 = keys.astype(np.float64)
    moved, worst = 0, 0.0
    for lo in range(0, KNN_CHECK, 50):
        s = queries[lo:lo + 50].astype(np.float64) @ k64.T
        for r in range(s.shape[0]):
            row = s[r]
            kth = np.partition(row, -KNN_K)[-KNN_K]
            above = np.flatnonzero(row > kth)
            eq = np.flatnonzero(row == kth)[:KNN_K - len(above)]
            cand = np.concatenate([above, eq])
            want = cand[np.lexsort((cand, -row[cand]))]
            q = lo + r
            worst = max(worst, float(np.max(np.abs(dist[q] - row[got[q]])
                                            / np.maximum(np.abs(row[got[q]]),
                                                         1.0))))
            if not np.array_equal(got[q], want):
                moved += 1
                a, b = row[got[q]], row[want]
                if np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)) > \
                        KNN_TIE_RTOL:
                    fail(f"KNN query {q}: {got[q]} against the f64 top-k "
                         f"{want} (scores {a} / {b})")
    log(f"[phase 17] (e) KNN(k={KNN_K}) over {KNN_KEYS:,} x {KNN_DIM} keys "
        f"(SIFT1M's shape): fit (the host ball tree) {fit_s:.3f} s; "
        f"{KNN_QUERIES:,} queries in {query_s:.3f} s = "
        f"{KNN_QUERIES / query_s:,.0f} queries/s; {KNN_CHECK} queries "
        f"against an f64 top-k on the CPU: {moved} with a rank moved "
        f"within a {KNN_TIE_RTOL} near-tie, distances within {worst:.2e} "
        f"relative; launches {knn_launches}; {memory} on {card}")
    if worst > KNN_TIE_RTOL:
        fail(f"KNN distances {worst} off the f64 scores")
    # ConditionalKNN on example 18: four culture clusters of 60
    cultures = ["greek", "egyptian", "japanese", "maya"]
    centers = rng.normal(size=(4, 16)) * 3.0
    x = np.concatenate([centers[c] + rng.normal(size=(60, 16))
                        for c in range(4)]).astype(np.float32)
    culture = [c for c in cultures for _ in range(60)]
    index = Table({"features": x, "values": [f"{c}-{i}" for i, c in
                                             enumerate(culture)],
                   "labels": culture, "conditioner": [{c} for c in culture]})
    cknn = ConditionalKNN(k=4, label_col="labels").fit(index)
    q = (centers[0] + rng.normal(size=16) * 0.5).astype(np.float32)
    for cond in ({"greek"}, {"egyptian"}, {"greek", "japanese"}):
        res = cknn.transform(Table({"features": q[None, :],
                                    "conditioner": [cond]}))["output"][0]
        mask = np.asarray([c in cond for c in culture])
        brute = np.sort(x[mask] @ q)[-4:][::-1]
        if not all(m["label"] in cond for m in res) or not np.allclose(
                [m["distance"] for m in res], brute, rtol=1e-5):
            fail(f"ConditionalKNN on example 18 ({sorted(cond)}): {res}")
    launches = read_launches()
    log(f"[phase 17] (e) ConditionalKNN on example 18: conditioners "
        f"respected, scores within 1e-5 of the brute force; KNN and "
        f"ConditionalKNN launches {launches}")
    log(f"[phase 17] (e) {time.perf_counter() - t_part:.1f} s")
    return launches


def movielens_like(seed: int):
    """A MovieLens-1M-shaped log: 6,040 users x 3,706 movies, 1,000,209
    distinct (user, movie) ratings, every user with at least 20 (a
    log-normal activity), movies by a Zipf popularity, ratings 1-5 and
    timestamps over ML-1M's span (April 2000 to February 2003)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    raw = rng.lognormal(4.3, 0.95, ML_USERS)
    counts = np.clip(np.round(raw * ML_EVENTS / raw.sum()), 20,
                     ML_ITEMS).astype(np.int64)
    while counts.sum() != ML_EVENTS:
        diff = int(ML_EVENTS - counts.sum())
        step = 1 if diff > 0 else -1
        ok = np.flatnonzero((counts + step >= 20) & (counts + step <= ML_ITEMS))
        pick = rng.choice(ok, min(abs(diff), len(ok)), replace=False)
        counts[pick] += step
    pop = np.log(1.0 / np.arange(1, ML_ITEMS + 1) ** 0.9)[
        rng.permutation(ML_ITEMS)]
    keys = pop[None, :] + rng.gumbel(size=(ML_USERS, ML_ITEMS))
    order = np.argsort(-keys, axis=1)
    take = np.arange(ML_ITEMS)[None, :] < counts[:, None]
    items = order[take]
    users = np.repeat(np.arange(ML_USERS), counts)
    return {"user": users, "item": items,
            "rating": rng.integers(1, 6, ML_EVENTS).astype(np.float32),
            "ts": rng.uniform(956703932, 1046454590, ML_EVENTS)}


def sar_path(card) -> dict:
    """Phase 17 (f): SAR (jaccard, support 4, time decay) on a
    MovieLens-1M-shaped log on the card, top 10 for every user, against
    the CPU's fit."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.recommendation import SAR

    t_part = time.perf_counter()
    cols = movielens_like(seed=6)
    table = Table(cols)
    kw = dict(similarity_function="jaccard", support_threshold=4,
              timestamp_col="ts")
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = SAR(**kw).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = model.recommend_for_all_users(SAR_K)
    rec_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    cpu = SAR(**kw, device="cpu").fit(table)
    cpu_recs = cpu.recommend_for_all_users(SAR_K)
    cpu_s = time.perf_counter() - t0
    s_err = float(np.abs(np.asarray(model.item_similarity)
                         - np.asarray(cpu.item_similarity)).max())
    zeros_same = bool(np.array_equal(np.asarray(model.item_similarity) == 0,
                                     np.asarray(cpu.item_similarity) == 0))
    moved = 0
    unseen = ML_ITEMS - np.bincount(cols["user"], minlength=ML_USERS)
    for u, (a, b, sa, sb) in enumerate(zip(
            recs["recommendations"], cpu_recs["recommendations"],
            recs["scores"], cpu_recs["scores"])):
        if len(a) != min(SAR_K, unseen[u]):
            fail(f"SAR: user {u} got {len(a)} recommendations")
        if not np.array_equal(a, b):
            moved += 1
            if np.max(np.abs(np.asarray(sa) - np.asarray(sb))
                      / np.maximum(np.abs(np.asarray(sb)), 1e-6)) > 1e-5:
                fail(f"SAR: the card's top {SAR_K} {a} against the CPU's "
                     f"{b} (scores {sa} / {sb})")
    log(f"[phase 17] (f) SAR(jaccard, support 4, 30-day half-life) on a "
        f"MovieLens-1M-shaped log ({ML_USERS:,} users x {ML_ITEMS:,} items, "
        f"{ML_EVENTS:,} events): fit {fit_s:.3f} s, top {SAR_K} for every "
        f"user {rec_s:.3f} s = {ML_USERS / rec_s:,.0f} users/s (the CPU's "
        f"fit and top {SAR_K}: {cpu_s:.3f} s); similarities within "
        f"{s_err:.2e} of the CPU's (limit 1e-6), support zeros equal "
        f"{zeros_same}; {moved} users' lists moved within a 1e-5 near-tie; "
        f"launches {launches} on {card}")
    if s_err > 1e-6 or not zeros_same or moved > 0.01 * ML_USERS:
        fail(f"SAR on the card: similarities {s_err} off, zeros "
             f"{zeros_same}, {moved} lists moved")
    log(f"[phase 17] (f) {time.perf_counter() - t_part:.1f} s")
    return launches


def iforest_path(card) -> dict:
    """Phase 17 (g): IsolationForest (100 trees x 256) on a table of the
    credit-card-fraud set's shape (284,807 x 30: Time, 28 PCA columns,
    Amount; 492 planted outliers) on the card, against the CPU's scores."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.isolationforest import (IsolationForest,
                                                    IsolationForestModel)

    t_part = time.perf_counter()
    rng = np.random.default_rng(7)
    x = rng.normal(size=(IFOREST_ROWS, IFOREST_COLS)).astype(np.float32)
    x[:, 0] = np.sort(rng.uniform(0, 172_792, IFOREST_ROWS))
    x[:, -1] = rng.lognormal(3.0, 1.4, IFOREST_ROWS)
    fraud = rng.choice(IFOREST_ROWS, IFOREST_FRAUD, replace=False)
    x[fraud, 1:-1] += rng.normal(0, 4, (IFOREST_FRAUD, IFOREST_COLS - 2))
    table = Table({"features": x})
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = IsolationForest(num_estimators=100, max_samples=256,
                            contamination=IFOREST_FRAUD / IFOREST_ROWS,
                            seed=0).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(table)
    score_s = time.perf_counter() - t0
    launches = read_launches()
    scores = np.asarray(out["outlier_score"])
    flagged = np.asarray(out["predicted_label"]).astype(bool)
    cpu = IsolationForestModel(trees=model.trees, max_depth=model.max_depth,
                               subsample_size=model.subsample_size,
                               threshold=model.threshold, device="cpu")
    err = float(np.abs(scores[:IFOREST_CPU_ROWS]
                       - cpu._scores(x[:IFOREST_CPU_ROWS])).max())
    recall = float(flagged[fraud].mean())
    log(f"[phase 17] (g) IsolationForest(100 trees x 256) on "
        f"{IFOREST_ROWS:,} x {IFOREST_COLS} (the credit-card-fraud set's "
        f"shape, {IFOREST_FRAUD} planted outliers): fit {fit_s:.3f} s (the "
        f"threshold's scoring pass included), transform {score_s:.3f} s = "
        f"{IFOREST_ROWS / score_s:,.0f} rows/s; scores within {err:.2e} of "
        f"the CPU's on {IFOREST_CPU_ROWS:,} rows (limit 1e-6); "
        f"{int(flagged.sum())} rows flagged, {recall:.3f} of the planted "
        f"outliers; launches {launches} on {card}")
    if err > 1e-6 or not recall > 0.5:
        fail(f"IsolationForest: scores {err} off the CPU's, recall {recall}")
    log(f"[phase 17] (g) {time.perf_counter() - t_part:.1f} s")
    return launches


def breast_cancer_like(seed: int):
    """The shape of example 17's table (scikit-learn's breast-cancer set:
    569 rows, 30 features, 212 / 357 classes), standardized."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y = np.zeros(BREAST_ROWS)
    y[rng.choice(BREAST_ROWS, 357, replace=False)] = 1.0
    mix = rng.normal(size=(BREAST_COLS, BREAST_COLS)) / BREAST_COLS ** 0.5
    x = rng.normal(size=(BREAST_ROWS, BREAST_COLS)) @ mix
    x += np.outer(y - 0.5, rng.normal(0.35, 0.3, BREAST_COLS))
    x = (x - x.mean(0)) / (x.std(0) + 1e-9)
    return x.astype(np.float32), y


def automl_path(card) -> dict:
    """Phase 17 (h): example 17's grid on the card: LogisticRegression and
    GBDTClassifier over a two-point learning-rate grid, 3-fold CV, two
    trials at a time."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.automl import (DiscreteHyperParam, GridSpace,
                                           HyperparamBuilder,
                                           TuneHyperparameters)
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.models.linear import LogisticRegression

    t_part = time.perf_counter()
    x, y = breast_cancer_like(seed=17)
    table = Table({"features": x, "label": y})
    space = (HyperparamBuilder()
             .add_hyperparam("learning_rate", DiscreteHyperParam([0.02, 0.2]))
             .build())
    zero_launches()
    t0 = time.perf_counter()
    tuned = TuneHyperparameters(
        models=[LogisticRegression(max_iter=100),
                GBDTClassifier(num_iterations=30, num_leaves=7,
                               min_data_in_leaf=10, seed=0)],
        param_space=GridSpace(space), evaluation_metric="accuracy",
        num_folds=3, parallelism=2, seed=1).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    acc = float(np.mean(np.asarray(tuned.transform(table)["prediction"])
                        == y))
    launches = read_launches()
    trials = ", ".join(f"{m['estimator']} {m['params']} {m['metric']:.4f}"
                       for m in tuned.all_metrics)
    log(f"[phase 17] (h) example 17's grid on the card ({BREAST_ROWS} x "
        f"{BREAST_COLS}): {len(tuned.all_metrics)} trials x 3 folds + the "
        f"winner's refit in {fit_s:.3f} s, two trials at a time; {trials}; "
        f"winner CV accuracy {tuned.best_metric:.4f}, train-set accuracy "
        f"{acc:.4f}; launches {launches} on {card}")
    if len(tuned.all_metrics) != 4 or not tuned.best_metric > 0.9 or \
            not acc > 0.9:
        fail(f"example 17's grid: {tuned.all_metrics}, train accuracy {acc}")
    log(f"[phase 17] (h) {time.perf_counter() - t_part:.1f} s")
    return launches


def solve_gap(states, weights, targets, coefs, intercepts):
    """A LIME solve on the card against the host's f64 solve of the same
    design and targets (both with the 1e-6 ridge): the coefficients' gap in
    units of each design column's spread over its largest, the fitted
    values' gap over the targets' range, and the card solve's ms (CUDA
    events, 10 calls)."""
    import numpy as np
    import torch

    from mmlspark_tpu_torch.explainers.regression import (
        batch_weighted_least_squares, np_batch_weighted_least_squares)

    ref_c, ref_i = np_batch_weighted_least_squares(states, targets, weights,
                                                   l2=1e-6)
    sd = np.asarray(states, np.float64).std(axis=1)[:, None, :]
    coef_gap = float(np.abs((coefs - ref_c) * sd).max()
                     / max(np.abs(ref_c * sd).max(), 1e-300))

    def fitted(c, i):
        return np.einsum("nsd,ntd->nst", np.asarray(states, np.float64),
                         np.asarray(c, np.float64)) + \
            np.asarray(i, np.float64)[:, None, :]

    span = float(np.ptp(targets))
    fit_gap = float(np.abs(fitted(coefs, intercepts) - fitted(ref_c, ref_i)
                           ).max() / max(span, 1e-300))
    x, y, w = (torch.as_tensor(np.asarray(a, np.float32), device="cuda")
               for a in (states, targets, weights))
    ms = cuda_ms(lambda: batch_weighted_least_squares(x, y, w), 10)
    return coef_gap, fit_gap, ms


def shap_additivity(states, targets, coefs, intercepts, dims):
    """KernelSHAP's additivity, Σφ = f(x) − f(∅), per row and target.  The
    full (sample 0) and null (sample 1) coalitions weigh SHAP_ANCHOR against
    1 for each of the s − 2 others, and the weighted normal equations of the
    intercept and of the fraction-on direction give |Σφ − (f(x) − f(∅))| ≤
    (s − 2) / SHAP_ANCHOR · max |interior residual| for the exact fit; the
    limit adds 1e-6 of Σ|φ| + |f(x)| + |f(∅)| for the f32 rounding of the
    output.  Returns (max error, max error / limit)."""
    import numpy as np

    states = np.asarray(states, np.float64)
    targets = np.asarray(targets, np.float64)
    coefs = np.asarray(coefs, np.float64)
    s = states.shape[1]
    worst_err = worst_ratio = 0.0
    for i, k in enumerate(dims):
        phi = coefs[i][:, :k].sum(axis=1)  # (t,)
        f = targets[i]  # (s, t)
        err = np.abs(phi - (f[0] - f[1]))
        pred = states[i] @ coefs[i].T + np.asarray(intercepts[i], np.float64)
        resid = np.abs(f[2:] - pred[2:]).max(axis=0)
        limit = (s - 2) / SHAP_ANCHOR * resid + 1e-6 * (
            np.abs(coefs[i][:, :k]).sum(axis=1) + np.abs(f[0]) + np.abs(f[1]))
        worst_err = max(worst_err, float(err.max()))
        worst_ratio = max(worst_ratio, float((err / limit).max()))
    return worst_err, worst_ratio


def image_explainer_path(card) -> dict:
    """Phase 18 (a): ImageLIME and ImageSHAP over a ResNet-50
    ImageFeaturizer (224x224, 1000 classes, the logits tap) whose scores
    are each image's top-class probability; returns {kernel: launches}."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import LambdaTransformer, PipelineModel, Table
    from mmlspark_tpu_torch.explainers import (ImageLIME, ImageSHAP,
                                               SuperpixelTransformer)
    from mmlspark_tpu_torch.models.bundle import TorchBundle
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.ops import image_kernels as K

    t_part = time.perf_counter()
    rng = np.random.default_rng(18)
    images = [rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)
              for _ in range(EXPLAIN_IMAGES)]
    bundle = TorchBundle("resnet50", {"num_classes": 1000},
                         input_shape=(IMG, IMG, 3), seed=0)
    featurizer = ImageFeaturizer(bundle=bundle, cut_output_layers=0,
                                 output_col="logits",
                                 batch_size=EXPLAIN_BATCH)
    table = Table({"image": images})
    top = np.asarray(featurizer.transform(table)["logits"]).argmax(axis=1)
    table = table.with_column("top", top.astype(np.int64))
    t0 = time.perf_counter()
    table = SuperpixelTransformer(input_col="image",
                                  output_col="superpixels").transform(table)
    slic_s = time.perf_counter() - t0
    n_seg = [int(v.max()) + 1 for v in table["superpixels"]]
    scored = []

    def top_class_probability(t):
        logits = np.asarray(t["logits"], np.float64)
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        out = p[np.arange(len(t)), np.asarray(t["top"])].astype(np.float32)
        scored.append((np.asarray(t["logits"]), out))
        return t.with_column("scores", out)

    stack = PipelineModel([featurizer,
                           LambdaTransformer(top_class_probability)])
    n = EXPLAIN_IMAGES * EXPLAIN_SAMPLES
    chunks = math.ceil(n / EXPLAIN_BATCH)
    total = dict(NO_LAUNCHES)
    for cls in (ImageLIME, ImageSHAP):
        name = cls.__name__
        exp = cls(model=stack, superpixel_col="superpixels",
                  num_samples=EXPLAIN_SAMPLES, seed=18)
        scored.clear()
        zero_launches()
        with timing(exp, "_build_samples") as builds, \
                timing(stack, "transform") as forwards, \
                timing(exp, "_solve") as solves:
            t0 = time.perf_counter()
            out = exp.transform(table)
            wall = time.perf_counter() - t0
        launches = read_launches()
        if launches != dict(NO_LAUNCHES, affine_resample=chunks):
            fail(f"{name} over ResNet-50 launched {launches}, expected B1 "
                 f"once a chunk ({chunks})")
        total = {k: total[k] + launches[k] for k in KERNELS}
        expl = np.stack([np.asarray(v) for v in out["explanation"]])
        if expl.shape != (EXPLAIN_IMAGES, 1, max(n_seg)) or \
                not np.isfinite(expl).all():
            fail(f"{name}: explanations {expl.shape}, finite "
                 f"{np.isfinite(expl).all()}")
        solve_s, (states, weights, targets), (coefs, inter) = solves[0]
        logits, probs = scored[0]
        if name == "ImageLIME":
            # the same samples (seeded) through the plain preprocess
            samples, _ = exp._build_samples(table)
            plain_model = featurizer._model_for(bundle, "image")
            plain_model.set(preprocess=plain_preprocess(K))
            plain = np.asarray(plain_model.transform(samples)["logits"])
            err_logits = rel_l2(logits, plain)
            p = np.exp(plain - plain.max(axis=1, keepdims=True))
            p = (p / p.sum(axis=1, keepdims=True))[
                np.arange(n), np.repeat(top, EXPLAIN_SAMPLES)]
            err_scores = rel_l2(probs, p)
            del samples, plain_model
            coef_gap, fit_gap, solve_ms = solve_gap(states, weights, targets,
                                                    coefs, inter)
            check = (f"logits vs the plain-preprocess run rel_l2="
                     f"{err_logits:.3e}, scores {err_scores:.3e} (limit "
                     f"{PLAIN_FEATURES_RTOL}); the card's f32 WLS against "
                     f"the f64 host solve: coefficients {coef_gap:.3e} of the "
                     f"largest, fitted values {fit_gap:.3e} of the targets' "
                     f"range (limit {SOLVE_RTOL}); the solve "
                     f"{solve_ms:.4f} ms (CUDA events; {solve_s * 1e3:.2f} "
                     f"ms wall with the copies)")
            if max(err_logits, err_scores) > PLAIN_FEATURES_RTOL or \
                    max(coef_gap, fit_gap) > SOLVE_RTOL:
                fail(f"ImageLIME: {check}")
        else:
            err, ratio = shap_additivity(states, targets, coefs, inter,
                                         n_seg)
            check = (f"additivity |Σφ − (f(x) − f(∅))| at most {err:.3e}, "
                     f"{ratio:.3e} of its limit (the anchor bound); the host "
                     f"f64 solve {solve_s * 1e3:.2f} ms")
            if not ratio <= 1.0:
                fail(f"ImageSHAP: {check}")
        log(f"[phase 18] (a) {name}(ResNet-50, {IMG}x{IMG}, 1000 classes, "
            f"bf16) on {EXPLAIN_IMAGES} images x {EXPLAIN_SAMPLES} samples, "
            f"{n_seg} superpixels: {wall:.3f} s = masking "
            f"{sum(b[0] for b in builds):.3f} s + the model "
            f"{forwards[0][0]:.3f} s ({n / forwards[0][0]:,.0f} images/s) + "
            f"the rest; launches {launches}; {check} on {card}")
        del out, states, targets, logits
    log(f"[phase 18] (a) SLIC (SuperpixelTransformer) {slic_s:.3f} s for "
        f"{EXPLAIN_IMAGES} images")
    log(f"[phase 18] (a) {time.perf_counter() - t_part:.1f} s")
    del featurizer, stack, bundle
    torch.cuda.empty_cache()
    return total


def tabular_explainer_path(adult_model, adult_test, card) -> None:
    """Phase 18 (b): example 14's TabularSHAP over GBDTClassifier on the
    breast-cancer set's shape, then TabularLIME over phase 16 (a)'s Adult
    model on its six numeric columns."""
    import numpy as np
    from mmlspark_tpu_torch import LambdaTransformer, Table
    from mmlspark_tpu_torch.explainers import TabularLIME, TabularSHAP
    from mmlspark_tpu_torch.gbdt import GBDTClassifier

    t_part = time.perf_counter()
    x, y = breast_cancer_like(seed=14)
    table = Table({"features": x, "label": y})
    gbdt = GBDTClassifier(num_iterations=60, num_leaves=15,
                          min_data_in_leaf=10, seed=0).fit(table)

    def malignant(t):
        return t.with_column("scores", np.asarray(
            gbdt.transform(t)["probability"])[:, 1])

    shap = TabularSHAP(model=LambdaTransformer(malignant),
                       num_samples=TAB_SHAP_SAMPLES, seed=7,
                       background_data=table)
    rows = Table({"features": x[:EXPLAIN_ROWS]})
    with timing(shap, "_solve") as solves:
        t0 = time.perf_counter()
        out = shap.transform(rows)
        wall = time.perf_counter() - t0
    _, (states, weights, targets), (coefs, inter) = solves[0]
    base = float(malignant(Table({"features": x.mean(
        axis=0, keepdims=True)}))["scores"][0])
    base_gap = float(np.abs(targets[:, 1, 0] - base).max())
    err, ratio = shap_additivity(states, targets, coefs, inter,
                                 [x.shape[1]] * EXPLAIN_ROWS)
    phi = np.stack([np.asarray(v)[0] for v in out["explanation"]])
    log(f"[phase 18] (b) TabularSHAP over GBDTClassifier (60 iterations, 15 "
        f"leaves) on the breast-cancer set's shape ({BREAST_ROWS} x "
        f"{BREAST_COLS}): {EXPLAIN_ROWS} rows x {TAB_SHAP_SAMPLES} samples "
        f"in {wall:.3f} s; f(∅) against f(background mean) {base_gap:.3e}; "
        f"additivity |Σφ − (f(x) − f(mean))| at most {err:.3e} "
        f"({ratio:.3e} of the anchor bound; example 14's ceiling 0.25); "
        f"mean |φ| {np.abs(phi).mean():.4f} on {card}")
    if not (ratio <= 1.0 and base_gap <= 1e-6 and err < 0.25
            and np.isfinite(phi).all()):
        fail(f"TabularSHAP over the GBDT: additivity {err} ({ratio} of its "
             f"limit), f(∅) off f(mean) by {base_gap}")

    numeric = ["age", "fnlwgt", "education-num", "capital-gain",
               "capital-loss", "hours-per-week"]
    lime = TabularLIME(model=adult_model, input_cols=numeric,
                       target_classes=[1], num_samples=TAB_LIME_SAMPLES,
                       seed=16)
    with timing(lime, "_solve") as solves:
        t0 = time.perf_counter()
        out = lime.transform(adult_test.slice(0, EXPLAIN_ROWS))
        wall = time.perf_counter() - t0
    solve_s, (states, weights, targets), (coefs, inter) = solves[0]
    coef_gap, fit_gap, solve_ms = solve_gap(states, weights, targets, coefs,
                                            inter)
    r2 = np.asarray(out["explanation_r2"], np.float64)
    log(f"[phase 18] (b) TabularLIME over the Adult TrainClassifier model "
        f"(its {len(numeric)} numeric columns): {EXPLAIN_ROWS} rows x "
        f"{TAB_LIME_SAMPLES} samples in {wall:.3f} s; the card's f32 WLS "
        f"against the f64 host solve: coefficients {coef_gap:.3e} of the "
        f"largest (in units of each column's spread), fitted values "
        f"{fit_gap:.3e} of the targets' range (limit {SOLVE_RTOL}); the "
        f"solve {solve_ms:.4f} ms (CUDA events; {solve_s * 1e3:.2f} ms "
        f"wall); surrogate R² median {np.median(r2):.4f} on {card}")
    if max(coef_gap, fit_gap) > SOLVE_RTOL:
        fail(f"TabularLIME over Adult: the card's solve off the host's by "
             f"{coef_gap} / {fit_gap}")
    log(f"[phase 18] (b) {time.perf_counter() - t_part:.1f} s")


def text_explainer_path(review_model, card) -> None:
    """Phase 18 (c): TextLIME and TextSHAP over phase 16 (c)'s
    TextFeaturizer(4096) -> LogisticRegression, on held-out reviews."""
    import numpy as np
    from mmlspark_tpu_torch import PipelineModel, Table
    from mmlspark_tpu_torch.explainers import TextLIME, TextSHAP

    t_part = time.perf_counter()
    tf, clf, texts = review_model
    model = PipelineModel([tf, clf])
    rows = Table({"text": texts[:TEXT_ROWS]})
    for cls in (TextLIME, TextSHAP):
        exp = cls(model=model, num_samples=TEXT_SAMPLES, seed=23,
                  target_classes=[1])
        with timing(exp, "_solve") as solves:
            t0 = time.perf_counter()
            out = exp.transform(rows)
            wall = time.perf_counter() - t0
        solve_s, (states, weights, targets), (coefs, inter) = solves[0]
        # the explanation's top token of each review: a sentiment word
        lex = set(REVIEW_POS) | set(REVIEW_NEG)
        hits = np.mean([toks[int(np.argmax(np.abs(np.asarray(e)[0][
            :len(toks)])))] in lex for toks, e in zip(out["tokens"],
                                                       out["explanation"])])
        if cls is TextLIME:
            coef_gap, fit_gap, solve_ms = solve_gap(states, weights, targets,
                                                    coefs, inter)
            check = (f"the card's f32 WLS against the f64 host solve: "
                     f"coefficients {coef_gap:.3e}, fitted values "
                     f"{fit_gap:.3e} (limit {SOLVE_RTOL}); the solve "
                     f"{solve_ms:.4f} ms (CUDA events)")
            bad = max(coef_gap, fit_gap) > SOLVE_RTOL
        else:
            err, ratio = shap_additivity(states, targets, coefs, inter,
                                         exp._true_dims)
            check = (f"additivity at most {err:.3e} ({ratio:.3e} of the "
                     f"anchor bound)")
            bad = not ratio <= 1.0
        log(f"[phase 18] (c) {cls.__name__} over TextFeaturizer("
            f"{REVIEW_FEATURES}) -> LogisticRegression: {TEXT_ROWS} reviews x "
            f"{TEXT_SAMPLES} samples in {wall:.3f} s; the top token a "
            f"sentiment word in {hits:.3f} of the reviews; {check} on {card}")
        if bad or hits < 0.9:
            fail(f"{cls.__name__} over the review model: {check}; top "
                 f"tokens {hits}")
    log(f"[phase 18] (c) {time.perf_counter() - t_part:.1f} s")


def access_log(seed: int) -> dict:
    """One tenant's access log, made from a seed with array operations:
    AA_USERS users and AA_RES resources, each in one of example 12's
    AA_DEPTS departments; AA_PAIRS distinct (user, resource) pairs, 95% of
    them within the user's department, each with a likelihood (an access
    count, 1..99)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    user_dept = rng.integers(0, AA_DEPTS, AA_USERS)
    res_dept = rng.integers(0, AA_DEPTS, AA_RES)
    n = int(AA_PAIRS * 1.1)
    u = rng.integers(0, AA_USERS, n)
    dept = np.where(rng.random(n) < 0.95, user_dept[u],
                    rng.integers(0, AA_DEPTS, n))
    r = np.empty(n, np.int64)
    for d in range(AA_DEPTS):
        pool = np.flatnonzero(res_dept == d)
        m = dept == d
        r[m] = pool[rng.integers(0, len(pool), int(m.sum()))]
    _, first = np.unique(u * AA_RES + r, return_index=True)
    if len(first) < AA_PAIRS:
        fail(f"access log: {len(first)} distinct pairs < {AA_PAIRS}")
    pick = np.sort(rng.choice(first, AA_PAIRS, replace=False))
    return {"user": u[pick].astype(np.int64), "res": r[pick],
            "likelihood": rng.integers(1, 100, AA_PAIRS).astype(np.float64),
            "user_dept": user_dept, "res_dept": res_dept}


def access_anomaly_path(card) -> None:
    """Phase 18 (d): AccessAnomaly at its defaults on AA_TENANTS tenants;
    cross-department probes against in-department accesses; a tenant's card
    fit against its CPU fit; two card fits."""
    import numpy as np
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.cyber import (AccessAnomaly,
                                          ComplementAccessTransformer)
    from mmlspark_tpu_torch.cyber import access_anomaly as AA

    t_part = time.perf_counter()
    t0 = time.perf_counter()
    logs = [access_log(seed=180 + t) for t in range(AA_TENANTS)]
    table = Table({
        "tenant": np.repeat(np.arange(AA_TENANTS), AA_PAIRS),
        **{k: np.concatenate([lg[k] for lg in logs])
           for k in ("user", "res", "likelihood")}})
    data_s = time.perf_counter() - t0
    est = AccessAnomaly(tenant_col="tenant", likelihood_col="likelihood")
    with timing(AA, "_als_step_sparse") as halves:
        t0 = time.perf_counter()
        model = est.fit(table)
        fit_s = time.perf_counter() - t0
    sweep_ms = [1e3 * (halves[i][0] + halves[i + 1][0])
                for i in range(0, len(halves), 2)]
    t0 = time.perf_counter()
    scores = np.asarray(model.transform(table)["anomaly_score"])
    score_s = time.perf_counter() - t0
    again = np.asarray(est.fit(table).transform(table)["anomaly_score"])
    repeat_gap = float(np.abs(again - scores).max())
    same = bool(np.array_equal(again, scores))

    # tenant 0: its most accessed in-department pairs against the same
    # users reaching into another department's resources
    lg = logs[0]
    inside = lg["user_dept"][lg["user"]] == lg["res_dept"][lg["res"]]
    normal = np.flatnonzero(inside)[np.argsort(
        -lg["likelihood"][inside], kind="stable")[:1000]]
    rng = np.random.default_rng(181)
    users = lg["user"][normal]
    other = (lg["user_dept"][users] + rng.integers(1, AA_DEPTS, len(users))
             ) % AA_DEPTS
    probe_res = np.array([rng.choice(np.flatnonzero(lg["res_dept"] == d))
                          for d in other])
    seen = set((lg["user"] * AA_RES + lg["res"]).tolist())
    fresh = np.array([u * AA_RES + r not in seen
                      for u, r in zip(users, probe_res)])

    def score(u, r):
        return np.asarray(model.transform(Table({
            "tenant": np.zeros(len(u), np.int64), "user": u, "res": r}))[
                "anomaly_score"])

    s_norm = score(users, lg["res"][normal])
    s_probe = score(users[fresh], probe_res[fresh])

    # tenant 0 on the CPU from the same initial factors
    one = Table({"tenant": np.zeros(AA_PAIRS, np.int64),
                 **{k: lg[k] for k in ("user", "res", "likelihood")}})
    t0 = time.perf_counter()
    cpu = AccessAnomaly(tenant_col="tenant", likelihood_col="likelihood",
                        device="cpu").fit(one)
    cpu_s = time.perf_counter() - t0
    cpu_gap = float(np.abs(np.asarray(cpu.transform(one)["anomaly_score"])
                           - scores[:AA_PAIRS]).max())
    t0 = time.perf_counter()
    comp = ComplementAccessTransformer(tenant_col="tenant", seed=0
                                       ).transform(one)
    comp_s = time.perf_counter() - t0
    overlap = len(set((np.asarray(comp["user"]) * AA_RES
                       + np.asarray(comp["res"])).tolist()) & seen)
    log(f"[phase 18] (d) AccessAnomaly at its defaults (rank 8, 10 sweeps, "
        f"reg 0.1, complement ratio 1.0) on {AA_TENANTS} tenants x "
        f"{AA_USERS:,} users x {AA_RES:,} resources x {AA_PAIRS:,} accesses "
        f"({np.mean(inside):.4f} in-department; made in {data_s:.2f} s): fit "
        f"{fit_s:.3f} s, a sweep {np.median(sweep_ms):.3f} ms median "
        f"({min(sweep_ms):.3f}..{max(sweep_ms):.3f}, {len(sweep_ms)} sweeps, "
        f"the card synchronized); scoring {len(scores):,} rows "
        f"{score_s:.3f} s; in-department pairs {s_norm.mean():+.4f} against "
        f"{len(s_probe)} cross-department probes {s_probe.mean():+.4f}; "
        f"tenant 0's card fit against its CPU fit ({cpu_s:.2f} s) "
        f"{cpu_gap:.3e} (limit {AA_CPU_ATOL}); two card fits bit for bit: "
        f"{same} (max |diff| {repeat_gap:.3e}, limit {AA_REPEAT_RTOL} of "
        f"max |score|); ComplementAccessTransformer on tenant 0 {comp_s:.3f} "
        f"s for {len(comp):,} pairs ({overlap} seen) on {card}")
    if not (s_probe.mean() > s_norm.mean() + 0.5 and len(s_probe) > 900):
        fail(f"AccessAnomaly: probes {s_probe.mean()} against in-department "
             f"{s_norm.mean()}")
    if cpu_gap > AA_CPU_ATOL or \
            repeat_gap > AA_REPEAT_RTOL * float(np.abs(scores).max()):
        fail(f"AccessAnomaly: card vs CPU {cpu_gap}, two card fits "
             f"{repeat_gap}")
    if overlap or len(comp) != AA_PAIRS or not np.isfinite(scores).all():
        fail(f"ComplementAccessTransformer: {len(comp)} pairs, {overlap} "
             f"seen; scores finite {np.isfinite(scores).all()}")
    log(f"[phase 18] (d) {time.perf_counter() - t_part:.1f} s")


def service_layer_path() -> None:
    """Phase 18 (e): example 11's cognitive pipeline against a mock of the
    wire protocol on 127.0.0.1, the PowerBI writer against a local server,
    and the binding generator over the registry, its smoke tests run by
    pytest in a subprocess that cannot import JAX or the JAX package."""
    import tempfile
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np
    from mmlspark_tpu_torch import LambdaTransformer, PipelineModel, Table
    from mmlspark_tpu_torch.codegen import generate_tests, generate_wrappers
    from mmlspark_tpu_torch.cognitive import OCR, TextSentiment
    from mmlspark_tpu_torch.core.registry import all_stages
    from mmlspark_tpu_torch.io.http.transformers import SimpleHTTPTransformer
    from mmlspark_tpu_torch.io.powerbi import write_to_power_bi

    t_part = time.perf_counter()
    docs = {b"IMG-0": "the service was excellent and fast",
            b"IMG-1": "terrible delays ruined the whole trip",
            b"IMG-2": "an average experience nothing special"}
    negative = {"terrible", "ruined", "delays"}
    pushed = []

    class Mock(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.path.startswith("/vision/v2.0/ocr"):
                words = docs.get(bytes(body), "").split()
                out = {"language": "en", "regions": [{"lines": [
                    {"words": [{"text": w} for w in words]}]}]}
            elif "/sentiment" in self.path:
                out = {"documents": [
                    {"id": d["id"], "sentiment": (
                        "negative" if negative & set(d["text"].split())
                        else "positive")}
                    for d in json.loads(body)["documents"]]}
            elif self.path.startswith("/powerbi"):
                pushed.append(json.loads(body))
                out = {}
            else:
                payload = json.loads(body)
                out = {"upper": payload["text"].upper(),
                       "words": len(payload["text"].split())}
            blob = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def log_message(self, *a):
            pass

    def ocr_text(t):
        return t.with_column("text", np.asarray([
            None if r is None else " ".join(
                w["text"] for region in r.get("regions", [])
                for line in region.get("lines", [])
                for w in line.get("words", []))
            for r in t["ocr"]], dtype=object))

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Mock)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        imgs = np.empty(len(docs), dtype=object)
        for i, blob in enumerate(docs):
            imgs[i] = blob
        t0 = time.perf_counter()
        out = PipelineModel([
            OCR(url=f"{base}/vision/v2.0/ocr", subscription_key="demo-key",
                image_bytes_col="image", output_col="ocr"),
            LambdaTransformer(ocr_text),
            TextSentiment(url=f"{base}/text/analytics/v3.0/sentiment",
                          subscription_key="demo-key", text_col="text",
                          output_col="sentiment"),
            SimpleHTTPTransformer(url=f"{base}/custom/enrich",
                                  input_cols=["text"], output_col="enriched"),
        ]).transform(Table({"image": imgs}))
        pipe_s = time.perf_counter() - t0
        sentiments = [r["sentiment"] for r in out["sentiment"]]
        upper = all(out["enriched"][i]["upper"] == out["text"][i].upper()
                    for i in range(len(out)))
        rows = Table({"x": np.arange(1000), "name": np.asarray(
            [f"r{i}" for i in range(1000)], object),
            "v": np.where(np.arange(1000) % 7 == 0, np.nan, 0.5)})
        t0 = time.perf_counter()
        written = write_to_power_bi(rows, f"{base}/powerbi", batch_size=100)
        pbi_s = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
    flat = [r for batch in pushed for r in batch]
    pbi_ok = (written == 1000 and len(pushed) == 10
              and [r["x"] for r in flat] == list(range(1000))
              and all((r["v"] is None) == (r["x"] % 7 == 0) for r in flat))
    log(f"[phase 18] (e) example 11 (OCR -> Lambda -> TextSentiment -> "
        f"SimpleHTTPTransformer) against the mock: {sentiments}, enriched "
        f"{upper}, {pipe_s:.3f} s; write_to_power_bi 1,000 rows in "
        f"{len(pushed)} batches {pbi_s:.3f} s, rows and nulls as sent: "
        f"{pbi_ok}")
    if sentiments != ["positive", "negative", "positive"] or not upper or \
            not pbi_ok:
        fail("the cognitive pipeline or the PowerBI writer")

    stages = all_stages()
    blocker = (
        "import importlib.abc, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'mmlspark_tpu')\n"
        "def _blocked(n):\n"
        "    return any(n == b or n.startswith(b + '.') for b in BLOCKED)\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if _blocked(name):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        t0 = time.perf_counter()
        generate_wrappers(d)
        test_file = generate_tests(d)
        gen_s = time.perf_counter() - t0
        script = blocker + (
            "import pytest\n"
            f"rc = pytest.main([{test_file!r}, '-q', '-p', "
            "'no:cacheprovider'])\n"
            "assert not [m for m in sys.modules if _blocked(m)]\n"
            "sys.exit(rc)\n")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", script], cwd=d, capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join([d, ROOT])))
        run_s = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log(f"[phase 18] (e) the binding generator over {len(stages)} stages: "
        f"wrappers and tests written in {gen_s:.3f} s; their smoke tests "
        f"(JAX and the JAX package blocked) in {run_s:.2f} s: {tail[0]}")
    if len(stages) != 161 or proc.returncode != 0 or \
            f"{len(stages)} passed" not in proc.stdout:
        fail(f"the generated smoke tests: rc {proc.returncode}\n"
             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    log(f"[phase 18] (e) {time.perf_counter() - t_part:.1f} s")


# ---------------------------------------------------------------------------
# phase 19: device telemetry and the model side of distributed
# ---------------------------------------------------------------------------

def _p19_dir(name: str) -> str:
    path = os.path.join(ROOT, "build", "phase19", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _http_get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode("utf-8")


def telemetry_path(images, table, repo, n_chunks, card) -> dict:
    """Phase 19 (a); returns {kernel: launches} of the featurizer runs."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.core import telemetry as T
    from mmlspark_tpu_torch.core.pipeline import LambdaTransformer
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet
    from mmlspark_tpu_torch.serving.server import ServingServer

    _clear_executor_caches()
    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH,
                                 device=P19_DEVICE)
    few = Table({"image": [images[i] for i in
                           range(0, P19_FEW * len(SIZES), len(SIZES))]})
    sentry = T.track_compiles()
    sentry.reset()
    T.reset_counters("xla.")
    zero_launches()
    featurizer.transform(table)  # warmup: its chunk shapes are new
    warm = T.counters("xla.compile")
    sentry.end_warmup()
    with T.span("phase19.featurize"):  # a trace for the Chrome export
        featurizer.transform(table)  # the same shapes: nothing to flag
    steady = T.counters("xla.compile.hot_path")
    featurizer.transform(few)    # a chunk shape the warmup never saw
    hot = T.counters("xla.compile.hot_path")
    launches = read_launches()
    sentry.reset()
    log(f"[phase 19] (a) compile sentry over phase 4's featurizer: warmup "
        f"{warm}, steady-state rerun {steady or 'no flag'}, a {P19_FEW}-image "
        f"chunk {hot}; launches {launches}")
    if steady:
        fail(f"the compile sentry flagged a rerun of warmed shapes: {steady}")
    if hot != {"xla.compile.hot_path": 1,
               "xla.compile.hot_path.tpu_model.forward": 1}:
        fail(f"a new chunk shape in steady state must be flagged exactly "
             f"once at tpu_model.forward, got {hot}")
    if launches != dict(NO_LAUNCHES, affine_resample=2 * n_chunks + 1):
        fail(f"phase 19 (a) launched {launches}, expected B1 once a chunk "
             f"({2 * n_chunks + 1})")

    # the gauges against the allocator's statistics at the same instant
    torch.cuda.synchronize()
    got = T.sample_device_memory()
    stats = torch.cuda.memory_stats(0)
    want = {"hbm_bytes_in_use": stats["allocated_bytes.all.current"],
            "hbm_peak_bytes": stats["allocated_bytes.all.peak"],
            "live_buffer_count": stats["allocation.all.current"]}
    log(f"[phase 19] (a) sample_device_memory {got}; memory_stats {want}")
    if got != want:
        fail(f"device memory gauges {got} != torch.cuda.memory_stats {want}")

    # the Chrome trace export parses, and a server's /metrics carries the
    # memory gauges (each scrape samples them)
    doc = json.loads(json.dumps(T.render_chrome_trace()))
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    path = os.path.join(_p19_dir("trace"), "trace.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    srv = ServingServer(LambdaTransformer(lambda t: t.with_column(
        "y", np.asarray(t["v"], np.float32) * 2.0)), reply_col="y",
        name="phase19-metrics", path="/score", input_schema=["v"])
    info = srv.start()
    try:
        body = _http_get(info.url.rsplit("/", 1)[0] + "/metrics")
    finally:
        srv.stop()
    gauges = {n: line for line in body.splitlines()
              for n in ("device_hbm_bytes_in_use", "device_hbm_peak_bytes",
                        "device_live_buffer_count")
              if line.startswith(n + " ")}
    log(f"[phase 19] (a) Chrome trace: {len(events)} span events, "
        f"{os.path.getsize(path)} bytes, parses; /metrics: "
        f"{sorted(gauges.values())}")
    if not events or len(gauges) != 3:
        fail(f"the Chrome trace ({len(events)} events) or /metrics' memory "
             f"gauges ({gauges}) are missing")
    return launches


def ring_blocks_path(card) -> dict:
    """Phase 19 (b); returns {kernel: launches} of the counted runs."""
    import torch
    from mmlspark_tpu_torch.ops import attention_kernels as A
    from mmlspark_tpu_torch.parallel import ring_attention as RA
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    b, s, h, d = RING_SHAPE
    n, blk = RING_BLOCKS, RING_SHAPE[1] // RING_BLOCKS
    gen = torch.Generator(device=P19_DEVICE).manual_seed(19)
    q, k, v = (torch.randn(RING_SHAPE, device=P19_DEVICE,
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    total = dict(NO_LAUNCHES)
    for causal in (True, False):
        ref = RA.full_attention(q, k, v, causal)
        zero_launches()
        outs = []
        for r in range(n):
            # rank r holds query block r and receives K/V blocks r, r-1, ...
            qr = q[:, r * blk:(r + 1) * blk]
            o, m, l = RA._init_carry(qr)
            for i in range(n):
                src = (r - i) % n
                kv = slice(src * blk, (src + 1) * blk)
                o, m, l = RA.ring_block_step(qr, k[:, kv], v[:, kv], o, m, l,
                                             r * blk, src * blk, causal)
            outs.append(RA._finish(o, l))
        got = torch.cat(outs, dim=1)
        counted = read_launches()
        err = float((got - ref).abs().max())
        close = bool(torch.allclose(got, ref, atol=RING_ATOL, rtol=RING_ATOL))
        want = n * (n + 1) // 2 if causal else n * n
        log(f"[phase 19] (b) ring blocks bf16{list(RING_SHAPE)} in {n} blocks "
            f"of {blk}, causal={causal}: B4 {counted['flash_attention_fwd']} "
            f"launches (want {want}); max_abs_err vs full_attention {err:.3e} "
            f"(atol = rtol = {RING_ATOL}: {close})")
        if counted != dict(NO_LAUNCHES, flash_attention_fwd=want):
            fail(f"the ring's blocks launched {counted}, expected B4 {want}")
        if not close:
            fail(f"the ring's blocks disagree with full_attention ({err:.3e})")
        total = {key: total[key] + counted[key] for key in KERNELS}
        del ref, got, outs
    # one block behind the queries: the per-block step against B4 alone
    qr, kb, vb = q[:, blk:2 * blk], k[:, :blk], v[:, :blk]
    o, m, l = RA._init_carry(qr)
    step_ms = queued_ms(lambda: RA.ring_block_step(qr, kb, vb, o, m, l, blk,
                                                   0, True))
    b4_ms = queued_ms(lambda: A.flash_attention_fwd(qr, kb, vb, False))
    bound_ms, bound_by = attention_bound((b, blk, h, d), "bfloat16", False)
    log(f"[phase 19] (b) per-block step (B4 + the logsumexp merge) at "
        f"bf16{[b, blk, h, d]}: {step_ms:.4f} ms; B4 alone {b4_ms:.4f} ms "
        f"(queued behind a spin); B4's bound {bound_ms:.4f} ms ({bound_by}) "
        f"on {card}")
    # ring_attention itself through the world-1 group: one diagonal block
    mesh = make_mesh(device=P19_DEVICE)
    ref = RA.full_attention(q, k, v, True)
    zero_launches()
    out = RA.ring_attention(q, k, v, mesh, causal=True)
    counted = read_launches()
    err = float((out - ref).abs().max())
    log(f"[phase 19] (b) ring_attention over the world-1 mesh: launches "
        f"{counted}; max_abs_err vs full_attention {err:.3e}")
    if counted != dict(NO_LAUNCHES, flash_attention_fwd=1) or \
            not torch.allclose(out, ref, atol=RING_ATOL, rtol=RING_ATOL):
        fail("ring_attention at world 1 must be one causal B4 launch equal "
             "to full_attention")
    del q, k, v, ref, out
    torch.cuda.empty_cache()
    return {key: total[key] + counted[key] for key in KERNELS}


def ulysses_path(card) -> dict:
    """Phase 19 (c); returns {kernel: launches} of the counted run."""
    import torch
    from mmlspark_tpu_torch.parallel import ring_attention as RA
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=P19_DEVICE)
    gen = torch.Generator(device=P19_DEVICE).manual_seed(20)
    q, k, v, g = (torch.randn(ULY_SHAPE, device=P19_DEVICE,
                              generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    zero_launches()
    out = RA.ulysses_attention(q, k, v, mesh, causal=True)
    (out * g.float()).sum().backward()
    counted = read_launches()
    got = [x.grad.float() for x in (q, k, v)]
    q2, k2, v2 = (x.detach().clone().requires_grad_() for x in (q, k, v))
    ref = RA.full_attention(q2, k2, v2, True)
    (ref * g.float()).sum().backward()
    want = [x.grad.float() for x in (q2, k2, v2)]
    fwd_err = float((out - ref).abs().max())
    rels = [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]
    log(f"[phase 19] (c) ulysses_attention bf16{list(ULY_SHAPE)} causal over "
        f"the world-1 mesh: launches {counted}; forward max_abs_err vs "
        f"full_attention {fwd_err:.3e} (limit {ATTN_ATOL['bfloat16']}), "
        f"dq/dk/dv rel_l2 {rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e} (limit "
        f"{AUTOGRAD_TOL['bfloat16']})")
    if counted != dict(NO_LAUNCHES, flash_attention_fwd=1,
                       flash_attention_bwd_dkdv=1, flash_attention_bwd_dq=1):
        fail(f"Ulysses launched {counted}: B4, B5 and B6 once each")
    if fwd_err > ATTN_ATOL["bfloat16"] or max(rels) > AUTOGRAD_TOL["bfloat16"]:
        fail("Ulysses disagrees with full_attention")
    del q, k, v, g, out, ref, got, want
    torch.cuda.empty_cache()
    return counted


def _flat_tree(tree) -> dict:
    from mmlspark_tpu_torch.parallel.sharding_rules import \
        tree_leaves_with_path

    return {"/".join(p): v.float().cpu() for p, v in
            tree_leaves_with_path(tree)}


def trainer3d_path(card):
    """Phase 19 (d); returns ({kernel: launches}, state, step, tokens)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import telemetry as T
    from mmlspark_tpu_torch.models import training as TR
    from mmlspark_tpu_torch.models.bundle import get_builder
    from mmlspark_tpu_torch.parallel.mesh import MeshPlan
    from mmlspark_tpu_torch.parallel.sharding_rules import lm_3d_rules
    from torch.profiler import ProfilerActivity, profile

    cfg = dict(LM, max_len=P3D_SEQ)
    layers = cfg["num_layers"]
    ref = TR.init_train_state(get_builder("transformer_lm")(**cfg),
                              TR.sgd(P3D_LR), seed=0,
                              compute_dtype="bfloat16", device=P19_DEVICE)
    plan = MeshPlan(1, 1, 1, device=P19_DEVICE)
    tree0 = TR.lm_params_tree(ref.module)
    p3 = TR.shard_params(TR.lm_params_to_3d(tree0, layers, plan.pipe), plan,
                         lm_3d_rules())
    state = TR.init_lm_state_3d(p3, TR.sgd(P3D_LR), plan, "bfloat16")
    del p3
    step = TR.make_lm_train_step_3d(ref.module, plan, remat=True)
    rows = P3D_A * P3D_M * P3D_MB
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg["vocab_size"], (rows, P3D_SEQ)).astype(np.int64)).to(
            P19_DEVICE)
    toks3d = toks.reshape(P3D_A, P3D_M, P3D_MB, P3D_SEQ)

    # the counted run: two steps of the 3D step
    torch.cuda.synchronize()
    zero_launches()
    losses3d = []
    for _ in range(2):
        state, m = step(state, toks3d)
        losses3d.append(float(m["loss"]))
    launches = read_launches()
    blocks = layers * P3D_A * P3D_M * 2  # block applications in 2 steps
    want = dict(NO_LAUNCHES, flash_attention_fwd=2 * blocks,
                flash_attention_bwd_dkdv=blocks, flash_attention_bwd_dq=blocks)
    log(f"[phase 19] (d) 3D step on {plan} (GPT-small {cfg}, bf16, SGD "
        f"{P3D_LR}, tokens [A={P3D_A}, M={P3D_M}, mb={P3D_MB}, S={P3D_SEQ}], "
        f"remat): 2 steps, launches {launches} (B4 twice a block with remat)")
    if launches != want:
        fail(f"the 3D step launched {launches}, expected {want}")

    # the port's single-device LM step on the same weights and tokens
    epoch = TR.make_lm_train_epoch()
    ref_losses = []
    for _ in range(2):
        ref, loss = epoch(ref, toks[None])
        ref_losses.append(float(loss[0]))
    got, want_p = (_flat_tree(TR.lm_params_from_3d(TR.gather_params(state),
                                                   layers)),
                   _flat_tree(TR.lm_params_tree(ref.module)))
    base = _flat_tree(tree0)
    upd = torch.cat([(got[n] - base[n]).reshape(-1) for n in base])
    upd_ref = torch.cat([(want_p[n] - base[n]).reshape(-1) for n in base])
    upd_rel = float((upd - upd_ref).norm() / upd_ref.norm())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses3d, ref_losses))
    log(f"[phase 19] (d) losses 3D {losses3d} vs single-device "
        f"{ref_losses}: worst rel {loss_rel:.3e} (limit {P3D_LOSS_RTOL}); "
        f"parameters after step 2: rel_l2 of the updates {upd_rel:.3e} "
        f"(limit {P3D_UPDATE_RTOL})")
    if loss_rel > P3D_LOSS_RTOL or upd_rel > P3D_UPDATE_RTOL:
        fail("the 3D step disagrees with the single-device LM step")
    del ref, epoch, got, want_p, base, upd, upd_ref, tree0
    torch.cuda.empty_cache()

    # timed steps under a memory sampler
    step_s = []
    with T.MemorySampler(0.005) as sampler:
        for _ in range(P3D_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, toks3d)
            float(m["loss"])
            step_s.append(time.perf_counter() - t0)
    med = float(np.median(step_s))
    gauges = T.export_snapshot(include_spans=False)["gauges"]
    lo, hi = min(step_s) * 1e3, max(step_s) * 1e3
    log(f"[phase 19] (d) 3D step {lo:.3f}..{hi:.3f} ms over "
        f"{P3D_STEPS} steps, median {med * 1e3:.3f} ms = "
        f"{rows * P3D_SEQ / med:.0f} tokens/s (CUDA-synchronised host clock) "
        f"on {card}; MemorySampler: {sampler.samples} samples, "
        f"device.hbm.peak_bytes {gauges.get('device.hbm.peak_bytes')}")
    if sampler.samples < 1 or not gauges.get("device.hbm.peak_bytes"):
        fail("the MemorySampler took no sample over the LM step")

    # the memory remat saves: one step each way from a reset peak
    # (and each way's wall and device time: where the step's time goes)
    peaks, walls, busy = {}, {}, {}
    for remat in (True, False):
        fn = step if remat else TR.make_lm_train_step_3d(
            get_builder("transformer_lm")(**cfg), plan, remat=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = fn(state, toks3d)
        torch.cuda.synchronize()
        walls[remat] = (time.perf_counter() - t0) * 1e3
        peaks[remat] = torch.cuda.max_memory_allocated()
        busy[remat] = profiled_kernel_ms(
            lambda fn=fn: fn(state, toks3d),
            ["flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"])
    log(f"[phase 19] (d) torch.cuda.max_memory_allocated of one step: remat "
        f"{peaks[True] / 2**30:.3f} GiB, no remat {peaks[False] / 2**30:.3f} "
        f"GiB (saves {(peaks[False] - peaks[True]) / 2**30:.3f} GiB)")
    for remat in (True, False):
        if busy[remat] is None:
            log(f"[phase 19] (d) remat={remat}: step {walls[remat]:.3f} ms; "
                f"the profiler saw no device time (not measured)")
            continue
        total_ms, by_name, wall_ms = busy[remat]
        log(f"[phase 19] (d) remat={remat}: step {walls[remat]:.3f} ms; "
            f"profiled step: device kernels {total_ms:.3f} ms of its "
            f"{wall_ms:.3f} ms wall (busy share {total_ms / wall_ms:.3f}), "
            + " ".join(f"{n} {ms:.3f} ms" for n, ms in by_name.items()))
    if peaks[True] >= peaks[False]:
        fail(f"remat saved no memory: {peaks}")

    # span names on a torch.profiler capture of one step
    T.enable_device_annotations()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with T.span("training.step"):
                state, m = step(state, toks3d)
                float(m["loss"])
        names = {e.key for e in prof.key_averages()}
    finally:
        T.enable_device_annotations(False)
    log(f"[phase 19] (d) profiler capture of one step with the annotation "
        f"hook: 'training.step' event {'training.step' in names}")
    if "training.step" not in names:
        fail("the annotation hook's span name is not in the profiler run")
    return launches, state, step, toks3d


def checkpoint3d_path(state, step, toks3d, card) -> None:
    """Phase 19 (e): format-2 checkpoints of the 3D state."""
    import torch
    from mmlspark_tpu_torch.models.checkpoint import (
        MANIFEST_NAME, CheckpointCorruptError, CheckpointManager)

    root = _p19_dir("ckpt")
    mgr = CheckpointManager(root)
    t0 = time.perf_counter()
    mgr.save(state, step=1)
    save_s = time.perf_counter() - t0
    saved = [p.detach().clone() for p in state.module.parameters()]
    with open(os.path.join(root, "1", MANIFEST_NAME)) as f:
        doc = json.load(f)
    entry = doc["leaves"]["module/blocks.qkv.kernel"]
    t0 = time.perf_counter()
    mgr.restore(step=1, template=state)
    verify_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in
               zip(saved, state.module.parameters()))
    state, _m = step(state, toks3d)
    mgr.save(state, step=2)
    victim = os.path.join(root, "2", entry["file"])
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    try:
        mgr.restore(step=2, template=state)
        rejection = None
    except CheckpointCorruptError as e:
        rejection = str(e)
    restored, at = mgr.restore_verified(template=state, quarantine=True)
    back = all(torch.equal(a, b) for a, b in
               zip(saved, restored.module.parameters()))
    size = sum(os.path.getsize(os.path.join(root, "1", n))
               for n in os.listdir(os.path.join(root, "1")))
    log(f"[phase 19] (e) format {doc['format']} checkpoint of the 3D state "
        f"({size / 2**20:.1f} MiB): save {save_s:.3f} s, verified restore "
        f"{verify_s:.3f} s (bit-exact {same}); qkv spec {entry.get('spec')} "
        f"with {len(entry.get('shards', []))} shard(s); a flipped byte in "
        f"step 2: {rejection!r}; quarantined {mgr.all_steps()} left, resumed "
        f"step {at} bit-exact {back}")
    if doc["format"] != 2 or not entry.get("shards") or not same:
        fail("the 3D state's checkpoint is not a verified format-2 save")
    if rejection is None or "shard=0" not in rejection or \
            "module/blocks.qkv.kernel" not in rejection:
        fail(f"the flipped byte's rejection must name its shard: "
             f"{rejection!r}")
    if at != 1 or not back or not os.path.isdir(
            os.path.join(root, "quarantined", "2")):
        fail("restore_verified did not quarantine step 2 and resume step 1")


def elastic_path(rendezvous_s: float, card) -> None:
    """Phase 19 (f): the elastic runtime at world 1."""
    import torch
    import torch.distributed as dist
    from mmlspark_tpu_torch.core.telemetry.fleet import merge_snapshots
    from mmlspark_tpu_torch.parallel import distributed as D

    store = D.MembershipStore(_p19_dir("members"))
    me = D.local_host_info("h0")
    t0 = time.perf_counter()
    view = store.rendezvous(me, expected=1, coordinator=True, timeout_s=30)
    file_s = time.perf_counter() - t0
    try:
        store.publish(D.MembershipView(1, [me]))
        stale = None
    except D.StaleMembershipError as e:
        stale = str(e)
    mon = D.HeartbeatMonitor(["h0", "h1"], lease_s=0.2, self_id="h0")
    mon.beat("h0")
    time.sleep(0.3)
    lost = mon.check_now() + mon.check_now()
    t0 = time.perf_counter()
    D.run_with_deadline(lambda: D.barrier("phase19", timeout_s=60), 120,
                        name="phase19")
    barrier_ms = (time.perf_counter() - t0) * 1e3
    x = torch.arange(4, dtype=torch.float32, device=P19_DEVICE)
    dist.all_reduce(x)
    srv = D.HostTelemetryServer("h0")
    host, port = srv.start()
    try:
        snap = json.loads(_http_get(f"http://{host}:{port}/metrics.json"))
        health = json.loads(_http_get(f"http://{host}:{port}/health"))
    finally:
        srv.stop()
    merged = merge_snapshots({"h0": snap, "h1": snap})
    attempts = snap["counters"].get("dist.rendezvous.attempt", 0)
    log(f"[phase 19] (f) rendezvous {rendezvous_s:.3f} s (nccl, a loopback "
        f"TCPStore, world 1) and {file_s * 1e3:.1f} ms on the file plane "
        f"(epoch {view.epoch}); stale publish: {stale!r}; lease expiry "
        f"declared {lost}; barrier under run_with_deadline {barrier_ms:.1f} "
        f"ms; all_reduce on {x.device}: {x.tolist()}; /metrics.json merged "
        f"over 2 hosts: dist.rendezvous.attempt {attempts} -> "
        f"{merged['counters'].get('dist.rendezvous.attempt')}, hbm gauge "
        f"{snap['gauges'].get('device.hbm.bytes_in_use')}; /health {health}")
    if view.epoch != 1 or stale is None or lost != ["h1"]:
        fail("the membership plane misbehaved at world 1")
    if x.tolist() != [0.0, 1.0, 2.0, 3.0]:
        fail(f"all_reduce at world 1 changed the tensor: {x.tolist()}")
    if merged["counters"].get("dist.rendezvous.attempt") != 2 * attempts \
            or "device.hbm.bytes_in_use" not in snap["gauges"] \
            or health.get("host_id") != "h0":
        fail("the host telemetry endpoint's snapshot did not merge")


# ---------------------------------------------------------------------------
# phase 20: the data side of distributed (A19) at world 1
# ---------------------------------------------------------------------------
# The process group of phase 20 is world 1 on nccl.  (a) phase 4's
# featurizer with the feed's coalescing at 4 and at 1 chunk a copy, in
# P20_TURNS turns of each; (b) the shard engine at phase 4's chunk shape
# and one staging bucket over P20_PUTS puts; (c) the meshed featurizer,
# P20_TURNS turns against the single-device path; (d) phase 15's fits on
# the world-1 mesh (voting over P20_TOP_K features); (e) phase 17 (d)'s VW
# rows with use_all_reduce.
P20_TURNS = 3
P20_PUTS = 20
P20_TOP_K = 20
P20_SHAPE = (BATCH, IMG, IMG, 3)
P20_AUC_DROP = 0.01   # voting may restrict splits; its AUC may trail this much


def _p20_dir(name: str) -> str:
    path = os.path.join(ROOT, "build", "phase20", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _feed_counters() -> dict:
    from mmlspark_tpu_torch.core import telemetry as T

    return {k: v for k, v in T.counters("feed.").items()
            if k in ("feed.degraded", "feed.shard_degraded") and v}


def _no_degrade(part: str) -> None:
    got = _feed_counters()
    if got:
        fail(f"phase 20 {part}: the feed degraded without an injected "
             f"fault: {got}")


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def feed_coalesce_path(table, repo, n_chunks, card) -> dict:
    """Phase 20 (a); returns {kernel: launches} of the counted run."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.io import feed as PF
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet

    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH)
    featurizer.transform(table)  # warm
    d = _p20_dir("tuned")
    files = {c: os.path.join(d, f"feed_coalesce_{c}.json") for c in (4, 1)}
    for c, path in files.items():
        with open(path, "w") as f:
            json.dump({"coalesce": c}, f)
    runs = {4: [], 1: []}
    feats = {}
    launches = None
    try:
        for turn in range(P20_TURNS):
            for c in (4, 1):
                os.environ["MMLSPARK_FEED_TUNED"] = files[c]
                if PF.load_tuned() != {"coalesce": c}:
                    fail(f"load_tuned read {PF.load_tuned()} from {files[c]}")
                counted = turn == 0 and c == 4
                if counted:
                    zero_launches()
                torch.cuda.synchronize()
                before = PF.FEED_TELEMETRY.snapshot()
                t0 = time.perf_counter()
                out = featurizer.transform(table)
                wall = time.perf_counter() - t0
                if counted:
                    launches = read_launches()
                runs[c].append((wall, PF.FEED_TELEMETRY.delta(before)))
                if c not in feats:
                    feats[c] = out["features"]
                elif not np.array_equal(out["features"], feats[c]):
                    fail(f"coalesce={c}: two runs' features differ")
    finally:
        os.environ.pop("MMLSPARK_FEED_TUNED", None)
    same = np.array_equal(feats[4], feats[1])
    diff = float(np.abs(feats[4] - feats[1]).max())
    for c in (4, 1):
        walls = [w for w, _ in runs[c]]
        med = _median(runs[c])
        s = PF.FeedTelemetry.summarize(med[1])
        log(f"[phase 20] (a) coalesce={c} (load_tuned from {files[c]}): "
            f"images/s over {P20_TURNS} turns {N_IMAGES / max(walls):.0f} / "
            f"{N_IMAGES / _median(walls):.0f} / {N_IMAGES / min(walls):.0f}"
            f" (min / median / max); the median run: groups "
            f"{med[1]['groups']:.0f} for {med[1]['chunks_fed']:.0f} chunks, "
            f"coalesced {med[1]['coalesced_chunks']:.0f}; summarize {s}")
        if c == 1 and (med[1]["groups"] != n_chunks
                       or med[1]["coalesced_chunks"]):
            fail(f"coalesce=1 packed chunks: {med[1]}")
        if med[1]["chunks_fed"] != n_chunks:
            fail(f"coalesce={c} fed {med[1]['chunks_fed']} of {n_chunks}")
    log(f"[phase 20] (a) features coalesce=4 vs coalesce=1: bit for bit "
        f"{same} (max abs diff {diff:.3g}); launches of the first run "
        f"{launches} on {card}")
    if not same:
        fail("phase 20 (a): coalescing changed the features")
    if launches != dict(NO_LAUNCHES, affine_resample=n_chunks):
        fail(f"phase 20 (a) launched {launches}, expected B1 once a chunk")
    _no_degrade("(a)")
    return launches


def shard_engine_path(mesh, card) -> None:
    """Phase 20 (b): ShardEngine.put_sharded under a world-1 batch
    sharding, one staging bucket over P20_PUTS puts, then the chaos
    soak's h2d leg on the card."""
    import importlib.util

    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import telemetry as T
    from mmlspark_tpu_torch.io import shard_put as SP
    from mmlspark_tpu_torch.io.feed import FeedTelemetry
    from mmlspark_tpu_torch.parallel.mesh import batch_sharding

    rng = np.random.default_rng(20)
    u8 = rng.integers(0, 256, P20_SHAPE, dtype=np.uint8)
    f32 = rng.standard_normal(P20_SHAPE, dtype=np.float32)
    sh = batch_sharding(mesh, len(P20_SHAPE))
    ptrs = []
    orig = SP.ShardEngine._copy

    def recording(self, view, host, device):
        t, ev = orig(self, view, host, device)
        ptrs.append(t.data_ptr())
        return t, ev

    SP.ShardEngine._copy = recording
    try:
        for arr in (u8, f32):
            tel = FeedTelemetry()
            eng = SP.ShardEngine(telemetry=tel, min_shard_bytes=0,
                                 staging=SP.StagingBuckets())
            y = eng.put_sharded(arr, sh)
            local = y.to_local()
            no_copy = local.data_ptr() == ptrs[-1]
            same = local.cpu().numpy().tobytes() == arr.tobytes()
            snap = tel.snapshot()
            log(f"[phase 20] (b) put_sharded {arr.dtype} {arr.shape} "
                f"({arr.nbytes / 2**20:.1f} MiB) on the world-1 mesh: a "
                f"{type(y).__name__} of shape {tuple(y.shape)}, from_local "
                f"kept the copied block (data_ptr equal): {no_copy}; read "
                f"back byte for byte: {same}; sharded_groups "
                f"{snap['sharded_groups']:.0f}")
            if not (no_copy and same and tuple(y.shape) == arr.shape
                    and snap["sharded_groups"] == 1):
                fail(f"phase 20 (b): put_sharded of {arr.dtype} failed")
    finally:
        SP.ShardEngine._copy = orig

    # one pinned bucket over P20_PUTS puts of two alternating arrays: each
    # put re-acquires the bucket behind the previous copy's fence; every
    # result is read back after the loop
    staging = SP.StagingBuckets()
    eng = SP.ShardEngine(telemetry=FeedTelemetry(), min_shard_bytes=0,
                         staging=staging)
    srcs = (f32, np.ascontiguousarray(f32[::-1]))
    eng.put_sharded(f32, sh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [eng.put_sharded(srcs[i % 2], sh) for i in range(P20_PUTS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok = all(o.to_local().cpu().numpy().tobytes() == srcs[i % 2].tobytes()
             for i, o in enumerate(outs))
    gbps = P20_PUTS * f32.nbytes / wall / 1e9
    log(f"[phase 20] (b) {P20_PUTS} puts of {f32.nbytes / 2**20:.1f} MiB "
        f"through one staging bucket ({staging.allocated()} allocated): "
        f"{wall * 1e3:.1f} ms, {gbps:.2f} GB/s (pageable copy into the "
        f"pinned bucket, then the DMA, fenced); every result equal to its "
        f"source: {ok} on {card}")
    # one bucket, reused (a CPU rehearsal discards its aliased buckets)
    if not ok or staging.allocated() != (0 if mesh.device_type == "cpu"
                                         else 1):
        fail("phase 20 (b): a fenced bucket was rewritten too early or "
             "reallocated")
    del outs

    spec = importlib.util.spec_from_file_location(
        "torch_chaos_soak", os.path.join(ROOT, "tools", "torch_chaos_soak.py"))
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    t0 = time.perf_counter()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        s = soak.run_flow_soak(seed=7, n_items=48, device="cuda")
    log(f"[phase 20] (b) torch_chaos_soak --flow on the card "
        f"({time.perf_counter() - t0:.2f} s): h2d delivered "
        f"{s['h2d_delivered']} in order, shard degraded "
        f"{s['h2d_shard_degraded']}, feed.shard_put fired "
        f"{s['faults_fired'].get('feed.shard_put')}, feed.device_put "
        f"{s['faults_fired'].get('feed.device_put')}; lost {s['lost']}, "
        f"duplicated {s['duplicated']}")
    if not (s["h2d_shard_degraded"] and s["h2d_delivered"] == 6
            and s["faults_fired"].get("feed.shard_put") == 3):
        fail(f"phase 20 (b): the h2d leg did not degrade as scripted: {s}")
    T.reset_counters("feed.")  # the injected degrade ends here


def meshed_featurizer_path(K, table, repo, n_chunks, card) -> dict:
    """Phase 20 (c); returns {kernel: launches} of the counted run."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.io.feed import host_local_feed
    from mmlspark_tpu_torch.models import torch_model as TM
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.zoo import get_or_create_resnet
    from mmlspark_tpu_torch.parallel.mesh import default_mesh

    feed = host_local_feed(device="cuda")
    mesh = default_mesh("cuda")
    if feed.mesh is not mesh or feed._dp() != 1 or \
            TM._data_mesh(torch.device("cuda")) is not mesh:
        fail("host_local_feed and the meshed TorchModel see different meshes")
    bundle = get_or_create_resnet("resnet50", (IMG, IMG, 3), 1000, repo=repo)
    featurizer = ImageFeaturizer(bundle=bundle, batch_size=BATCH)
    single = TM._data_mesh

    def run(meshed: bool):
        if not meshed:
            TM._data_mesh = lambda device: None  # the single-device path
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = featurizer.transform(table)
            return time.perf_counter() - t0, out["features"]
        finally:
            TM._data_mesh = single

    zero_launches()
    _w, meshed_feats = run(True)
    launches = read_launches()
    _w, single_feats = run(False)
    plain_model = featurizer._model_for(bundle, "image")
    plain_model.set(preprocess=plain_preprocess(K))
    plain_feats = plain_model.transform(table)["features"]
    same = np.array_equal(meshed_feats, single_feats)
    diff = float(np.abs(meshed_feats - single_feats).max())
    err = rel_l2(meshed_feats, plain_feats)
    walls = {True: [], False: []}
    for _ in range(P20_TURNS):
        for meshed in (True, False):
            walls[meshed].append(run(meshed)[0])
    log(f"[phase 20] (c) ImageFeaturizer(ResNet-50, bf16, {IMG}x{IMG}) in "
        f"the world-1 group (host_local_feed's mesh = the meshed "
        f"TorchModel's): launches {launches} (chunks={n_chunks}); features "
        f"vs the same rows outside a group: bit for bit {same}, max abs "
        f"diff {diff:.3g}; vs the plain-preprocess run rel_l2 {err:.3e} "
        f"(bound {PLAIN_FEATURES_RTOL}); images/s in {P20_TURNS} turns: "
        f"meshed {N_IMAGES / _median(walls[True]):.0f} (median; "
        f"{', '.join(f'{N_IMAGES / w:.0f}' for w in walls[True])}), "
        f"single-device {N_IMAGES / _median(walls[False]):.0f} "
        f"({', '.join(f'{N_IMAGES / w:.0f}' for w in walls[False])}) on "
        f"{card}")
    if launches != dict(NO_LAUNCHES, affine_resample=n_chunks):
        fail(f"phase 20 (c) launched {launches}, expected B1 once a chunk")
    if err > PLAIN_FEATURES_RTOL or rel_l2(meshed_feats, single_feats) > \
            PLAIN_FEATURES_RTOL:
        fail("phase 20 (c): the meshed features disagree")
    _no_degrade("(c)")
    del featurizer, plain_model
    return launches


def gbdt_mesh_path(mesh, serial, sparse, card) -> None:
    """Phase 20 (d): phase 15's fits on the world-1 mesh."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt import histogram as H
    from mmlspark_tpu_torch.gbdt import tree as T
    from mmlspark_tpu_torch.gbdt.estimators import _features_matrix
    from mmlspark_tpu_torch.models.statistics import roc_auc

    import torch.distributed as dist

    C = gbdt_compare()
    serial_booster, serial_calls = serial
    # the data group's first collective sets up its NCCL communicator:
    # timed apart, so the fits' all-reduces are the steady state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, device="cuda"),
                    group=mesh.get_group("data"))
    torch.cuda.synchronize()
    log(f"[phase 20] (d) the data group's first all-reduce (its NCCL "
        f"communicator's setup): {(time.perf_counter() - t0) * 1e3:.1f} ms")
    x, y = higgs_like(GBDT_ROWS, seed=15)
    xh, yh = higgs_like(GBDT_HOLD, seed=16)
    reduces = []
    orig_reduce = H.RowShardedBuilderBase._all_reduce

    def timed_reduce(self, t):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig_reduce(self, t)
        ev[1].record()
        reduces.append(ev)
        return out

    def fit(par, xx, yy, **kw):
        est = GBDTClassifier(num_iterations=GBDT_ITERS, parallelism=par,
                             **kw)
        cfg = est._base_config(objective="binary", num_class=1,
                               scale_pos_weight=est.scale_pos_weight)
        clock = iter_clock()
        reduces.clear()
        H.RowShardedBuilderBase._all_reduce = timed_reduce
        try:
            t0 = time.perf_counter()
            est.set(delegate=clock)
            b = est._train_booster(cfg, xx, yy, None, None, mesh=mesh)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        finally:
            H.RowShardedBuilderBase._all_reduce = orig_reduce
        red_ms = sum(s.elapsed_time(e) for s, e in reduces)
        return b, fit_s, clock.ms(), red_ms, len(reduces)

    b, fit_s, iter_ms, red_ms, n_red = fit("data_parallel", x, y)
    same, exact = same_forest(serial_booster.trees, b.trees)
    ties = []
    if not same:
        with C.following_splits(T, serial_calls, "phase 20 data_parallel") \
                as (_calls, ties):
            again = fit("data_parallel", x, y)[0]
        C.compare_fits(serial_booster, again, "phase 20 data_parallel")
    med = float(np.median(iter_ms[1:]))
    log(f"[phase 20] (d) GBDTClassifier data_parallel on the world-1 mesh, "
        f"{GBDT_ROWS:,} x {GBDT_FEATURES} x {GBDT_ITERS} iterations: fit "
        f"{fit_s:.2f} s, ms an iteration {med:.1f} (median after the "
        f"first); {n_red} all-reduces of the f64 histograms, "
        f"{red_ms:.1f} ms in all = {red_ms / (sum(iter_ms) or 1):.4f} of "
        f"the iterations' time; trees vs phase 15's serial card fit: "
        f"structure equal {same}, leaf values bit for bit {exact}"
        + (f"; by the tie rule after {len(ties)} tie(s)" if not same else "")
        + f" on {card}")

    masks = []
    orig_vote = T.vote_features

    def recorded_vote(*a, **k):
        m = orig_vote(*a, **k)
        masks.append(m)
        return m

    T.vote_features = recorded_vote
    try:
        vb, vfit_s, viter_ms, vred_ms, vn = fit("voting_parallel", x, y,
                                                top_k=P20_TOP_K)
    finally:
        T.vote_features = orig_vote
    inside = all(set(int(f) for f in t.split_feature if f >= 0)
                 <= set(np.nonzero(m)[0].tolist())
                 for t, m in zip(vb.trees, masks))
    auc_vote = roc_auc(yh, vb._raw_scores(xh))
    auc_serial = roc_auc(yh, serial_booster._raw_scores(xh))
    log(f"[phase 20] (d) voting_parallel (top_k {P20_TOP_K} of "
        f"{GBDT_FEATURES}): fit {vfit_s:.2f} s, ms an iteration "
        f"{float(np.median(viter_ms[1:])):.1f}; all-reduces {vn}, "
        f"{vred_ms:.1f} ms; {len(masks)} votes (one a tree), features a "
        f"vote {[int(m.sum()) for m in masks]}; every split inside its "
        f"tree's vote: {inside}; held-out AUC {auc_vote:.6f} against the "
        f"serial fit's {auc_serial:.6f}")
    if len(masks) != GBDT_ITERS or not inside or \
            auc_vote < auc_serial - P20_AUC_DROP:
        fail("phase 20 (d): voting_parallel misbehaved")

    sparse_booster, sparse_table = sparse
    xs = _features_matrix(sparse_table["features"],
                          sparse_table.get_meta("features"))
    ys = np.asarray(sparse_table["label"], np.float64)
    est = GBDTClassifier(num_iterations=GBDT_TEXT_ITERS, num_leaves=7,
                         min_data_in_leaf=10, parallelism="data_parallel")
    cfg = est._base_config(objective="binary", num_class=1,
                           scale_pos_weight=est.scale_pos_weight)
    t0 = time.perf_counter()
    sb = est._train_booster(cfg, xs, ys, None, None, mesh=mesh)
    torch.cuda.synchronize()
    sfit_s = time.perf_counter() - t0
    ssame, sexact = same_forest(sparse_booster.trees, sb.trees)
    log(f"[phase 20] (d) example 02's reviews ({len(ys):,} rows, 2^18 "
        f"hashed features, CSR) data_parallel on the world-1 mesh: fit "
        f"{sfit_s:.2f} s; trees vs phase 15 (b)'s: structure equal "
        f"{ssame}, leaf values bit for bit {sexact}")
    if not ssame:
        C.compare_fits(sparse_booster, sb, "phase 20 sparse data_parallel")
    _no_degrade("(d)")


def vw_all_reduce_path(card) -> dict:
    """Phase 20 (e); returns {kernel: launches} of the all-reduce fit."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.online import VowpalWabbitClassifier
    from mmlspark_tpu_torch.online import learners as L

    rng = np.random.default_rng(20)
    cols = vw_columns(rng, VW_ROWS)
    idx, val, nnz = vw_hashed_rows(cols)
    table = Table({"features": object_rows(idx, val, nnz),
                   "label": cols["label"]})
    kw = dict(num_passes=VW_PASSES, learning_rate=0.5, num_bits=VW_BITS)
    plain = VowpalWabbitClassifier(**kw).fit(table)
    ends = []
    orig = L._end_of_pass

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(*a)
        torch.cuda.synchronize()
        ends.append((time.perf_counter() - t0) * 1e3)

    L._end_of_pass = timed
    zero_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduced = VowpalWabbitClassifier(use_all_reduce=True, **kw).fit(table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        L._end_of_pass = orig
    launches = read_launches()
    wp, wr = np.asarray(plain.weights), np.asarray(reduced.weights)
    bitwise = np.array_equal(wp, wr)
    err = float(np.abs(wp - wr).max()) / max(float(np.abs(wp).max()), 1e-30)
    shards = list(reduced.performance_statistics["num_shards"])
    log(f"[phase 20] (e) VowpalWabbitClassifier(use_all_reduce=True) on "
        f"{VW_ROWS:,} rows x {VW_PASSES} passes in the world-1 group: fit "
        f"{fit_s:.3f} s; launches {launches}; weights vs use_all_reduce="
        f"False bit for bit {bitwise} ({err:.3g} of max |w|, limit "
        f"{K1_W_RTOL}); num_shards {shards}; the end-of-pass all-reduce "
        f"of w and g2 (2^{VW_BITS} f32 each) and the loss "
        f"{', '.join(f'{m:.3f}' for m in ends)} ms a pass on {card}")
    if launches != dict(NO_LAUNCHES, online_pass=VW_PASSES):
        fail(f"phase 20 (e) launched {launches}, expected K1 once a pass")
    if err > K1_W_RTOL or shards != [1] * VW_PASSES or len(ends) != VW_PASSES:
        fail("phase 20 (e): use_all_reduce disagrees with the serial fit")
    _no_degrade("(e)")
    return launches


def int8_gemm_timing(card) -> None:
    """`torch._int_mm` at the ViT-B/16 qkv shape of one chunk against a
    bf16 `torch.matmul` at the same shape, each from calls queued behind
    a spin (the device alone)."""
    import torch

    m, k, n = INT8_GEMM_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
    if not torch.equal(torch._int_mm(a, w.t()).float(),
                       (a.float() @ w.float().t())):
        fail("torch._int_mm disagrees with the f32 product of its inputs")
    int8_ms = queued_ms(lambda: torch._int_mm(a, w.t()))
    bf16_ms = queued_ms(lambda: torch.matmul(ab, wb.t()))
    ops = 2.0 * m * k * n
    log(f"[int8-gemm] ({m} x {k}) @ ({k} x {n}): torch._int_mm "
        f"{int8_ms:.4f} ms ({ops / int8_ms / 1e9:.1f} TOPS), bf16 "
        f"torch.matmul {bf16_ms:.4f} ms ({ops / bf16_ms / 1e9:.1f} TFLOP/s)"
        f"; int8 / bf16 time {int8_ms / bf16_ms:.3f} on {card}")


def ptxas_entries(report: str):
    """[(entry, registers, spill store bytes, spill load bytes)] from an
    `nvcc -Xptxas -v` report."""
    out, entry, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1))) + spills)
            entry, spills = None, (0, 0)
    return out


def hopper_report(_build, A) -> None:
    """Registers, spills and shared memory of the TMA/wgmma kernels (B4, B5
    and B6 on the bf16, D <= 128 route); fails on a spill."""
    import ctypes

    smem = {}  # kernel name -> {64: bytes, 128: bytes}
    for lib_name, kernel, fn in (
            ("flash_attention_fwd", "flash_fwd_hopper_kernel",
             "mmk_flash_attention_fwd_hopper_smem"),
            ("flash_attention_bwd", "flash_bwd_dkdv_hopper_kernel",
             "mmk_flash_attention_bwd_dkdv_hopper_smem"),
            ("flash_attention_bwd", "flash_bwd_dq_hopper_kernel",
             "mmk_flash_attention_bwd_dq_hopper_smem")):
        f = getattr(_build.library(lib_name), fn)
        f.argtypes, f.restype = [ctypes.c_int], ctypes.c_int
        smem[kernel] = {64: f(64), 128: f(128)}
    seen = set()
    for lib_name in ("flash_attention_fwd", "flash_attention_bwd"):
        for entry, regs, st, ld in ptxas_entries(
                _build.ptxas_report(lib_name)):
            kernel = next((k for k in smem if k in entry), None)
            if kernel is None:
                continue
            dp = 64 if "ILi64E" in entry else 128
            seen.add((kernel, dp))
            log(f"[build] {lib_name} Hopper kernel {entry}: {regs} registers "
                f"a thread at launch (setmaxnreg: consumer warpgroup 216, "
                f"producer warpgroup 40), spill stores {st} B, spill loads "
                f"{ld} B, dynamic shared memory {smem[kernel][dp]} B a "
                f"block (D <= {dp}), two blocks an SM")
            if st or ld:
                fail(f"{entry} spills registers ({st} B stores, {ld} B loads)")
    if len(seen) != 2 * len(smem):
        fail(f"the ptxas reports lack Hopper kernels: saw {sorted(seen)}")


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs numpy and torch: {e}")
    if not os.path.isdir(os.path.join(ROOT, "mmlspark_tpu_torch")):
        fail("run from a checkout: mmlspark_tpu_torch/ is not beside chip_smoke.py")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, ROOT)
    from mmlspark_tpu_torch import Table
    from mmlspark_tpu_torch.models.zoo import ModelRepo
    from mmlspark_tpu_torch.ops import _build
    from mmlspark_tpu_torch.ops import attention_kernels as A
    from mmlspark_tpu_torch.ops import image_kernels as K
    from mmlspark_tpu_torch.ops import paged_attention as PA
    from mmlspark_tpu_torch.ops import wire_codec as W

    # ---- 1. device -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()} ({card}); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ------------------------------------------------------
    # the decoder library (nvJPEG with the C2 kernel) builds beside the
    # kernels of csrc/, all at once
    import threading
    from mmlspark_tpu_torch import native

    decoder = {}

    def build_decoder():
        t = time.perf_counter()
        try:
            decoder["ok"] = native.jpeg_available()
        except native.DecoderError as e:
            decoder["error"] = str(e)
        decoder["s"] = time.perf_counter() - t

    builder = threading.Thread(target=build_decoder)
    t0 = time.perf_counter()
    builder.start()
    secs = _build.build()
    builder.join()
    log(f"[build] {len(secs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s: {secs}; the JPEG decoder "
        f"({native.jpeg_backend()}) in {decoder['s']:.2f} s")
    if not decoder.get("ok") or native.jpeg_backend() != "nvjpeg":
        fail(f"the nvJPEG decoder with the C2 kernel did not build: "
             f"{decoder.get('error') or native.build_error()}")
    for entry, regs, st, ld in ptxas_entries(native.build_log()):
        log(f"[build] native jpeg_ycc.cu {entry}: {regs} registers, spill "
            f"stores {st} B, loads {ld} B")
        if st or ld:
            fail(f"{entry} spills registers")
    for name in secs:
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    hopper_report(_build, A)
    # the kernels redesigned last (B8's split instantiations, B1's tile
    # route) ship without spills, as the Hopper kernels do
    for name in ("paged_attention", "resize_normalize"):
        entries = ptxas_entries(_build.ptxas_report(name))
        spilled = [e for e in entries if e[2] or e[3]]
        log(f"[build] {name}: {len(entries)} kernels, registers "
            f"{min(e[1] for e in entries)}..{max(e[1] for e in entries)}, "
            f"{len(spilled)} with spills")
        if spilled:
            fail(f"{name} spills registers: {spilled}")

    # ---- 3. kernel check -----------------------------------------------
    main_shapes = [(BATCH, h, w, 3) for h, w in SIZES]
    checks = [check_resample(K, s, "uint8", seed=i)
              for i, s in enumerate(main_shapes)]
    extra = [check_resample(K, (7, 333, 517, 3), "uint8", seed=7),
             check_resample(K, (5, 97, 131, 1), "float32", seed=8),
             # DeepVisionClassifier (phase 8c): a fit step's batch and a
             # scoring chunk, 32x32 uint8 kept at 32x32
             check_resample(K, (DV_BATCH, 32, 32, 3), "uint8", seed=9,
                            out_hw=(32, 32)),
             check_resample(K, (64, 32, 32, 3), "uint8", seed=17,
                            out_hw=(32, 32))] + [
        # ragged store edges (a row of 7 x 31 x 4 and of 7 x 31 x 3
        # values), the pixel route by the rule (a large uint8 downscale, a
        # wide f32 input), and two composed chains: phase 10's (resize,
        # center crop, blur, flip) and a crop with both flips
        check_resample(K, shape, dtype, seed=40 + i, out_hw=hw, timed=False)
        for i, (shape, dtype, hw) in enumerate([
            ((2, 19, 23, 4), "uint8", (7, 31)),
            ((3, 19, 23, 3), "float32", (7, 31)),
            ((2, 1500, 2000, 3), "uint8", (IMG, IMG)),
            ((2, 600, 1600, 3), "float32", (IMG, IMG))])] + [
        check_resample(K, (16, h, w, 3), "uint8", seed=50 + i, timed=False,
                       plan=K.affine_plan(K.freeze_stages(chain), h, w, 3))
        for i, (h, w, chain) in enumerate([
            (320, 240, [("resize", {"height": 256, "width": 256}),
                        ("centerCrop", {"height": IMG, "width": IMG}),
                        ("blur", {"height": 2.0, "width": 2.0}),
                        ("flip", {})]),
            (333, 517, [("crop", {"x": 40, "y": 21, "height": 300,
                                  "width": 400}),
                        ("resize", {"height": IMG, "width": IMG}),
                        ("flip", {"flipLeftRight": True,
                                  "flipUpDown": True})])])]
    # B4 at the ViT-B/16 chunk and the LM prefill (the main paths'
    # shapes), then a ragged causal f32 and a D = 32 shape
    attn_main = [
        check_attention(A, (BATCH, 196, 12, 64), "bfloat16", False, seed=10),
        check_attention(A, (LM_BATCH, LM_PROMPT, 12, 64), "bfloat16", True,
                        seed=11)]
    attn_extra = [
        check_attention(A, (3, 77, 5, 64), "float32", True, seed=12),
        check_attention(A, (8, 128, 4, 32), "bfloat16", True, seed=13),
        # the batcher's admission prefills: kp rows at a power-of-two bucket
        check_attention(A, (SERVE_SLOTS, 1024, 12, 64), "bfloat16", True,
                        seed=14),
        check_attention(A, (1, 16, 12, 64), "bfloat16", True, seed=15),
        # the LM train forward (phase 8a)
        check_attention(A, (TRAIN_BATCH, TRAIN_SEQ, 12, 64), "bfloat16",
                        True, seed=16)]
    # B7/B8 at the serving shape and beside it (their times are taken on
    # the serving run's live pools, phase 7b)
    paged_err = paged_kernel_checks(PA)
    # B5/B6 at the LM train layer (timed), a ViT-B/16 chunk, a ragged f32,
    # a D 32 and a D 128 shape
    bwd_main = check_attention_bwd(A, (TRAIN_BATCH, TRAIN_SEQ, 12, 64),
                                   "bfloat16", True, seed=20, timed=True)
    bwd_extra = [
        check_attention_bwd(A, (BATCH, 196, 12, 64), "bfloat16", False,
                            seed=21),
        check_attention_bwd(A, (3, 77, 5, 64), "float32", True, seed=22),
        check_attention_bwd(A, (2, 128, 4, 32), "float32", False, seed=23),
        check_attention_bwd(A, (4, 256, 4, 128), "bfloat16", True, seed=24),
        # phase 13 (d)'s student layer
        check_attention_bwd(A, (DISTILL_BATCH, TRAIN_SEQ, 12, 64), "bfloat16",
                            True, seed=25)]

    # ---- 4-6. the paths (4b: JPEG bytes) ----------------------------------
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(*SIZES[i % 3], 3), dtype=np.uint8)
              for i in range(N_IMAGES)]
    table = Table({"image": images, "id": np.arange(N_IMAGES)})
    repo = ModelRepo(os.path.join(ROOT, "build", "model_repo"))
    n_chunks = sum(math.ceil(N_IMAGES / len(SIZES) / BATCH) for _ in SIZES)
    paths = [resnet_path(K, A, images, table, repo, n_chunks, card),
             jpeg_path(repo, n_chunks, card),
             vit_path(K, A, images, table, repo, n_chunks, card),
             lm_path(K, A, card)]

    # ---- 7. decode serving -----------------------------------------------
    exact_requests = serve_exactness(card)
    serve_launches, live, serve_flash_err = serving_path(A, PA, card)
    paths.append(serve_launches)

    # ---- 8. training -----------------------------------------------------
    paths += [lm_train_path(card), cifar_train_path(card),
              deep_vision_path(card)]

    # ---- 10. image stages and compressed wire ----------------------------
    stage_launches, unroll_path_err = image_stage_path(K, images, table,
                                                       repo, card)
    unroll_checks = [
        check_unroll(K, (N_IMAGES, IMG, IMG, 3), MEAN_BGR, STD_BGR, seed=30,
                     timed=True),
        check_unroll(K, (5, 37, 53, 1), (0.25,), (3.0,), seed=31),
        check_unroll(K, (3, 24, 24, 3), (120.0,), (64.0,), seed=32)]
    wire_launches, bench_chunk = compressed_wire_path(W, card)
    rle_main = check_rle(W, "feed_bench", bench_chunk, timed=True)
    rle_extra = [check_rle(W, name, arr, timed=name == "uniform_64x224x224x3")
                 for name, arr in rle_cases(images).items()]
    paths += [stage_launches, wire_launches]

    # ---- 11. resumable training and C2 ---------------------------------
    # both resume checks compare runs bit for bit: cuDNN's deterministic
    # algorithms from here on (cuBLAS's workspace is set at the top)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    paths.append(resumable_train_path(card))
    dv_launches, dv_model, dv_table = deep_vision_resume_path(card)
    paths.append(dv_launches)
    from mmlspark_tpu_torch import native

    ycc = check_ycc(native, jpeg_fixtures()[0])

    # ---- 12. persistence and int8 weights --------------------------------
    paths += [persistence_path(table, repo, n_chunks, dv_model, dv_table,
                               card),
              int8_vit_path(images, table, repo, n_chunks, card),
              int8_lm_path(card)]
    int8_gemm_timing(card)

    # ---- 13. MoE, beam search, speculative decoding, distillation --------
    t13 = time.perf_counter()
    moe_launches, moe_bundle = moe_train_path(card)
    paths += [moe_launches, moe_decode_path(moe_bundle, card),
              beam_path(card), speculative_path(exact_requests, card),
              distill_path(card)]
    del moe_bundle
    log(f"[phase 13] {time.perf_counter() - t13:.1f} s")

    # ---- 14. the fleet ---------------------------------------------------
    t14 = time.perf_counter()
    paths.append(fleet_exactness(exact_requests, card))
    paths += fleet_lm_path(card)
    paths.append(fleet_featurizer_path(repo, card))
    log(f"[phase 14] {time.perf_counter() - t14:.1f} s")

    # ---- 15. the GBDT engine ---------------------------------------------
    t15 = time.perf_counter()
    gbdt_serial = gbdt_dense_path(card)
    gbdt_sparse = gbdt_sparse_path(card)
    log(f"[phase 15] {time.perf_counter() - t15:.1f} s")

    # ---- 16. the classic-ML slice ----------------------------------------
    t16 = time.perf_counter()
    zero_launches()
    host_library_path()
    adult_model, adult_test = adult_path(card)
    flights_path(card)
    review_model = reviews_path(card)
    classic = read_launches()
    log(f"[phase 16] kernel launches (no kernel is on this path): "
        f"{classic}")
    paths.append(classic)
    log(f"[phase 16] {time.perf_counter() - t16:.1f} s")

    # ---- 17. the rest of classic ML --------------------------------------
    t17 = time.perf_counter()
    paths += [vgg_path(card), tagger_path(card), word2vec_path(card)]
    vw_launches, k1 = vw_path(card)
    paths += [vw_launches, knn_path(card), sar_path(card),
              iforest_path(card), automl_path(card)]
    log(f"[phase 17] {time.perf_counter() - t17:.1f} s")

    # ---- 18. the explainers, CyberML and the service layer ---------------
    t18 = time.perf_counter()
    paths.append(image_explainer_path(card))
    zero_launches()
    tabular_explainer_path(adult_model, adult_test, card)
    text_explainer_path(review_model, card)
    access_anomaly_path(card)
    service_layer_path()
    rest = read_launches()
    if rest != NO_LAUNCHES:
        fail(f"phase 18 (b)-(e) launched {rest}: no kernel is on their path")
    paths.append(rest)
    del adult_model, adult_test, review_model
    log(f"[phase 18] {time.perf_counter() - t18:.1f} s")

    # ---- 19. device telemetry and the model side of distributed ----------
    t19 = time.perf_counter()
    import torch.distributed as dist
    from mmlspark_tpu_torch.parallel import distributed as D
    from mmlspark_tpu_torch.utils.cluster import find_open_port

    paths.append(telemetry_path(images, table, repo, n_chunks, card))
    t0 = time.perf_counter()
    D.initialize_distributed(f"127.0.0.1:{find_open_port(29500)}", 1, 0,
                             device=P19_DEVICE)
    rendezvous_s = time.perf_counter() - t0
    paths += [ring_blocks_path(card), ulysses_path(card)]
    launches3d, state3d, step3d, toks3d = trainer3d_path(card)
    paths.append(launches3d)
    checkpoint3d_path(state3d, step3d, toks3d, card)
    del state3d, step3d, toks3d
    elastic_path(rendezvous_s, card)
    dist.destroy_process_group()
    log(f"[phase 19] {time.perf_counter() - t19:.1f} s")

    # ---- 20. the data side of distributed --------------------------------
    # bit-for-bit checks below rely on cuDNN's deterministic algorithms
    # (phase 11 on) and cuBLAS's fixed workspace (the script's top)
    t20 = time.perf_counter()
    from mmlspark_tpu_torch.core import telemetry as core_telemetry
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    core_telemetry.reset_counters("feed.")
    paths.append(feed_coalesce_path(table, repo, n_chunks, card))
    D.reset_distributed_state()
    D.initialize_distributed(f"127.0.0.1:{find_open_port(29700)}", 1, 0,
                             device="cuda")
    mesh20 = make_mesh(device="cuda")
    shard_engine_path(mesh20, card)
    paths.append(meshed_featurizer_path(K, table, repo, n_chunks, card))
    gbdt_mesh_path(mesh20, gbdt_serial, gbdt_sparse, card)
    del gbdt_serial, gbdt_sparse
    paths.append(vw_all_reduce_path(card))
    dist.destroy_process_group()
    log(f"[phase 20] {time.perf_counter() - t20:.1f} s")
    launches = {k: sum(p[k] for p in paths) for k in KERNELS}

    # ---- 9. record -----------------------------------------------------
    def summed(rows, key):
        vals = [r[key] for r in rows]
        return sum(vals) if None not in vals else None

    def bound_by(rows):
        return ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                else "operations")

    kernels = [{
        "name": "affine_resample",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/resize_normalize.cu",
        "replaces": "mmlspark_tpu/ops/pallas_kernels.py:164",
        "launches": launches["affine_resample"],
        "max_abs_err": max(c["err"] for c in checks + extra),
        # one chunk of each of the main path's three chunk shapes, summed
        "ms": summed(checks, "ms"),
        "plain_ms": summed(checks, "plain_ms"),
        "bound_ms": summed(checks, "bound_ms"),
        "bound_by": bound_by(checks),
        "library_ms": summed(checks, "library_ms"),
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mmlspark_tpu/ops/attention_kernels.py:196",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max([c["err"] for c in attn_main + attn_extra]
                           + [serve_flash_err]),
        # one ViT-B/16 chunk layer plus one LM prefill layer, summed;
        # the kernel's time queued behind a spin (the device alone)
        "ms": summed(attn_main, "ms"),
        "plain_ms": summed(attn_main, "plain_ms"),
        "bound_ms": summed(attn_main, "bound_ms"),
        "bound_by": bound_by(attn_main),
        "library_ms": summed(attn_main, "library_ms"),
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/paged_attention.cu",
        "replaces": f"mmlspark_tpu/ops/paged_attention.py:{line}",
        "launches": launches[name],
        "max_abs_err": max(paged_err[name], live[name]["err"]),
        # one launch on the serving run's live pools (tick 40, layer 0)
        "ms": live[name]["ms"],
        "plain_ms": live[name]["plain_ms"],
        "bound_ms": live[name]["bound_ms"],
        "bound_by": live[name]["bound_by"],
        "library_ms": live[name]["library_ms"],
    } for name, line in (("paged_decode_attention", 167),
                         ("paged_decode_attention_int8", 250))] + [{
        "name": f"flash_attention_bwd_{which}",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": f"mmlspark_tpu/ops/attention_kernels.py:{line}",
        "launches": launches[f"flash_attention_bwd_{which}"],
        "max_abs_err": max(r[which]["err"] for r in [bwd_main] + bwd_extra),
        # one launch at the LM train layer (16, 1024, 12, 64) bf16 causal;
        # library_ms: SDPA's whole backward (dQ, dK and dV together)
        "ms": bwd_main[which]["ms"],
        "plain_ms": bwd_main[which]["plain_ms"],
        "bound_ms": bwd_main[which]["bound_ms"],
        "bound_by": bwd_main[which]["bound_by"],
        "library_ms": bwd_main[which]["library_ms"],
    } for which, line in (("dkdv", 278), ("dq", 348))] + [{
        "name": "fused_normalize_unroll",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/normalize_unroll.cu",
        "replaces": "mmlspark_tpu/ops/pallas_kernels.py:56",
        "launches": launches["fused_normalize_unroll"],
        "max_abs_err": max([c["err"] for c in unroll_checks]
                           + [unroll_path_err]),
        # one launch at the image-stage path's (192, 224, 224, 3) f32
        # group; library_ms: torch.sub over the permuted view + mul_
        "ms": unroll_checks[0]["ms"],
        "plain_ms": unroll_checks[0]["plain_ms"],
        "bound_ms": unroll_checks[0]["bound_ms"],
        "bound_by": unroll_checks[0]["bound_by"],
        "library_ms": unroll_checks[0]["library_ms"],
    }, {
        "name": "rle_decode",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/rle_decode.cu",
        "replaces": "mmlspark_tpu/ops/wire_codec.py:231",
        "launches": launches["rle_decode"],
        "max_abs_err": max(r["err"] for r in [rle_main] + rle_extra),
        # one launch at a feed_bench chunk (16x224x224x3 uint8);
        # library_ms: torch.repeat_interleave(values, counts, output_size)
        "ms": rle_main["ms"],
        "plain_ms": rle_main["plain_ms"],
        "bound_ms": rle_main["bound_ms"],
        "bound_by": rle_main["bound_by"],
        "library_ms": rle_main["library_ms"],
    }, {
        "name": "ycc_to_bgr",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/native/src/jpeg_ycc.cu",
        # no pallas_call: the JAX package's host libjpeg decode, whose
        # upsampling and colour conversion this kernel computes
        "replaces": "mmlspark_tpu/native/src/native.cpp:248",
        "launches": launches["ycc_to_bgr"],
        "max_abs_err": ycc["err"],
        # one image of each of the JPEG path's three sizes, summed; no
        # PyTorch call computes libjpeg's upsampling and conversion
        "ms": ycc["ms"],
        "plain_ms": ycc["plain_ms"],
        "bound_ms": ycc["bound_ms"],
        "bound_by": ycc["bound_by"],
        "library_ms": ycc["library_ms"],
    }, {
        "name": "online_pass",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/online_pass.cu",
        # no pallas_call: the JAX package's lax.scan of per-example
        # AdaGrad updates (and contextual_bandit.py:44's, which it serves
        # too)
        "replaces": "mmlspark_tpu/online/learners.py:36",
        "launches": launches["online_pass"],
        "max_abs_err": k1["err"],
        # one pass over example 20's first 20,000 rows; the plain loop on
        # the card by the host clock; no PyTorch call computes the pass
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
